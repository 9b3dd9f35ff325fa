"""One front door for the port's static verification.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu              # all five passes
    PYTHONPATH=src python -m repro_torch.analysis --passes ast,async        # source only
    PYTHONPATH=src python -m repro_torch.analysis --passes hlo,contracts,costs   # on the card
    PYTHONPATH=src python -m repro_torch.analysis --root src/repro_torch --root chip_smoke.py

Runs JAX's five passes (recorded-trace invariants, repo-rule AST lint,
shape contracts, cost-model gates, async race lint), prints every finding,
writes the report (``ANALYSIS_TORCH.json`` unless ``--out`` says
otherwise; never the JAX lane's ``ANALYSIS.json``) and exits 0 when clean,
1 on findings, 2 on an unknown pass, a refused report path or a
``--device`` this machine does not have.

The program passes (``hlo``, ``contracts``, ``costs``) run on ``--device``
(``cuda`` unless told otherwise, like every entry point of the port; the
CPU runs the kernels' plain versions). The mesh lane's probes of ``hlo``
and ``costs`` share one spawn of gloo ranks (``meshprobe``). The source
passes (``ast``, ``async``) are pure ``ast``: no device, no torch, and the
checked code is never imported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

DEFAULT_OUT = "ANALYSIS_TORCH.json"
JAX_REPORT = "ANALYSIS.json"  # the JAX lane's report (python -m repro.analysis)
PROGRAM_PASSES = ("hlo", "contracts", "costs")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static verification: recorded-trace invariants, "
        "repo-rule AST lint, shape contracts, cost-model gates, async race lint.",
    )
    ap.add_argument("--passes", default="hlo,ast,contracts,costs,async",
                    help="comma-separated subset of hlo,ast,contracts,costs,async "
                    "(default: all)")
    ap.add_argument("--grid", type=int, default=4,
                    help="probe grid side (the mesh probe spawns grid^2 ranks)")
    ap.add_argument("--m", type=int, default=8, help="inducing points per partition")
    ap.add_argument("--q-max", type=int, default=64, help="probe block size")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the program passes run (default: cuda)")
    ap.add_argument("--root", action="append", default=None,
                    help="a source directory or file for the source passes; repeat "
                    "for more (default: src/repro_torch)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"JSON report path ('' to skip writing; default {DEFAULT_OUT})")
    ap.add_argument("--baselines", default=None,
                    help="cost-baseline JSON path (default: "
                    "src/repro_torch/analysis/analysis_costs.json)")
    ap.add_argument("--update-baselines", action="store_true",
                    help="rewrite the cost baseline from this run instead of gating "
                    "drift against it (commit the result)")
    return ap


def _mesh_jobs(passes: tuple, args) -> list:
    """Every mesh probe the requested passes will need, for one spawn."""
    from repro_torch.analysis import costs, hlo
    from repro_torch.analysis import invariants as inv

    jobs = []
    if "hlo" in passes:
        jobs += [hlo.probe_job(lane.program_key, grid_side=args.grid, m=args.m,
                               q_max=args.q_max, n_queries=hlo.DEFAULT_N_QUERIES)
                 for lane in inv.LANES if lane.program == "mesh-blend"]
    if "costs" in passes:
        jobs += costs.mesh_jobs()
    return jobs


def main(argv=None) -> int:
    from repro_torch.analysis import PASSES

    args = build_parser().parse_args(argv)
    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = set(passes) - set(PASSES)
    if unknown:
        print(f"unknown passes {sorted(unknown)}; choose from {PASSES}")
        return 2
    if args.out and os.path.basename(args.out) == JAX_REPORT:
        print(f"refusing to write {args.out}: {JAX_REPORT} is the JAX lane's report "
              f"(python -m repro.analysis); use --out {DEFAULT_OUT} or another name")
        return 2
    roots = args.root or ["src/repro_torch"]
    if set(passes) & set(PROGRAM_PASSES) and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("the program passes run on --device cuda, and no CUDA device is "
                  "available; pass --device cpu (the kernels' plain versions)")
            return 2

    t0 = time.time()
    findings = []
    report = {"passes": {}, "device": args.device}
    if {"hlo", "costs"} & set(passes):
        from repro_torch.analysis import meshprobe

        # one spawn of ranks for every mesh probe of the run
        spawned = len(meshprobe.SPAWNS)
        meshprobe.results(_mesh_jobs(passes, args), args.device)
        report["mesh_probes"] = meshprobe.SPAWNS[spawned:]  # none if measured before
    if "hlo" in passes:
        from repro_torch.analysis import hlo

        fs, rep = hlo.run(grid_side=args.grid, m=args.m, q_max=args.q_max, device=args.device)
        findings.extend(fs)
        report["passes"]["hlo"] = rep
        print(f"[hlo]       {len(rep['lanes'])} lanes, "
              f"{len(rep['programs_recorded'])} programs recorded, "
              f"{len(fs)} finding(s) in {rep['seconds']}s")
    if "ast" in passes:
        from repro_torch.analysis import astlint

        fs, rep = astlint.run(roots)
        findings.extend(fs)
        report["passes"]["ast"] = rep
        print(f"[ast]       {rep['files_scanned']} files, {len(fs)} finding(s)")
    if "contracts" in passes:
        from repro_torch.analysis import contracts

        fs, rep = contracts.run(grid_side=args.grid, m=args.m)
        findings.extend(fs)
        report["passes"]["contracts"] = rep
        print(f"[contracts] {len(rep['targets_checked'])} targets, "
              f"{len(fs)} finding(s) in {rep['seconds']}s")
    if "costs" in passes:
        from repro_torch.analysis import costs

        kw = {"update_baselines": args.update_baselines, "device": args.device}
        if args.baselines is not None:
            kw["baseline_path"] = args.baselines
        fs, rep = costs.run(**kw)
        findings.extend(fs)
        report["passes"]["costs"] = rep
        print(f"[costs]     {len(rep['programs'])} programs measured at "
              f"{sum(len(r['points']) for r in rep['programs'].values())} "
              f"scale points, {len(fs)} finding(s) in {rep['seconds']}s"
              + (" (baselines updated)" if rep["baseline_updated"] else ""))
    if "async" in passes:
        from repro_torch.analysis import asynclint

        fs, rep = asynclint.run(roots)
        findings.extend(fs)
        report["passes"]["async"] = rep
        print(f"[async]     {rep['files_scanned']} files, {len(fs)} finding(s)")

    report["findings"] = [f.to_dict() for f in findings]
    report["findings_per_pass"] = {p: sum(f.pass_name == p for f in findings) for p in passes}
    report["total_findings"] = len(findings)
    report["seconds"] = round(time.time() - t0, 3)

    for f in findings:
        print(f"  {f}")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"report -> {args.out}")
    verdict = "CLEAN" if not findings else f"{len(findings)} VIOLATION(S)"
    print(f"analysis: {verdict} ({report['seconds']}s)")
    return 0 if not findings else 1


if __name__ == "__main__":
    sys.exit(main())
