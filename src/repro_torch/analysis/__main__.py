"""One front door for the port's source passes.

    PYTHONPATH=src python -m repro_torch.analysis                       # both passes
    PYTHONPATH=src python -m repro_torch.analysis --passes ast          # one
    PYTHONPATH=src python -m repro_torch.analysis --root src/repro_torch --root chip_smoke.py

Runs the repo-rule AST lint and the async race lint over the given
roots (directories are walked, files taken as they are; default
``src/repro_torch``), prints every finding, writes the report
(``ANALYSIS_TORCH.json`` unless ``--out`` says otherwise; never the JAX
lane's ``ANALYSIS.json``) and exits 0 when clean, 1 on findings, 2 on an
unknown pass or a refused report path. Pure ``ast``: no GPU, no CUDA,
and the checked code is never imported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

DEFAULT_OUT = "ANALYSIS_TORCH.json"
JAX_REPORT = "ANALYSIS.json"  # the JAX lane's report (python -m repro.analysis)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static verification: repo-rule AST lint and "
        "async race lint.",
    )
    ap.add_argument("--passes", default="ast,async",
                    help="comma-separated subset of ast,async (default: both)")
    ap.add_argument("--root", action="append", default=None,
                    help="a source directory or file to check; repeat for more "
                    "(default: src/repro_torch)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"JSON report path ('' to skip writing; default {DEFAULT_OUT})")
    return ap


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

    t0 = time.time()
    findings = []
    report = {"passes": {}}
    if "ast" in passes:
        from repro_torch.analysis import astlint

        fs, rep = astlint.run(roots)
        findings.extend(fs)
        report["passes"]["ast"] = rep
        print(f"[ast]       {rep['files_scanned']} files, {len(fs)} finding(s)")
    if "async" in passes:
        from repro_torch.analysis import asynclint

        fs, rep = asynclint.run(roots)
        findings.extend(fs)
        report["passes"]["async"] = rep
        print(f"[async]     {rep['files_scanned']} files, {len(fs)} finding(s)")

    report["findings"] = [f.to_dict() for f in findings]
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
