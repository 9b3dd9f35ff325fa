"""The readings that set a cell's limits: the check's numbers for the
program on many seeds, for the control (the reference in TF32) on a few,
and for each planted fault on a few. Run on the card, at the cell's size:

    python3 bench/calibrate.py --workload psvgp_e3sm.ne30_fit --seeds 12 \\
        --control-seeds 3 --fault-seeds 3 --out calibrate.jsonl

One process per call: the kernels load once, each seed makes its own field
and set-up. Writes one JSON line per (cell, seed, side) with the numbers and
every leaf's norms; prints a summary per cell.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", action="append", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=1_000_003)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p or ".") != os.path.join(ROOT, "bench")]
    import importlib

    import torch

    from bench import compare, faults, harness

    torch.set_num_threads(1)
    device = torch.device(args.device)
    bench_dir = os.path.join(ROOT, "bench")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a", encoding="utf-8") as out:
        for cell in args.workload:
            found = harness.load_cell(ROOT, bench_dir, cell)
            cfg, mix, limits = found["cfg"], found["mix"], found["limits"]
            entry = harness.load_module(bench_dir, "entries", mix["entry"])
            ref = importlib.import_module(f"bench.reference.{cfg['reference']}")
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            summary: dict = {}
            for i in range(args.seeds):
                seed = args.first_seed + i
                t0 = time.perf_counter()
                run = entry.setup(cfg, mix, limits, seed, device)
                setup_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                reference = ref.follow(run.x, run.y, cfg, mix, *run.check_seeds, run.steps,
                                       device)
                ref_s = time.perf_counter() - t0
                sides = {"program": run.program}
                if i < args.control_seeds:
                    sides["control"] = ref.follow(run.x, run.y, cfg, mix, *run.check_seeds,
                                                  run.steps, device, precision="tf32")
                if i < args.fault_seeds:
                    for name, plant in faults.FAULTS.items():
                        with plant():
                            sides[name] = run.drive(*run.check_seeds)
                for side, tree in sides.items():
                    numbers = compare.numbers(tree, reference)
                    summary.setdefault(side, []).append(numbers)
                    line = {"cell": cell, "seed": seed, "side": side, "numbers": numbers,
                            "grad1_norms": compare.norms(tree["grad1"]),
                            "ref_grad1_norms": compare.norms(reference["grad1"]),
                            "setup_s": setup_s, "reference_s": ref_s}
                    out.write(json.dumps(line) + "\n")
                    out.flush()
                del run
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            for side, rows in summary.items():
                for k in rows[0]:
                    vals = [r[k] for r in rows]
                    print(f"{cell} {side} {k}: min {min(vals)!r} max {max(vals)!r} "
                          f"({len(vals)} seeds)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
