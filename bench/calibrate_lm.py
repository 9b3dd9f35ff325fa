"""The readings that set an LM training cell's limits: the check's numbers
for the program on many seeds, for the control (``faults_lm.CONTROL``: a
precision below the configuration's) on a few, and for each planted fault
(``faults_lm.FAULTS``) on a few. Run on the card, at the cell's size:

    python3 bench/calibrate_lm.py --workload deepseek_v2_lite_ep8.train_4k_zipf \\
        --seeds 12 --control-seeds 3 --fault-seeds 3 --out calibrate_lm.jsonl

A seed's reference runs first (what the check compares kept on the host),
then the program's set-up and the check's drive, then, on the first
seeds, the check's drive again from the same weights under the control
and under each fault; each side is compared with the one reference. One
JSON line per (cell, seed, side); a summary per number at the end, and
the limits that the benchmark's rule gives (:func:`limits_rule`).
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def limits_rule(summary: dict) -> dict:
    """{number: (limit, the side that sets its upper)}, by the rule that set
    the GP cells' limits:
    lower = the largest sound reading; upper = the least of the sides'
    minima that read 10x the lower (3x for the control); limit =
    lower^0.3 * upper^0.7, two digits. Where no side reads its factor, the
    least that reads 3x the lower sets the upper; where none does, the
    number is left out (None)."""
    out: dict = {}
    sound = summary.get("program", [])
    lowers = {k: max(r[k] for r in sound) for k in (sound[0] if sound else ())}
    least = {side: {k: min(r[k] for r in rows) for k in lowers}
             for side, rows in summary.items() if side != "program"}
    for k, lower in lowers.items():
        strict = [(v[k], side) for side, v in least.items()
                  if v[k] > 0 and v[k] >= (3.0 if side == "control" else 10.0) * lower]
        loose = [(v[k], side) for side, v in least.items() if v[k] > 0 and v[k] >= 3.0 * lower]
        if lower <= 0 or not (strict or loose):
            out[k] = (None, None)
            continue
        upper, side = min(strict or loose)
        out[k] = (float(f"{lower ** 0.3 * upper ** 0.7:.2g}"), side)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_019)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p or ".") != os.path.join(ROOT, "bench")]
    import importlib

    import torch

    from bench import faults_lm, harness

    torch.set_num_threads(1)
    device = torch.device(args.device)
    bench_dir = os.path.join(ROOT, "bench")
    found = harness.load_cell(ROOT, bench_dir, args.workload)
    cfg, mix, limits = found["cfg"], found["mix"], found["limits"]
    entry = harness.load_module(bench_dir, "entries", mix["entry"])
    ref = importlib.import_module(f"bench.reference.{cfg['reference']}")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    summary: dict = {}
    with open(args.out, "a", encoding="utf-8") as out:
        for i in range(args.seeds):
            seed = args.first_seed + i
            batches = [entry.batch(mix, cfg["vocab_size"], seed, k, device)
                       for k in range(int(limits["steps"]))]
            t0 = time.perf_counter()
            kept = []  # the reference's values, on the host

            def keep(kind, name, value, kept=kept):  # copies: the reference updates w in place
                def host(t):
                    return t.to("cpu", copy=True)

                kept.append((kind, name, {k: host(v) for k, v in value.items()}
                             if isinstance(value, dict) else host(value)))

            loss1 = entry.follow(ref, cfg, seed, batches, device, keep)
            ref_s = time.perf_counter() - t0
            if device.type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            run = entry.setup(cfg, mix, limits, seed, device)
            setup_s = time.perf_counter() - t0
            sides = [("program", None)]
            if i < args.control_seeds:
                sides += [("control", plant) for plant in faults_lm.CONTROL.values()]
            if i < args.fault_seeds:
                sides += list(faults_lm.FAULTS.items())
            for side, plant in sides:
                run.reset()
                with plant() if plant is not None else contextlib.nullcontext():
                    program = run.drive()
                gaps = entry.Gaps(program, device, ref)
                for kind, name, value in kept:
                    gaps.visit(kind, name, {k: v.to(device) for k, v in value.items()}
                               if isinstance(value, dict) else value.to(device))
                numbers = gaps.numbers(loss1)
                summary.setdefault(side, []).append(numbers)
                line = {"cell": args.workload, "seed": seed, "side": side, "numbers": numbers,
                        "setup_s": setup_s, "reference_s": ref_s,
                        "device": torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"}
                out.write(json.dumps(line) + "\n")
                out.flush()
                print(json.dumps(line), flush=True)
                del program, gaps  # what the side kept on the card
            run.release()
            del run, kept
            if device.type == "cuda":
                torch.cuda.empty_cache()
    for side, rows in summary.items():
        for k in rows[0]:
            vals = [r[k] for r in rows]
            print(f"{args.workload} {side} {k}: min {min(vals)!r} max {max(vals)!r} "
                  f"({len(vals)} seeds)", flush=True)
    for k, (limit, side) in limits_rule(summary).items():
        print(f"{args.workload} limit {k}: {limit!r} (upper from {side})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
