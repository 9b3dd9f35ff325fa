"""Run one benchmark cell once on this machine's card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernels' build or load,
the inputs made from the seed, the program's set-up and the check's drive)
is timed as ``setup_s``; then the cell's entry runs units of work until
``--seconds`` have passed (the unit in flight finishes); then the plain
reference judges what the program produced. The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
also the last lines of standard error. Exits non-zero and prints no result
without a CUDA device, without the program's sources beside ``bench/``, or
if a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        log(f"bench: the program's sources are not beside bench/ ({ROOT}/src/repro_torch)")
        return 2
    # the script's own directory holds bench's modules, not top-level ones
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p or ".") != os.path.join(ROOT, "bench")]
    import torch

    from bench import harness

    found = harness.load_cell(ROOT, os.path.join(ROOT, "bench"), args.workload)
    if found is None:
        log(f"bench: no workload {args.workload!r} in BENCHMARK.json")
        return 2
    chips = found["spec"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"bench: {args.workload} needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(1)
    result = harness.run(ROOT, os.path.join(ROOT, "bench"), args.workload, args.seed,
                         args.seconds, bool(args.trace), torch.device("cuda", 0), T_START, log)
    if result is None:
        return 2
    bad = harness.forbidden_modules()
    if bad:
        log(f"bench: modules of JAX or the JAX package were loaded: {bad}")
        return 4
    for name, c in result["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
