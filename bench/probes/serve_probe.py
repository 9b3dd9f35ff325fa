"""Probe of the serving path, to size serving cells later; adds no cell.

    python3 bench/probes/serve_probe.py --points 4096 --requests 200 --seed 1

Loads the committed 400-cell artifact (``tests/fixtures/torch_port/psvgp_e3sm``),
serves uniform requests through ``Server.stream`` (sharded, the fused
kernel lane, pipelined), then profiles 20 serial requests for the card's
busy share. Prints one JSON line: p50/p95 ms, points/s, busy and idle
share. Run it several times, one process each, to read the spread between
runs.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACT = os.path.join(ROOT, "tests", "fixtures", "torch_port", "psvgp_e3sm")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--points", type=int, default=4096)
    parser.add_argument("--requests", type=int, default=200)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p or ".") != os.path.dirname(__file__)]
    import numpy as np
    import torch

    from bench import profiles

    if not torch.cuda.is_available():
        print("serve_probe: needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    from repro_torch import api

    dev = torch.device("cuda", 0)
    fitted = api.FittedPSVGP.load(ARTIFACT, device=dev)
    grid = fitted.grid
    rng = np.random.default_rng(args.seed)
    lo, hi = [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]]
    reqs = [rng.uniform(lo, hi, (args.points, 2)).astype(np.float32)
            for _ in range(args.requests)]
    rec = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline="pipelined")).stream(reqs)
    serial = api.Server(fitted, api.ServeConfig(mode="sharded"))
    serial.submit(reqs[0])
    torch.cuda.synchronize()
    window = reqs[:20]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in window:
            serial.submit(q)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    trace = profiles.reduce(prof, window_s, len(window))
    print(json.dumps({"points": args.points, "requests": args.requests, "seed": args.seed,
                      "p50_ms": rec["latency_ms"]["p50_ms"], "p95_ms": rec["latency_ms"]["p95_ms"],
                      "points_per_s": rec["points_per_s"], "busy_s": trace["busy_s"],
                      "window_s": window_s, "idle_share": 1.0 - trace["busy_s"] / window_s,
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
