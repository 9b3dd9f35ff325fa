"""Serve the GP surface with batched requests on the PyTorch port.

The twin of the GP half of ``examples/serve_demo.py``: fit the
partitioned surface, SAVE the artifact, then serve query batches from the
loaded artifact (``Server.from_artifact``; no retraining on the serving
path). ``--sharded`` serves the halo program through the overlapped
pipeline (one slots-kernel launch a request on CUDA).

  PYTHONPATH=src python examples/serve_demo_torch.py [--sharded] [--device cpu]
"""
import argparse
import tempfile

import numpy as np

from repro_torch import api
from repro_torch.data.spatial import e3sm_like_field


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sharded", action="store_true",
                    help="the halo program + overlapped pipeline")
    ap.add_argument("--n", type=int, default=4000, help="observations")
    ap.add_argument("--grid", type=int, default=4, help="partition grid side")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda when absent (raises on a machine without a GPU)")
    args = ap.parse_args()

    ds = e3sm_like_field(n=args.n, seed=0)
    fitted = api.fit(api.FitConfig(grid=args.grid, m=6, train_iters=args.iters), ds,
                     device=args.device, verbose=True)

    rng = np.random.default_rng(1)
    lo, hi = ds.x.min(axis=0), ds.x.max(axis=0)
    batches = [rng.uniform(lo, hi, (args.batch, 2)).astype(np.float32)
               for _ in range(args.requests)]

    cfg = api.ServeConfig(
        mode="sharded" if args.sharded else "replicated",
        pipeline="pipelined" if args.sharded else "serial",
    )
    with tempfile.TemporaryDirectory() as td:
        fitted.save(td)
        server = api.Server.from_artifact(td, cfg, device=fitted.device)  # serving != training
        report = server.stream(batches)
    pct = report["latency_ms"]
    print(f"served {len(batches)} requests x {args.batch} points "
          f"({cfg.mode}/{cfg.pipeline}, backend={report['backend']}, {report['device']})")
    print(f"latency/request ms: p50={pct['p50_ms']:.2f} "
          f"p95={pct['p95_ms']:.2f} p99={pct['p99_ms']:.2f}")
    print(f"throughput: {report['points_per_s']:,.0f} points/s")


if __name__ == "__main__":
    main()
