"""Serve a small model with batched requests on the PyTorch port.

The twin of ``examples/serve_demo.py``.

LM mode (default): prefill + decode loop on a smoke-sized architecture
(a subprocess over ``repro_torch.launch.serve --arch A --smoke``; any of
the ten, e.g. ``--arch recurrentgemma-2b``, or ``--arch whisper-base``
with its stub frames through the encoder).

GP mode (--gp): fit the partitioned surface, SAVE the artifact, then serve
query batches from the loaded artifact (``Server.from_artifact``; no
retraining on the serving path). ``--sharded`` serves the halo program
through the overlapped pipeline (one slots-kernel launch a request on
CUDA).

  PYTHONPATH=src python examples/serve_demo_torch.py [--arch recurrentgemma-2b] [--device cpu]
  PYTHONPATH=src python examples/serve_demo_torch.py --gp [--sharded] [--device cpu]
"""
import argparse
import subprocess
import sys
import tempfile

import numpy as np


def run_gp(args) -> None:
    from repro_torch import api
    from repro_torch.data.spatial import e3sm_like_field

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b", help="LM mode: the architecture id")
    ap.add_argument("--prompt-len", type=int, default=64, help="LM mode: prompt tokens")
    ap.add_argument("--gen", type=int, default=32, help="LM mode: generated tokens")
    ap.add_argument("--gp", action="store_true",
                    help="serve the blended PSVGP surface instead of an LM "
                         "(fit -> save artifact -> Server.from_artifact)")
    ap.add_argument("--sharded", action="store_true",
                    help="GP mode: the halo program + overlapped pipeline")
    ap.add_argument("--n", type=int, default=4000, help="GP mode: observations")
    ap.add_argument("--grid", type=int, default=4, help="GP mode: partition grid side")
    ap.add_argument("--iters", type=int, default=150, help="GP mode: training steps")
    ap.add_argument("--requests", type=int, default=12, help="GP mode: requests")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences (LM mode, default 4) or points a request (GP mode, "
                         "default 512)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda when absent (raises on a machine without a GPU)")
    args = ap.parse_args()
    if args.gp:
        args.batch = 512 if args.batch is None else args.batch
        run_gp(args)
        return
    if args.sharded:
        ap.error("--sharded only applies to the GP mode (add --gp)")
    cmd = [
        sys.executable, "-m", "repro_torch.launch.serve",
        "--arch", args.arch, "--smoke",
        "--batch", str(4 if args.batch is None else args.batch),
        "--prompt-len", str(args.prompt_len),
        "--gen", str(args.gen),
    ]
    if args.device is not None:
        cmd += ["--device", args.device]
    sys.exit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
