"""The GP serving driver of the port — the GP half of ``repro.launch.serve``.

Fit the partitioned surface on the synthetic E3SM-like field (or load a
saved artifact, either package's) and answer a stream of query batches
with a latency/throughput report. A thin shim over ``repro_torch.api``:
the flags parse into a ``FitConfig``/``ServeConfig`` and ``api.Server``
serves.

  PYTHONPATH=src python -m repro_torch.launch.serve --gp --gp-grid 8 --gp-m 10

``--sharded`` serves the halo program (``repro_torch.launch.serve_sharded``:
the one-process program, or the mesh lane under ``torchrun``); ``--http``
serves over HTTP (``repro_torch.net.server``). Runs on ``--device``,
``cuda`` when absent. The LM serving half (``--arch``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time


def serve_gp(args) -> None:
    """Batched query loop over the blended PSVGP surface: fit (or load) the
    artifact, then serve the request stream through a replicated
    ``api.Server``."""
    from repro_torch import api
    from repro_torch.launch.serve_sharded import load_or_train, query_batches, session_configs

    fit_cfg, serve_cfg, _ = session_configs(args, expect_mode="replicated")
    ds, fitted = load_or_train(args, fit_cfg=fit_cfg)

    t0 = time.perf_counter()
    if serve_cfg is None:
        serve_cfg = api.ServeConfig(mode="replicated")
    server = api.Server(fitted, serve_cfg)
    if ds is not None:
        print(f"posterior cache built in {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"on {server.device} (one O(P m^3) factorization, reused by every request)")
    else:
        print(f"posterior cache restored from the artifact on {server.device} "
              "(no factorization at serve time)")

    batches = query_batches(
        fitted.grid, ds, batch=args.gp_batch, requests=args.gp_requests,
        seed=args.seed, skew=args.gp_skew,
    )
    report = server.stream(batches)
    pct, qps = report["latency_ms"], report["points_per_s"]
    print(f"served {args.gp_requests} requests x {args.gp_batch} points")
    print(f"latency/request ms: p50={pct['p50_ms']:.2f} "
          f"p95={pct['p95_ms']:.2f} p99={pct['p99_ms']:.2f}")
    print(f"throughput: {qps:,.0f} points/s")


def main() -> None:
    from repro_torch.launch.serve_sharded import add_gp_args

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="LM serving: not ported yet (ROADMAP queue 1, item 6)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gp", action="store_true", help="serve the stitched PSVGP surface")
    ap.add_argument("--sharded", action="store_true",
                    help="GP mode: serve the halo program "
                         "(repro_torch.launch.serve_sharded) instead of the "
                         "replicated cache")
    add_gp_args(ap)
    args = ap.parse_args()

    if args.arch:
        ap.exit(2, f"--arch {args.arch}: the LM substrate is not ported to "
                   "repro_torch yet (ROADMAP queue 1, item 6); serve it with "
                   "python -m repro.launch.serve, or serve the GP with --gp\n")
    if args.sharded and not args.gp:
        ap.error("--sharded only applies to the GP serving mode (add --gp)")
    if args.http and not args.gp:
        ap.error("--http only applies to the GP serving mode (add --gp)")
    if not args.gp:
        ap.error("--gp required (the LM serving mode is not ported yet)")
    if args.gp_requests < 1 or args.gp_batch < 1:
        ap.error("--gp-requests and --gp-batch must be >= 1")
    if args.http:
        from repro_torch.launch.serve_sharded import HTTP_UNDER_TORCHRUN, launched_as_rank
        from repro_torch.net.server import serve_http

        if launched_as_rank():
            ap.error(HTTP_UNDER_TORCHRUN)

        serve_http(args, expect_mode="sharded" if args.sharded else "replicated")
        return
    if args.sharded:
        from repro_torch.launch.serve_sharded import serve_sharded

        serve_sharded(args)
    else:
        serve_gp(args)


if __name__ == "__main__":
    main()
