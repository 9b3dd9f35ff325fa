"""End-to-end in-situ driver on the PyTorch port (the paper's deployment
scenario, §1/§5).

The twin of ``examples/e3sm_insitu.py``: a running climate model with a
live query endpoint attached, on the GPU.

  step 0   ``api.fit`` trains the partitioned surface from scratch and a
           ``Server`` goes live on it.
  step t   a new time slice arrives (the field drifts); ``api.refit``
           warm-starts from step t-1's parameters under a fixed SGD
           budget; the new model is committed to the format=2 artifact
           store (``save_step``) and ``Server.swap`` flips it live with
           zero downtime.
  post hoc the store is a versioned timeline: any step loads back bitwise
           (``FittedPSVGP.load(store, step=t)``) without the simulation
           or retraining.

  PYTHONPATH=src python examples/e3sm_insitu_torch.py --sim-steps 5 [--device cpu]
"""
import argparse
import tempfile

import numpy as np

from repro_torch import api
from repro_torch.core.metrics import boundary_rmsd, rmspe
from repro_torch.core.neighbors import boundary_probes
from repro_torch.core.partition import partition_data
from repro_torch.data.spatial import e3sm_like_field


def _rmspe_on(fitted: api.FittedPSVGP, ds) -> float:
    """Training-data RMSPE of ``fitted`` on its own slice."""
    data = partition_data(ds.x, ds.y, fitted.grid, device=fitted.device)
    return float(rmspe(fitted.static, fitted.state, data))


def _param_kib(params) -> float:
    """KiB of the variational parameters: the summary the store keeps."""
    leaves = [params.m_star, params.s_tril, params.z, *params.cov, params.log_beta]
    return sum(t.numel() * t.element_size() for t in leaves) / 1024


def run(args, store: str) -> None:
    # --- step 0: train from scratch, go live ----------------------------
    ds = e3sm_like_field(n=args.n_obs, seed=100)
    cfg = api.FitConfig(grid=args.grid, m=args.m, delta=args.delta,
                        train_iters=args.first_fit_iters)
    fitted = api.fit(cfg, ds, device=args.device, verbose=True)
    fitted.save_step(store, 0, meta={"rmspe": _rmspe_on(fitted, ds)})
    server = api.Server(fitted)

    rng = np.random.default_rng(7)
    print(f"slice 0: live on {server.device} (summary {_param_kib(fitted.params):.0f} KiB "
          f"-> {store}/step_00000000)")

    probe = mean = None
    for t in range(1, args.sim_steps):
        # --- the "simulation" produces a new time slice (field drifts) ---
        ds = e3sm_like_field(n=args.n_obs, seed=100 + t)

        # --- in-situ budget: warm refit alongside the sim step ----------
        new = api.refit(fitted, ds, api.RefitConfig(train_iters=args.iters_per_step))
        r = _rmspe_on(new, ds)
        b = float(boundary_rmsd(new.static, new.state,
                                boundary_probes(new.grid, probes_per_edge=8)))

        # --- commit the step, then flip it live (zero downtime) ---------
        path = new.save_step(store, t, meta={"refit_s": new.refit_seconds, "rmspe": r})
        swap = server.swap(new, version=t)

        # the endpoint answers against the JUST-SWAPPED model
        lo = [new.grid.x_edges[0], new.grid.y_edges[0]]
        hi = [new.grid.x_edges[-1], new.grid.y_edges[-1]]
        probe = rng.uniform(lo, hi, (64, 2)).astype(np.float32)
        mean, _ = server.submit(probe)

        print(f"slice {t}: refit {args.iters_per_step} iters in "
              f"{new.refit_seconds:.2f}s | RMSPE {r:.4f} | bRMSD {b:.4f} | "
              f"swap build {swap['build_s'] * 1e3:.1f} ms | "
              f"probe mean {float(mean.mean()):+.3f} -> {path}")
        fitted = new

    # --- lifecycle report: who served what, and for how long ------------
    lc = server.lifecycle()
    print(f"lifecycle: {lc['swaps']} swaps, active version {lc['active_version']}")
    for v in lc["versions"]:
        refit_s = f"{v['refit_s']:.2f}s" if v["refit_s"] is not None else "  (fit)"
        print(f"  version {v['version']}: {v['requests']} requests, "
              f"refit {refit_s}, build {v['build_s'] * 1e3:.1f} ms")

    # --- post hoc: the store replays any step without the simulation -----
    steps = api.peek_steps(store)  # pure JSON
    if probe is not None:
        replay = api.FittedPSVGP.load(store, step=steps[-1], device=args.device)
        again, _ = replay.predict(probe)
        if not np.array_equal(again.cpu().numpy(), mean):
            raise SystemExit("post-hoc replay differs from the live answer")
        print(f"store has steps {steps}; step {steps[-1]} replays bitwise")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sim-steps", type=int, default=5)
    ap.add_argument("--iters-per-step", type=int, default=150,
                    help="warm-refit SGD budget per simulation step")
    ap.add_argument("--first-fit-iters", type=int, default=300,
                    help="from-scratch budget for step 0")
    ap.add_argument("--n-obs", type=int, default=12_000)
    ap.add_argument("--grid", type=int, default=10)
    ap.add_argument("--m", type=int, default=5)
    ap.add_argument("--delta", type=float, default=0.125)
    ap.add_argument("--store", default=None,
                    help="format=2 artifact store (one step dir per slice); "
                         "a temporary directory when absent")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda when absent (raises on a machine without a GPU)")
    args = ap.parse_args()
    if args.store is not None:
        run(args, args.store)
        return
    with tempfile.TemporaryDirectory() as store:
        run(args, store)


if __name__ == "__main__":
    main()
