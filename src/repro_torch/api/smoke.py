"""api-smoke of the port — the fit -> artifact -> serve lifecycle end to end.

Fits a 4x4 model, SAVES the artifact, then serves requests through
``Server.from_artifact`` — from the loaded artifact, never the in-memory
model — in both modes:

  * replicated: the loaded predictions must be BITWISE the in-memory
    model's (the artifact round-trip contract);
  * sharded (pipelined, two-level router, ``auto`` backend — the slots
    kernel on CUDA): within ``ref.tolerance_ratio`` <= 1 of the replicated
    answers on every request, the tolerance scaled by the blend's summed
    terms (``blend.blend_error_scales``): a fixed 1e-4 does not hold where
    a fitted mean cancels.

Exits non-zero on any violation. Runs on ``--device``, ``cuda`` when
absent.

  PYTHONPATH=src python -m repro_torch.api.smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import tempfile


class SmokeViolation(RuntimeError):
    pass


def run(*, grid: int = 4, m: int = 5, n: int = 1500, train_iters: int = 150,
        requests: int = 5, batch: int = 256, seed: int = 0, device=None) -> dict:
    """The lifecycle at the given size; raises :class:`SmokeViolation` on
    any broken contract. Returns the measured agreement."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.data.spatial import e3sm_like_field
    from repro_torch.kernels import ref

    ds = e3sm_like_field(n=n, seed=seed)
    fitted = api.fit(
        api.FitConfig(grid=grid, m=m, train_iters=train_iters, seed=seed),
        ds, device=device, verbose=True,
    )

    rng = np.random.default_rng(seed + 1)
    lo, hi = ds.x.min(axis=0), ds.x.max(axis=0)
    batches = [rng.uniform(lo, hi, (batch, 2)).astype(np.float32) for _ in range(requests)]

    with tempfile.TemporaryDirectory() as td:
        fitted.save(td)
        print(f"artifact saved: grid={grid}x{grid}, m={m}")

        # replicated, from the artifact: bitwise == the in-memory model (the
        # in-memory predictions double as the sharded lane's reference)
        rep = api.Server.from_artifact(td, api.ServeConfig(mode="replicated"),
                                       device=fitted.device)
        reference = []
        for i, q in enumerate(batches):
            m_l, v_l = rep.submit(q)
            m_m, v_m = (a.cpu().numpy() for a in fitted.predict(q))
            reference.append((m_m, v_m))
            if not (np.array_equal(m_l, m_m) and np.array_equal(v_l, v_m)):
                raise SmokeViolation(f"replicated from_artifact differs from in-memory (batch {i})")
        print(f"replicated from_artifact on {rep.device}: {requests} requests bitwise == in-memory")

        sh = api.Server.from_artifact(
            td,
            api.ServeConfig(mode="sharded", pipeline="pipelined",
                            router="two-level", backend="auto"),
            device=fitted.device,
        )
        results: dict = {}
        sh.stream(batches, warm=True, on_result=lambda i, out: results.setdefault(i, out))
        worst = 0.0
        for i, (q, (m_m, v_m)) in enumerate(zip(batches, reference, strict=True)):
            got_m, got_v = results[i]
            if not (np.isfinite(got_m).all() and np.isfinite(got_v).all()
                    and got_m.shape == (batch,) and got_v.shape == (batch,)):
                raise SmokeViolation(f"sharded answer of batch {i} is not finite of shape ({batch},)")
            mean_s, var_s = (a.cpu() for a in blend_error_scales(fitted.cache, fitted.grid, q))
            worst = max(worst,
                        ref.tolerance_ratio(torch.as_tensor(got_m), torch.as_tensor(m_m), mean_s),
                        ref.tolerance_ratio(torch.as_tensor(got_v), torch.as_tensor(v_m), var_s))
        if worst > 1:
            raise SmokeViolation(f"sharded from_artifact drifted from replicated: "
                                 f"tolerance ratio {worst:.4f} > 1")
        print(f"sharded from_artifact ({sh.backend} backend, {sh.config.router} router, "
              f"{sh.device}): {requests} requests, tolerance ratio vs replicated "
              f"{worst:.4f} (<= 1 agrees)")
    print("api-smoke OK")
    return {"tolerance_ratio": worst, "backend": sh.backend, "device": str(sh.device)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", type=int, default=4, help="partition grid side")
    ap.add_argument("--m", type=int, default=5, help="inducing points per partition")
    ap.add_argument("--n", type=int, default=1500, help="training observations")
    ap.add_argument("--train-iters", type=int, default=150)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to fit and serve; cuda when absent (raises "
                         "on a machine without a GPU)")
    a = ap.parse_args()
    try:
        run(grid=a.grid, m=a.m, n=a.n, train_iters=a.train_iters, requests=a.requests,
            batch=a.batch, seed=a.seed, device=a.device)
    except SmokeViolation as e:
        print(f"api-smoke FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
