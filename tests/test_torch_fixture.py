"""The committed full-width artifact that carries a JAX-trained model into
the PyTorch port, and the reference answers stored beside it.

``tests/fixtures/torch_port/psvgp_e3sm/`` holds the JAX package's
``FittedPSVGP.save`` output at the paper's own configuration
(``repro.configs.psvgp_e3sm``: 48,602 points, a 20x20 grid of 400 cells,
m = 5, delta = 0.125, batch 32, lr 0.05, 2,500 iterations) plus
``reference.npz``: 4,096 seeded queries (2,048 uniform over the grid's
box, then 2,048 training points with their ``y``) and the JAX answers of
``routing.predict_routed`` (the ref lane of the halo program) and of
``fitted.predict`` (the replicated lane).

Regenerate (about a minute on a CPU)::

    PYTHONPATH=src python tests/test_torch_fixture.py --regenerate

The tier-1 tests check both directions: the JAX package still loads the
artifact and reproduces ``reference.npz``, and the port's CPU lanes match
it. ``chip_smoke.py`` holds the port's CUDA lanes to the same file.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "psvgp_e3sm")
REFERENCE = os.path.join(FIXTURE, "reference.npz")

FIT = dict(
    grid=20, m=5, delta=0.125, train_iters=2500, batch_size=32,
    learning_rate=0.05, seed=0,
)
N_OBS = 48602
N_HALF = 2048


def reference_queries(x: np.ndarray, y: np.ndarray, grid, *, seed: int = 0):
    """(queries (4096, 2), y_train (2048,)): the first half uniform over the
    grid's box, the second half training points, both drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    lo = np.array([grid.x_edges[0], grid.y_edges[0]])
    hi = np.array([grid.x_edges[-1], grid.y_edges[-1]])
    uniform = rng.uniform(lo, hi, (N_HALF, 2)).astype(np.float32)
    idx = rng.choice(x.shape[0], N_HALF, replace=False)
    queries = np.concatenate([uniform, x[idx].astype(np.float32)], axis=0)
    return queries, y[idx].astype(np.float32)


def jax_answers(fitted, queries: np.ndarray) -> dict:
    """The JAX package's routed (ref lane) and replicated answers."""
    from repro.core import routing

    table = routing.build_routing_table(fitted.grid, queries)
    routed_mean, routed_var = routing.predict_routed(
        fitted.cache, fitted.static.cov_fn, fitted.grid, table
    )
    rep_mean, rep_var = fitted.predict(queries)
    return {
        "routed_mean": np.asarray(routed_mean, np.float32),
        "routed_var": np.asarray(routed_var, np.float32),
        "replicated_mean": np.asarray(rep_mean, np.float32),
        "replicated_var": np.asarray(rep_var, np.float32),
    }


def regenerate() -> None:
    from repro import api
    from repro.data.spatial import e3sm_like_field

    ds = e3sm_like_field(n=N_OBS, seed=FIT["seed"])
    fitted = api.fit(api.FitConfig(**FIT), ds, verbose=True)
    fitted.save(FIXTURE)
    queries, y_train = reference_queries(ds.x, ds.y, fitted.grid)
    np.savez(REFERENCE, queries=queries, y_train=y_train, **jax_answers(fitted, queries))
    print(f"wrote {FIXTURE}")


def _close(got, want, *, atol, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    return float(np.max(err - (atol + rtol * np.abs(want))))


def test_jax_package_reproduces_the_reference_answers():
    from repro import api

    ref = np.load(REFERENCE)
    fitted = api.FittedPSVGP.load(FIXTURE)
    assert fitted.grid.num_partitions == 400 and fitted.config.m == 5
    got = jax_answers(fitted, ref["queries"])
    for key, value in got.items():
        assert value.shape == (2 * N_HALF,)
        # the same JAX program on the same artifact: float32 rounding only
        assert _close(value, ref[key], atol=1e-6, rtol=1e-5) <= 0, key


def test_port_cpu_lanes_match_the_reference_answers():
    from repro_torch import api as tapi
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.kernels.ref import tolerance_ratio

    ref = np.load(REFERENCE)
    fitted = tapi.FittedPSVGP.load(FIXTURE, device="cpu")
    q = ref["queries"]
    mean, var = tapi.Server(fitted, tapi.ServeConfig(mode="sharded")).submit(q)
    rep_mean, rep_var = fitted.predict(q)
    # |d| <= 1e-5 max(1, scale): the magnitude of the terms each output
    # sums (ref.tolerance_ratio) — the fitted c_j cancel in the mean
    mean_scale, var_scale = blend_error_scales(fitted.cache, fitted.grid, q)
    for got_m, got_v, kind in (
        (torch.from_numpy(mean), torch.from_numpy(var), "routed"),
        (rep_mean, rep_var, "replicated"),
    ):
        want_m = torch.from_numpy(ref[f"{kind}_mean"])
        want_v = torch.from_numpy(ref[f"{kind}_var"])
        assert tolerance_ratio(got_m, want_m, mean_scale) <= 1, kind
        assert tolerance_ratio(got_v, want_v, var_scale) <= 1, kind
    rmspe = float(np.sqrt(np.mean((mean[N_HALF:] - ref["y_train"]) ** 2)))
    assert rmspe < 0.1  # a trained surface, not noise (y is standardized)


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        raise SystemExit("usage: python tests/test_torch_fixture.py --regenerate")
    regenerate()
