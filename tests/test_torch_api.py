"""The port's api layer against the JAX package on a JAX-saved artifact.

One artifact, two packages: ``repro.api.fit(...).save(path)`` is loaded by
``repro_torch.api.FittedPSVGP.load`` (and ``from_numpy``) and served on
``device="cpu"`` in every ServeConfig mode, pipeline, router and kernel
lane; every answer is held to JAX's ``fitted.predict`` (replicated) or
``routing.predict_routed`` (sharded) through ``ref.tolerance_ratio``
(1e-5 of the magnitude of the summed terms). Also: the golden property
(pipelined == serial and submit_many == solo submit, bitwise), config
JSON shared with the JAX package, and no silent CPU: an entry point that
is not given a device on a machine without CUDA raises.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import routing as jrouting
from repro.data.spatial import e3sm_like_field
from repro_torch import api as tapi
from repro_torch.core.blend import blend_error_scales
from repro_torch.device import resolve_device
from repro_torch.kernels import ref

FIT = japi.FitConfig(grid=3, m=5, train_iters=40, seed=0)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(path, JAX fitted, queries, JAX routed answers, JAX replicated answers)."""
    ds = e3sm_like_field(n=1500, seed=0)
    fitted = japi.fit(FIT, ds)
    path = str(tmp_path_factory.mktemp("artifact"))
    fitted.save(path)
    g = fitted.grid
    q = np.random.default_rng(1).uniform(
        [g.x_edges[0], g.y_edges[0]], [g.x_edges[-1], g.y_edges[-1]], (300, 2)
    ).astype(np.float32)
    routed = jrouting.predict_routed(
        fitted.cache, fitted.static.cov_fn, g, jrouting.build_routing_table(g, q)
    )
    rep = fitted.predict(q)
    return path, fitted, q, [np.asarray(a) for a in routed], [np.asarray(a) for a in rep]


def _agree(tf, q, got, want):
    mean_s, var_s = blend_error_scales(tf.cache, tf.grid, q)
    assert ref.tolerance_ratio(torch.as_tensor(np.asarray(got[0])), torch.as_tensor(want[0]),
                               mean_s) <= 1
    assert ref.tolerance_ratio(torch.as_tensor(np.asarray(got[1])), torch.as_tensor(want[1]),
                               var_s) <= 1


def test_load_restores_the_jax_artifact(artifact):
    path, jf, *_ = artifact
    tf = tapi.FittedPSVGP.load(path, device="cpu")
    assert tf.config.to_dict() == jf.config.to_dict()
    assert (tf.grid.gx, tf.grid.gy) == (3, 3)
    np.testing.assert_array_equal(tf.grid.x_edges, jf.grid.x_edges)
    for got, want in zip(
        [tf.cache.z, tf.cache.w, tf.cache.u, tf.cache.c, tf.cache.cov.log_lengthscale,
         tf.cache.cov.log_variance, tf.cache.log_beta],
        [jf.cache.z, jf.cache.w, jf.cache.u, jf.cache.c, jf.cache.cov.log_lengthscale,
         jf.cache.cov.log_variance, jf.cache.log_beta],
        strict=True,
    ):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # no refactorization


@pytest.mark.parametrize(
    "mode,pipeline,router,backend,q_max",
    [("replicated", "serial", "single", "auto", None)]
    + [("sharded", p, r, b, None)
       for p in ("serial", "pipelined")
       for r in ("single", "two-level")
       for b in ("auto", "pallas", "fused")]
    + [("sharded", "serial", "single", "fused", 64)],
)
def test_every_serve_mode_matches_jax(artifact, mode, pipeline, router, backend, q_max):
    path, _, q, routed, rep = artifact
    cfg = tapi.ServeConfig(mode=mode, pipeline=pipeline, router=router, backend=backend,
                           q_max=q_max)
    server = tapi.Server.from_artifact(path, cfg, device="cpu")
    assert server.backend == ("ref" if backend == "auto" else backend)
    want = rep if mode == "replicated" else routed
    batches = [q[:100], q[100:], q]
    results = []
    rec = server.stream(batches, on_result=lambda i, r: results.append(r))
    assert rec["device"] == "cpu" and rec["latency_ms"]["p50_ms"] > 0
    assert len(results) == 3
    _agree(server.fitted, q, results[2], want)
    joined = [np.concatenate([results[0][k], results[1][k]]) for k in (0, 1)]
    _agree(server.fitted, q, joined, want)
    assert server.stats()["requests"] >= 3


@pytest.mark.parametrize("router", ["single", "two-level"])
@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_golden_property_on_the_cpu_lanes(artifact, router, backend):
    path, _, q, *_ = artifact
    fitted = tapi.FittedPSVGP.load(path, device="cpu")
    out = {}
    for pipeline in ("serial", "pipelined"):
        server = tapi.Server(fitted, tapi.ServeConfig(
            mode="sharded", pipeline=pipeline, router=router, backend=backend))
        res = []
        server.stream([q[:50], q[50:170], q[170:]], on_result=lambda i, r, res=res: res.append(r))
        out[pipeline] = res
    for a, b in zip(out["serial"], out["pipelined"], strict=True):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    requests = [q[:1], q[1:8], q[8:40], q[40:41]]
    many = server.submit_many(requests)
    solo = [server.submit(r) for r in requests]
    for a, b in zip(many, solo, strict=True):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_from_numpy_builds_the_cache_when_the_arrays_carry_none(artifact):
    path, jf, *_ = artifact
    arrays = dict(np.load(f"{path}/arrays.npz"))
    params_only = {k: v for k, v in arrays.items() if k.startswith("params/")}
    grid = tapi.FittedPSVGP.load(path, device="cpu").grid
    tf = tapi.FittedPSVGP.from_numpy(
        tapi.FitConfig.from_dict(jf.config.to_dict()), grid, params_only, device="cpu"
    )
    for got, want in ((tf.cache.w, jf.cache.w), (tf.cache.u, jf.cache.u), (tf.cache.c, jf.cache.c)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-3 * max(1.0, float(np.abs(want).max())))
    with pytest.raises(KeyError, match="miss"):
        tapi.FittedPSVGP.from_numpy(tf.config, tf.grid, {"params/z": arrays["params/z"]},
                                    device="cpu")
    bad = dict(arrays, **{"params/z": arrays["params/z"][:, :3]})
    with pytest.raises(ValueError, match="params/z"):
        tapi.FittedPSVGP.from_numpy(tf.config, tf.grid, bad, device="cpu")


def test_loads_a_step_of_a_format_2_store(artifact, tmp_path):
    path, jf, q, *_ = artifact
    store = str(tmp_path / "store")
    jf.save_step(store, 3)
    jf.save_step(store, 7)
    tf = tapi.FittedPSVGP.load(store, step=3, device="cpu")
    np.testing.assert_array_equal(tf.cache.w.numpy(), np.asarray(jf.cache.w))
    assert tapi.FittedPSVGP.load(store, device="cpu").config == tf.config
    with pytest.raises(KeyError):
        tapi.FittedPSVGP.load(store, step=5, device="cpu")
    with pytest.raises(ValueError, match="single format-1"):
        tapi.FittedPSVGP.load(path, step=1, device="cpu")


def test_session_json_configures_both_packages():
    for cfg in (
        japi.ServeConfig(mode="sharded", pipeline="pipelined", router="two-level",
                         backend="fused", headroom=1.5, pad_multiple=16),
        japi.ServeConfig(mode="sharded", q_max=64),
        japi.ServeConfig(),
    ):
        assert tapi.ServeConfig.from_json(cfg.to_json()).to_dict() == cfg.to_dict()
    assert tapi.FitConfig.from_json(FIT.to_json()).to_dict() == FIT.to_dict()
    with pytest.raises(ValueError):
        tapi.ServeConfig(mode="replicated", backend="fused")
    with pytest.raises(ValueError, match="unknown ServeConfig fields"):
        tapi.ServeConfig.from_dict({"mode": "sharded", "device": "cuda"})
    sharded = tapi.ServeConfig(mode="sharded")
    assert sharded.resolve_backend(torch.device("cuda")) == "fused"
    assert sharded.resolve_backend(torch.device("cpu")) == "ref"
    assert tapi.ServeConfig(mode="sharded", backend="pallas").resolve_backend("cpu") == "pallas"
    assert tapi.ServeConfig().resolve_backend("cuda") == "ref"


def test_no_silent_cpu_without_a_gpu(artifact, monkeypatch):
    path, *_ = artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.FittedPSVGP.load(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Server.from_artifact(path, tapi.ServeConfig(mode="sharded"))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
