"""The port's in-situ lifecycle against the JAX package, on the CPU.

  * ``gp/exact.py``: the exact GP's logml, mean and variance against
    ``repro.gp.exact`` on the same seeded inputs, and the port's mirrors of
    the JAX package's own SVGP-vs-exact checks (tests/test_svgp.py) with
    the same bounds;
  * train-state checkpoints, both ways: a JAX ``save_train_state`` loads in
    the port bitwise and a port one in ``repro.checkpoint`` bitwise (the
    ``step`` counters as int32 ``()``), the manifests are the same bytes,
    and a resumed fit equals the uninterrupted one bitwise;
  * ``peek_fit_config`` / ``peek_steps`` on a store the JAX package wrote;
  * ``Server.swap``: the lifecycle record's shape against JAX's, answers
    after a swap to a JAX-refit artifact within ``tolerance_ratio`` <= 1 of
    JAX's, the swap under a live FrontDoor stream (every answer bitwise the
    old model's or the new one's, monotone), a swap from a stream's
    ``on_result`` (the switch lands on the first request routed after it)
    and the refusal of a grid change in sharded mode.
"""
from __future__ import annotations

import asyncio
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import checkpoint as jckpt
from repro.core import routing as jrouting
from repro.data.spatial import e3sm_like_field
from repro.gp import covariances as jcov
from repro.gp import exact as jexact
from repro_torch import api
from repro_torch import checkpoint as tckpt
from repro_torch.core import svgp
from repro_torch.core.blend import blend_error_scales
from repro_torch.gp import CovarianceParams, exact_gp_logml, exact_gp_predict, make_covariance
from repro_torch.kernels.ref import tolerance_ratio


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slices():
    """Two consecutive simulation steps of the drifting field."""
    return e3sm_like_field(n=600, seed=0), e3sm_like_field(n=600, seed=1)


@pytest.fixture(scope="module")
def fitted(slices):
    torch.set_num_threads(1)
    return api.fit(api.FitConfig(grid=2, m=4, train_iters=60, seed=0), slices[0], device="cpu")


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# gp/exact.py
# ---------------------------------------------------------------------------


def _toy(rng, n=64, d=2, noise=0.1):
    x = rng.uniform(-2.0, 2.0, (n, d)).astype(np.float32)
    f = np.sin(x[:, 0] * 2.0) + 0.5 * np.cos(x[:, 1] * 3.0)
    return x, (f + noise * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_gp_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x, y = _toy(rng)
    xs = rng.uniform(-2.5, 2.5, (40, 2)).astype(np.float32)
    log_l = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
    log_v, log_beta = np.float32(rng.uniform(-0.3, 0.3)), np.float32(rng.uniform(1.0, 3.0))
    jp = jcov.CovarianceParams(jax.numpy.asarray(log_l), jax.numpy.asarray(log_v))
    tp = CovarianceParams(_t(log_l), _t(log_v))
    jrbf, trbf = jcov.make_covariance("rbf"), make_covariance("rbf")
    want_ml = float(jexact.exact_gp_logml(jp, log_beta, jrbf, x, y))
    got_ml = float(exact_gp_logml(tp, _t(log_beta), trbf, _t(x), _t(y)))
    assert abs(got_ml - want_ml) <= 1e-4 * max(1.0, abs(want_ml))
    jm, jv = jexact.exact_gp_predict(jp, log_beta, jrbf, x, y, xs)
    tm, tv = exact_gp_predict(tp, _t(log_beta), trbf, _t(x), _t(y), _t(xs))
    for got, want in ((tm, jm), (tv, jv)):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want) <= 1e-4 * np.maximum(1.0, np.abs(want)))


def _params(rng, m, x=None):
    """One model with a leading axis of 1 (the port's svgp is batched)."""
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    cfg = svgp.SVGPConfig(num_inducing=m, input_dim=2)
    x_init = _t(x)[None] if x is not None else _t(rng.uniform(-2, 2, (m, 2)))[None]
    return svgp.init_svgp_params(gen, cfg, x_init)


def _optimal_q(params, cov_fn, x, y, jitter=1e-6):
    """Closed-form Titsias-optimal q(u) = N(m*, S*) (float64 algebra, as the
    JAX package's test computes it in its own precision):
    S* = Kmm (Kmm + beta Kmn Knm)^{-1} Kmm,  m* = beta S* Kmm^{-1} Kmn y."""
    beta = torch.exp(params.log_beta[0]).double()
    z = params.z[0]
    m = z.shape[0]
    cov = CovarianceParams(params.cov.log_lengthscale[0], params.cov.log_variance[0])
    kmm = cov_fn(cov, z, z).double() + jitter * torch.eye(m, dtype=torch.float64)
    kmn = cov_fn(cov, z, x).double()
    a = kmm + beta * kmn @ kmn.T
    s_star = kmm @ torch.linalg.solve(a, kmm)
    m_star = beta * kmm @ torch.linalg.solve(a, kmn @ y.double())
    sl = torch.linalg.cholesky(s_star + 1e-10 * torch.eye(m, dtype=torch.float64))
    s_tril = torch.tril(sl, -1) + torch.diag(torch.log(torch.diagonal(sl)))
    return params._replace(m_star=m_star.float()[None], s_tril=s_tril.float()[None])


@pytest.mark.parametrize("whitened", [False, True])
def test_elbo_lower_bounds_exact_logml(whitened):
    rng = np.random.default_rng(0)
    x, y = _toy(rng)
    cov_fn = make_covariance("rbf")
    params = _params(rng, 16, x)
    bound = float(svgp.elbo(params, cov_fn, _t(x)[None], _t(y)[None], whitened=whitened)[0])
    cov = CovarianceParams(params.cov.log_lengthscale[0], params.cov.log_variance[0])
    logml = float(exact_gp_logml(cov, params.log_beta[0], cov_fn, _t(x), _t(y)))
    assert bound <= logml + 1e-3


def test_elbo_tight_when_inducing_equal_data():
    rng = np.random.default_rng(1)
    x, y = _toy(rng, n=32)
    cov_fn = make_covariance("rbf")
    params = _params(rng, 32)._replace(z=_t(x)[None])
    params = _optimal_q(params, cov_fn, _t(x), _t(y))
    bound = float(svgp.elbo(params, cov_fn, _t(x)[None], _t(y)[None], jitter=1e-6)[0])
    cov = CovarianceParams(params.cov.log_lengthscale[0], params.cov.log_variance[0])
    logml = float(exact_gp_logml(cov, params.log_beta[0], cov_fn, _t(x), _t(y), jitter=1e-6))
    assert bound <= logml + 1e-3
    assert abs(bound - logml) < 0.02 * abs(logml) + 0.2


def test_predict_matches_exact_gp_with_full_inducing():
    rng = np.random.default_rng(6)
    x, y = _toy(rng, n=32)
    xs = rng.uniform(-2, 2, (16, 2)).astype(np.float32)
    cov_fn = make_covariance("rbf")
    params = _params(rng, 32)._replace(z=_t(x)[None])
    params = _optimal_q(params, cov_fn, _t(x), _t(y))
    mean_s, var_s = svgp.predict(params, cov_fn, _t(xs)[None], jitter=1e-6)
    cov = CovarianceParams(params.cov.log_lengthscale[0], params.cov.log_variance[0])
    mean_e, var_e = exact_gp_predict(cov, params.log_beta[0], cov_fn, _t(x), _t(y), _t(xs),
                                     jitter=1e-6)
    np.testing.assert_allclose(mean_s[0].numpy(), mean_e.numpy(), atol=0.05)
    np.testing.assert_allclose(var_s[0].numpy(), var_e.numpy(), atol=0.05)


# ---------------------------------------------------------------------------
# train-state checkpoints
# ---------------------------------------------------------------------------

SMALL = dict(grid=2, m=4, train_iters=20, batch_size=8, seed=0)


@pytest.fixture(scope="module")
def jax_fitted(slices):
    return japi.fit(japi.FitConfig(**SMALL), slices[0])


def _leaves_equal(flat_a: dict, flat_b: dict) -> None:
    assert list(flat_a) == list(flat_b)
    for key in flat_a:
        a, b = np.asarray(flat_a[key]), np.asarray(flat_b[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def _jax_flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(getattr(e, "name", None) or str(getattr(e, "key", getattr(e, "idx", "")))
                       for e in path)
        out[key] = np.asarray(leaf)
    return out


def test_jax_train_state_loads_in_the_port_bitwise(jax_fitted, slices, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    jckpt.save_train_state(ckpt, 20, jax_fitted.state)
    template = api.fit(api.FitConfig(**SMALL), slices[0], device="cpu").state
    assert tckpt.latest_step(ckpt) == os.path.join(ckpt, "step_00000020")
    back = tckpt.load_train_state(ckpt, template)
    assert type(back) is type(template) and isinstance(back.step, int)
    assert back.step == 20 and back.opt.step == 20
    assert back.params.z.dtype == torch.float32
    _leaves_equal(tckpt.checkpoint.flatten(back), _jax_flat(jax_fitted.state))


def test_port_train_state_loads_in_jax_bitwise(jax_fitted, slices, tmp_path):
    state = api.fit(api.FitConfig(**SMALL), slices[0], device="cpu").state
    ckpt = str(tmp_path / "ckpt")
    path = tckpt.save_train_state(ckpt, 20, state)
    assert os.path.basename(path) == "step_00000020"
    back = jckpt.load_train_state(ckpt, jax_fitted.state)
    assert np.asarray(back.step).dtype == np.int32 and np.asarray(back.step).shape == ()
    assert int(back.step) == 20 and int(back.opt.step) == 20
    _leaves_equal(_jax_flat(back), tckpt.checkpoint.flatten(state))
    # the manifests of the same tree shapes are the same bytes
    jdir = str(tmp_path / "jax")
    jckpt.save_train_state(jdir, 20, jax_fitted.state)
    with open(os.path.join(path, "manifest.msgpack"), "rb") as a, \
            open(os.path.join(jdir, "step_00000020", "manifest.msgpack"), "rb") as b:
        assert a.read() == b.read()


def test_load_pytree_checks_the_template(tmp_path, fitted):
    path = str(tmp_path / "tree")
    tckpt.save_pytree(path, {"a": torch.zeros(3), "n": 7, "skip": None})
    out = tckpt.load_pytree(path, {"a": torch.ones(3), "n": 0, "skip": None})
    assert out["n"] == 7 and out["skip"] is None and torch.equal(out["a"], torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(path, {"a": torch.ones(4), "n": 0})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_pytree(path, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing"):
        tckpt.load_pytree(path, {"b": torch.ones(3), "n": 0})
    assert tckpt.load_train_state(str(tmp_path / "empty"), fitted.state) is None


def test_resume_from_a_train_state_equals_the_uninterrupted_fit(slices, tmp_path):
    cfg = api.FitConfig(**{**SMALL, "train_iters": 24})
    whole = api.fit(cfg, slices[0], device="cpu")
    half = api.fit(api.FitConfig(**{**SMALL, "train_iters": 12}), slices[0], device="cpu")
    ckpt = str(tmp_path / "ckpt")
    tckpt.save_train_state(ckpt, 12, half.state)
    state = tckpt.load_train_state(ckpt, half.state)
    restored = api.FittedPSVGP(half.config, half.grid, half.static, state)
    resumed = api.refit(restored, slices[0], api.RefitConfig(train_iters=12))
    assert resumed.state.step == whole.state.step == 24
    _leaves_equal(tckpt.checkpoint.flatten(resumed.state), tckpt.checkpoint.flatten(whole.state))


# ---------------------------------------------------------------------------
# peeks
# ---------------------------------------------------------------------------


def test_peeks_read_a_jax_store_as_jax_does(jax_fitted, slices, tmp_path):
    store = str(tmp_path / "store")
    jax_fitted.save_step(store, 0)
    japi.refit(jax_fitted, slices[1], japi.RefitConfig(train_iters=5)).save_step(store, 4)
    assert api.peek_steps(store) == japi.peek_steps(store) == [0, 4]
    for step in (None, 0, 4):
        assert (api.peek_fit_config(store, step=step).to_dict()
                == japi.peek_fit_config(store, step=step).to_dict())
    flat = jax_fitted.save(str(tmp_path / "flat"))
    assert api.peek_fit_config(flat).to_dict() == japi.peek_fit_config(flat).to_dict()
    with pytest.raises(ValueError, match="format-1"):
        api.peek_fit_config(flat, step=0)


# ---------------------------------------------------------------------------
# Server.swap
# ---------------------------------------------------------------------------


def _prewarm(server, grid) -> None:
    """Raise the streaming q_max high-water mark past any later request, so
    every server of a bitwise comparison evaluates blocks of one shape: the
    CPU lane's batched matmuls may round a row differently at another
    q_max (the card's kernel does not; its twins need no prewarm)."""
    lo, hi = [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]]
    server.submit(np.random.default_rng(99).uniform(lo, hi, (1024, 2)).astype(np.float32))


def _shape(lc: dict) -> dict:
    return {
        "keys": sorted(lc),
        "swaps": lc["swaps"],
        "versions": [(sorted(v), v["version"], v["requests"], v["refit_s"] is None)
                     for v in lc["versions"]],
    }


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_swap_records_the_lifecycle_jax_records(mode, jax_fitted, slices, tmp_path):
    jnew = japi.refit(jax_fitted, slices[1], japi.RefitConfig(train_iters=10))
    jserver = japi.Server(jax_fitted)  # replicated: no mesh in-process
    old = api.FittedPSVGP.load(jax_fitted.save(str(tmp_path / "old")), device="cpu")
    new = api.refit(old, slices[1], api.RefitConfig(train_iters=10))
    tserver = api.Server(old, api.ServeConfig(mode=mode))
    q = np.asarray(slices[1].x[:16], np.float32)
    for server, model in ((jserver, jnew), (tserver, new)):
        server.submit(q)
        rec = server.swap(model, version="step-1")
        assert sorted(rec) == ["build_s", "swaps", "version"] and rec["swaps"] == 1
        server.submit(q)
        server.submit(q)
    assert _shape(tserver.lifecycle()) == _shape(jserver.lifecycle())
    assert tserver.fitted is new and tserver.lifecycle()["active_version"] == "step-1"
    assert tserver.lifecycle()["versions"][1]["build_s"] > 0
    report = tserver.stream([q, q], warm=False)
    assert report["lifecycle"]["swaps"] == 1 and report["device"] == "cpu"
    tserver.reset_stats()
    assert tserver.stats()["requests"] == 0


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_answers_after_a_swap_to_a_jax_refit_artifact_match_jax(mode, jax_fitted, slices,
                                                                tmp_path):
    jnew = japi.refit(jax_fitted, slices[1], japi.RefitConfig(train_iters=15))
    jserver = japi.Server(jax_fitted)
    jserver.swap(jnew, version=1)
    g = jnew.grid
    q = np.random.default_rng(3).uniform(
        [g.x_edges[0], g.y_edges[0]], [g.x_edges[-1], g.y_edges[-1]], (200, 2)
    ).astype(np.float32)
    wants = [jserver.submit(q)]  # JAX's Server after the same swap (replicated, ref lane)
    if mode == "sharded":  # and the JAX package's halo lane on one host
        wants.append([np.asarray(a) for a in jrouting.predict_routed(
            jnew.cache, jnew.static.cov_fn, g, jrouting.build_routing_table(g, q))])
    tserver = api.Server.from_artifact(jax_fitted.save(str(tmp_path / "old")),
                                       api.ServeConfig(mode=mode), device="cpu")
    tnew = api.FittedPSVGP.load(jnew.save(str(tmp_path / "new")), device="cpu")
    tserver.swap(tnew, version=1)
    got = tserver.submit(q)
    mean_s, var_s = blend_error_scales(tnew.cache, tnew.grid, q)
    for want in wants:
        assert tolerance_ratio(_t(got[0]), _t(want[0]), mean_s) <= 1
        assert tolerance_ratio(_t(got[1]), _t(want[1]), var_s) <= 1


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_swap_under_a_live_frontdoor_stream(mode, fitted, slices):
    """Every answer is bitwise the old model's or the new model's, the
    switch is monotone in service order, both models answered, nothing
    was shed. Fixed (8, 2) request shapes and one request a window keep
    the replicated lane's shapes equal; the sharded lane holds for any."""
    new = api.refit(fitted, slices[1], api.RefitConfig(train_iters=10))
    server = api.Server(fitted, api.ServeConfig(mode=mode, pipeline="serial"))
    rng = np.random.default_rng(5)
    lo = [fitted.grid.x_edges[0], fitted.grid.y_edges[0]]
    hi = [fitted.grid.x_edges[-1], fitted.grid.y_edges[-1]]
    pool = [rng.uniform(lo, hi, (8, 2)).astype(np.float32) for _ in range(4)]
    n_req = 24
    if mode == "sharded":
        _prewarm(server, fitted.grid)
    ref_a = [server.submit(p) for p in pool]
    served = []

    async def drive():
        loop = asyncio.get_running_loop()
        swap_done = asyncio.Event()
        state = {"completed": 0}
        fd_cfg = api.FrontDoorConfig(max_wait_ms=1.0, max_rows=8, max_request_rows=8,
                                     admission="shed")

        async def client(fd, i):
            if i >= 16:
                await swap_done.wait()
            else:
                await asyncio.sleep(0.002 * i)
            out = await fd.submit(pool[i % 4])
            state["completed"] += 1
            served.append((i, out))

        async def swapper():
            while state["completed"] < 6:
                await asyncio.sleep(0.001)
            await loop.run_in_executor(None, lambda: server.swap(new, version="step-1"))
            swap_done.set()

        async with api.FrontDoor(server, fd_cfg) as fd:
            await asyncio.gather(swapper(), *(client(fd, i) for i in range(n_req)))
        return fd.report()

    rep = asyncio.run(drive())
    assert rep["requests"]["shed"] == 0 and rep["requests"]["completed"] == n_req
    ref_b = [server.submit(p) for p in pool]
    labels = []
    for i, out in served:
        ra, rb = ref_a[i % 4], ref_b[i % 4]
        if np.array_equal(out[0], ra[0]) and np.array_equal(out[1], ra[1]):
            labels.append("A")
        elif np.array_equal(out[0], rb[0]) and np.array_equal(out[1], rb[1]):
            labels.append("B")
        else:
            labels.append("?")
    assert "?" not in labels, "an answer matched neither model bitwise"
    assert "A" in labels and "B" in labels
    assert labels == sorted(labels), labels
    lc = rep["lifecycle"]
    assert lc["swaps"] == 1 and lc["active_version"] == "step-1"
    assert lc["versions"][0]["requests"] > 0 and lc["versions"][1]["requests"] > 0


@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_swap_from_on_result_lands_on_the_next_routed_request(pipeline, fitted, slices):
    """The in-situ loop's trigger: a swap from ``on_result(i)`` answers
    request i + 1 by the new model in the serial loop and i + 2 in the
    pipelined one (i + 1 was routed before ``on_result(i)`` ran)."""
    new = api.refit(fitted, slices[1], api.RefitConfig(train_iters=10))
    server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline=pipeline))
    rng = np.random.default_rng(9)
    lo = [fitted.grid.x_edges[0], fitted.grid.y_edges[0]]
    hi = [fitted.grid.x_edges[-1], fitted.grid.y_edges[-1]]
    batches = [rng.uniform(lo, hi, (64, 2)).astype(np.float32) for _ in range(8)]
    outs = {}

    def on_result(i, out):
        outs[i] = out
        if i == 2:
            server.swap(new, version=1)

    old_s = api.Server(fitted, api.ServeConfig(mode="sharded"))
    new_s = api.Server(new, api.ServeConfig(mode="sharded"))
    for srv in (server, old_s, new_s):
        _prewarm(srv, fitted.grid)
    server.reset_stats()
    server.stream(batches, on_result=on_result)
    first_new = 3 if pipeline == "serial" else 4
    for i, q in enumerate(batches):
        want = (new_s if i >= first_new else old_s).submit(q)
        assert np.array_equal(outs[i][0], want[0]) and np.array_equal(outs[i][1], want[1]), i
    lc = server.lifecycle()  # version 0 also served the prewarm and the stream's warm pass
    assert [v["requests"] for v in lc["versions"]] == [2 + first_new, 8 - first_new]
    # the stream's warm pass, the swap's probe (counted, as in the JAX
    # package) and the 8 requests
    assert server.stats()["requests"] == 1 + 1 + 8


def test_sharded_swap_refuses_a_grid_change(fitted, slices):
    bigger = api.fit(api.FitConfig(grid=3, m=4, train_iters=5), slices[1], device="cpu")
    sharded = api.Server(fitted, api.ServeConfig(mode="sharded"))
    with pytest.raises(ValueError, match="grid side"):
        sharded.swap(bigger)
    assert sharded.lifecycle()["swaps"] == 0 and sharded.fitted is fitted
    replicated = api.Server(fitted)  # replicated: a grid change is allowed
    replicated.swap(bigger)
    assert replicated.fitted is bigger


def test_store_steps_serve_what_the_in_memory_versions_serve(fitted, slices, tmp_path):
    store = str(tmp_path / "store")
    versions = [fitted]
    fitted.save_step(store, 0)
    for t in (1, 2):
        versions.append(api.refit(versions[-1], slices[t % 2], api.RefitConfig(train_iters=8)))
        versions[-1].save_step(store, t)
    assert api.peek_steps(store) == [0, 1, 2]
    q = np.asarray(slices[0].x[:50], np.float32)
    for t, model in enumerate(versions):
        a = api.Server(model, api.ServeConfig(mode="sharded")).submit(q)
        b = api.Server.from_artifact(store, api.ServeConfig(mode="sharded"), step=t,
                                     device="cpu").submit(q)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), t


def test_stats_count_every_request_routed_from_many_threads(fitted):
    """The route stages of the FrontDoor's dispatch thread and a swap's
    probe count into one table: concurrent routes lose no update."""
    import sys
    import threading

    server = api.Server(fitted, api.ServeConfig(mode="sharded"))
    route, _, _ = server.request_stages()
    q = np.asarray([[fitted.grid.x_edges[0], fitted.grid.y_edges[0]]], np.float32)
    n_threads, n_each = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [route(q) for _ in range(n_each)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert server.stats()["requests"] == n_threads * n_each
    assert server.lifecycle()["versions"][0]["requests"] == n_threads * n_each
