"""The port's training slice against the JAX package, on the CPU.

Same seeded numpy inputs through both packages, at a small size (grid 2-3,
a few hundred points, B = 8, m <= 6):

  * likelihoods, ``q_f``, ``kl_to_prior`` and the ELBO, whitened or not,
    gaussian or poisson, each port lane (``use_pallas`` both ways) against
    the same JAX lane;
  * ONE SGD step by injection: a JAX ``PSVGPState`` carried over with
    ``psvgp.state_from_numpy`` and the JAX step's own draws (the sampler
    under the step's folded key) fed into the port's step — loss, Adam
    moments (hence gradients) and new params agree, for both comm modes.
    The port's counter-based draws cannot reproduce threefry's bits, so
    this is how training parity is tested (with the counters as host ints
    and as the device tensors a captured step holds);
  * the port's own sampler: the same distributions, and counter-based
    draws that are a function of (seed, step) (an int or a device counter)
    with SplitMix64's bits;
  * routing tables, partitioning and boundary probes bitwise; the metrics
    on the committed artifact; a port-saved artifact loading and serving
    in the JAX package; refit(scratch) == fit bitwise; no silent CPU.

Tolerances: values 1e-5 relative (float32, different summation order);
gradients 1e-4 of the largest entry of each leaf.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import metrics as jmetrics
from repro.core import neighbors as jneighbors
from repro.core import partition as jpartition
from repro.core import psvgp as jpsvgp
from repro.core import sampler as jsampler
from repro.core import svgp as jsvgp
from repro.data.spatial import e3sm_like_field
from repro.gp import covariances as jcov
from repro.gp import likelihoods as jlik
from repro_torch import api
from repro_torch.api.fitted import _psvgp_config
from repro_torch.checkpoint import packb
from repro_torch.core import metrics, neighbors, partition, posterior, psvgp, sampler, svgp
from repro_torch.core.blend import blend_error_scales
from repro_torch.gp import covariances as tcov
from repro_torch.gp import likelihoods as tlik
from repro_torch.kernels import launches, svgp_proj
from repro_torch.kernels.ref import tolerance_ratio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "psvgp_e3sm")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny batched ops on a many-thread CPU pool pay a large fork cost
    (torch.tril: ~8 ms a call at 8 threads, 7 us at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(tree) -> dict[str, np.ndarray]:
    """A JAX pytree as ``{pytree-path: ndarray}`` (the checkpoint keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(
            str(e.key) if isinstance(e, jax.tree_util.DictKey)
            else (e.name if isinstance(e, jax.tree_util.GetAttrKey) else str(e.idx))
            for e in path
        )
        out[key] = np.asarray(leaf)
    return out


def _close(got, want, rtol=1e-5, atol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# likelihoods, q_f, KL, ELBO
# ---------------------------------------------------------------------------


def test_likelihoods_match_jax():
    rng = np.random.default_rng(0)
    fmean = rng.normal(0, 9, 64).astype(np.float32)  # some beyond the cap of 15
    fvar = rng.uniform(0.01, 4, 64).astype(np.float32)
    y = rng.poisson(3, 64).astype(np.float32)
    lb = np.float32(0.7)
    got = tlik.gaussian_expected_loglik(*map(torch.as_tensor, (y, fmean, fvar, lb)))
    _close(got, jlik.gaussian_expected_loglik(y, fmean, fvar, lb))
    got = tlik.poisson_expected_loglik(*map(torch.as_tensor, (y, fmean, fvar)))
    _close(got, jlik.poisson_expected_loglik(y, fmean, fvar), rtol=2e-5)
    assert (fmean + 0.5 * fvar > 15).any()


def test_poisson_quadrature_matches_jax_and_the_closed_form():
    """The JAX package's check (tests/test_likelihoods.py): the closed form
    against its quadrature within 1e-3, on the port; the quadrature against
    the JAX one within float32 rounding."""
    rng = np.random.default_rng(0)
    fmean = rng.normal(0, 1, 50).astype(np.float32)
    fvar = rng.uniform(0.01, 0.5, 50).astype(np.float32)
    y = rng.poisson(np.exp(fmean)).astype(np.float32)
    args = tuple(map(torch.as_tensor, (y, fmean, fvar)))
    quad = tlik.poisson_expected_loglik_quadrature(*args)
    _close(quad, jlik.poisson_expected_loglik_quadrature(y, fmean, fvar), rtol=1e-5, atol=1e-5)
    _close(tlik.poisson_expected_loglik(*args), quad.numpy(), rtol=1e-3, atol=1e-3)


def _model(rng, P: int, m: int, B: int):
    """Seeded P-stacked SVGP params (non-trivial S and m_star) and a batch."""
    z = rng.uniform(0, 2, (P, m, 2)).astype(np.float32)
    params = dict(
        m_star=rng.normal(0, 1, (P, m)).astype(np.float32),
        s_tril=(0.3 * np.tril(rng.normal(size=(P, m, m)))).astype(np.float32),
        z=z,
        log_lengthscale=np.log(rng.uniform(0.6, 1.4, (P, 2))).astype(np.float32),
        log_variance=rng.normal(0, 0.3, P).astype(np.float32),
        log_beta=rng.normal(1, 0.3, P).astype(np.float32),
    )
    x = rng.uniform(0, 2, (P, B, 2)).astype(np.float32)
    y = rng.poisson(2, (P, B)).astype(np.float32)
    mask = (rng.uniform(size=(P, B)) < 0.8).astype(np.float32)
    return params, x, y, mask


def _jparams(p, i):
    return jsvgp.SVGPParams(
        m_star=jnp.asarray(p["m_star"][i]), s_tril=jnp.asarray(p["s_tril"][i]),
        z=jnp.asarray(p["z"][i]),
        cov=jcov.CovarianceParams(jnp.asarray(p["log_lengthscale"][i]),
                                  jnp.asarray(p["log_variance"][i])),
        log_beta=jnp.asarray(p["log_beta"][i]),
    )


def _tparams(p):
    return svgp.SVGPParams(
        m_star=torch.as_tensor(p["m_star"]), s_tril=torch.as_tensor(p["s_tril"]),
        z=torch.as_tensor(p["z"]),
        cov=tcov.CovarianceParams(torch.as_tensor(p["log_lengthscale"]),
                                  torch.as_tensor(p["log_variance"])),
        log_beta=torch.as_tensor(p["log_beta"]),
    )


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel-lane"])
@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
@pytest.mark.parametrize("whitened", [False, True], ids=["std", "whitened"])
def test_q_f_kl_and_elbo_match_jax(whitened, likelihood, use_pallas):
    rng = np.random.default_rng(7)
    P, m, B = 2, 5, 8
    p, x, y, mask = _model(rng, P, m, B)
    tp = _tparams(p)
    kw = dict(jitter=1e-5, whitened=whitened, use_pallas=use_pallas)
    fmean, fvar = svgp.q_f(tp, tcov.rbf, torch.as_tensor(x), **kw)
    kl = svgp.kl_to_prior(tp, tcov.rbf, 1e-5, whitened)
    n_eff = np.array([40.0, 13.0], np.float32)
    weight = np.array([1.0, 0.5], np.float32)
    elbo = svgp.elbo(tp, tcov.rbf, torch.as_tensor(x), torch.as_tensor(y),
                     mask=torch.as_tensor(mask), n_total=torch.as_tensor(n_eff),
                     ll_weight=torch.as_tensor(weight), likelihood=likelihood, **kw)
    for i in range(P):
        jp = _jparams(p, i)
        jm, jv = jsvgp.q_f(jp, jcov.rbf, jnp.asarray(x[i]), **kw)
        _close(fmean[i], jm, what="fmean")
        _close(fvar[i], jv, what="fvar")
        _close(kl[i], jsvgp.kl_to_prior(jp, jcov.rbf, 1e-5, whitened), what="kl")
        je = jsvgp.elbo(jp, jcov.rbf, jnp.asarray(x[i]), jnp.asarray(y[i]),
                        mask=jnp.asarray(mask[i]), n_total=n_eff[i], ll_weight=weight[i],
                        likelihood=likelihood, **kw)
        _close(elbo[i], je, rtol=2e-5, what="elbo")


# ---------------------------------------------------------------------------
# one SGD step by injection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _small_problem(grid: int = 3, n: int = 400, seed: int = 0):
    ds = e3sm_like_field(n=n, seed=seed)
    g = jpartition.make_grid(ds.x, grid, grid)
    return ds, g


def _jax_setup(comm: str, use_pallas: bool, warm_steps: int = 3, m: int = 5, grid: int = 3,
               n: int = 400, jitter: float = 1e-5):
    ds, g = _small_problem(grid, n)
    cfg = jpsvgp.PSVGPConfig(
        svgp=jsvgp.SVGPConfig(num_inducing=m, input_dim=2, use_pallas=use_pallas, jitter=jitter),
        delta=0.25, batch_size=8, learning_rate=0.05, comm=comm, seed=0,
    )
    data = jpartition.partition_data(ds.x, ds.y, g)
    static = jpsvgp.build(cfg, data)
    state = jpsvgp.init(jax.random.PRNGKey(0), cfg, data)
    state = jpsvgp.fit(static, state, data, warm_steps)  # non-zero Adam moments
    return ds, g, cfg, data, static, state


def _port_twin(ds, g, cfg, state):
    tgrid = partition.PartitionGrid(g.gx, g.gy, g.x_edges, g.y_edges, g.wrap_x)
    tdata = partition.partition_data(ds.x, ds.y, tgrid)
    tcfg = psvgp.PSVGPConfig(
        svgp=svgp.SVGPConfig(**cfg.svgp._asdict()), delta=cfg.delta, batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate, comm=cfg.comm, seed=cfg.seed,
    )
    tstatic = psvgp.build(tcfg, tdata)
    tstate = psvgp.state_from_numpy(_flatten(state), "cpu")
    return tdata, tstatic, tstate


def _assert_states_agree(tstate, jstate, param_atol: float = 1e-5):
    """Params to ``param_atol`` (1e-5 unless a caller says otherwise); the
    Adam moments (which carry the step's gradient:
    mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2) to 1e-4 of each
    leaf's largest entry, float32 gradients summed in another order."""
    want = _flatten(jstate)
    got = _flatten_port(tstate)
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key.startswith(("opt/mu", "opt/nu")):
            scale = max(float(np.abs(w).max()), 1e-30)
            _close(got[key], w, rtol=2e-4, atol=1e-4 * scale, what=key)
        else:
            _close(got[key], w, rtol=1e-5, atol=param_atol, what=key)


def _flatten_port(state: psvgp.PSVGPState) -> dict[str, np.ndarray]:
    from repro_torch.checkpoint.checkpoint import flatten

    out = flatten({"params": state.params, "opt": {"mu": state.opt.mu, "nu": state.opt.nu}})
    out["opt/step"] = np.asarray(state.opt.step)
    out["step"] = np.asarray(state.step)
    return out


@pytest.mark.parametrize("comm,use_pallas", [("gather", False), ("ppermute", False),
                                             ("gather", True)])
def test_one_step_by_injection_matches_jax(comm, use_pallas):
    step_by_injection(comm, use_pallas)


@pytest.mark.parametrize("comm", ["gather", "ppermute"])
def test_one_step_with_device_counters_matches_jax(comm):
    """The counters as the captured step holds them (int64 tensors, Adam's
    bias corrections computed from the tensor) give the same step."""
    step_by_injection(comm, False, device_counters=True)


def step_by_injection(comm: str, use_pallas: bool, param_atol: float = 1e-5,
                      device_counters: bool = False, **setup) -> None:
    """One SGD step of the JAX package and of the port from the same state,
    the port fed the JAX step's draws; states held to each other as in
    :func:`_assert_states_agree`. ``setup`` goes to :func:`_jax_setup`;
    ``device_counters`` carries the port's counters as int64 tensors."""
    ds, g, cfg, data, static, state = _jax_setup(comm, use_pallas, **setup)
    tdata, tstatic, tstate = _port_twin(ds, g, cfg, state)
    if device_counters:
        tstate = psvgp.device_counters(tstate, tdata.x.device)
    key = jax.random.PRNGKey(cfg.seed)
    k1, k2 = jax.random.split(jax.random.fold_in(key, state.step))
    B = cfg.batch_size
    if comm == "gather":
        kprime, _ = jsampler.sample_slots(k1, static.dist)
        idx, _ = jsampler.sample_minibatch_indices(k2, jnp.take(data.mask, kprime, axis=0), B)
        new, loss = jpsvgp.train_step(static, state, key, data)
        got, tloss = psvgp.train_step_gather(
            tstate, 0, tdata.x, tdata.y, tdata.mask, tstatic.dist, tstatic.cfg, tstatic.cov_fn,
            draws=(torch.as_tensor(np.asarray(kprime)).long(),
                   torch.as_tensor(np.asarray(idx)).long()),
        )
    else:
        d = jax.random.categorical(k1, jnp.log(jnp.maximum(static.p_dir, 1e-30)))
        idx, _ = jsampler.sample_minibatch_indices(k2, data.mask, B)
        new, loss = jpsvgp.train_step(static, state, key, data)
        got, tloss = psvgp.train_step_ppermute(
            tstate, 0, tdata.x, tdata.y, tdata.mask, tstatic.dist, tstatic.perms,
            tstatic.p_dir, tstatic.cfg, tstatic.cov_fn,
            draws=(torch.as_tensor(np.asarray(d)).long(), torch.as_tensor(np.asarray(idx)).long()),
        )
    assert int(got.step) == int(new.step) == int(state.step) + 1
    assert int(got.opt.step) == int(new.opt.step)
    _close(tloss, loss, rtol=1e-5, what="loss")
    _assert_states_agree(got, new, param_atol)


def test_state_from_numpy_round_trips_the_jax_state():
    *_, state = _jax_setup("gather", False, warm_steps=1)
    arrays = _flatten(state)
    back = _flatten_port(psvgp.state_from_numpy(arrays, "cpu"))
    assert back.keys() == arrays.keys()
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)


# ---------------------------------------------------------------------------
# the port's own sampler
# ---------------------------------------------------------------------------


def test_port_sampler_draws_the_jax_distributions():
    ds, g = _small_problem()
    tgrid = partition.PartitionGrid(g.gx, g.gy, g.x_edges, g.y_edges, g.wrap_x)
    tdata = partition.partition_data(ds.x, ds.y, tgrid)
    tbl = torch.as_tensor(neighbors.neighbor_table(tgrid))
    dist = sampler.slot_distribution(tdata.counts, tbl, 0.5)
    jdist = jsampler.slot_distribution(
        jnp.asarray(tdata.counts.numpy()), jnp.asarray(tbl.numpy()), 0.5)
    _close(dist.probs, jdist.probs, rtol=1e-6, atol=1e-7)
    _close(dist.n_eff, jdist.n_eff, rtol=1e-6)
    gen = sampler.StepDraws(0, 0, torch.device("cpu"))
    draws = torch.stack([sampler.sample_slots(gen, dist)[1] for _ in range(4000)])
    freq = torch.stack([(draws == s).float().mean(0) for s in range(5)], dim=1)
    assert float((freq - dist.probs).abs().max()) < 0.035  # ~4.5 sigma at 4,000 draws
    # rows: a uniform draw without replacement; never a padded row while a
    # valid one is left
    counts = tdata.counts.numpy()
    idx, valid = sampler.sample_minibatch_indices(gen, tdata.mask, 8)
    for p in range(tdata.num_partitions):
        rows = idx[p].numpy()
        assert len(set(rows)) == 8
        assert int(valid[p].sum()) == min(8, counts[p])
        assert (rows[valid[p].numpy() > 0] < counts[p]).all()
    hits = torch.zeros(tdata.n_max)
    for _ in range(500):
        hits[sampler.sample_row_indices(gen, tdata.mask[0], 8)[0]] += 1
    n0 = int(counts[0])
    assert hits[n0:].sum() == 0
    expect = 500 * 8 / n0
    assert float((hits[:n0] - expect).abs().max()) < 6 * np.sqrt(expect)


def test_port_step_stream_depends_on_seed_and_step_only():
    ds, g = _small_problem()
    tgrid = partition.PartitionGrid(g.gx, g.gy, g.x_edges, g.y_edges, g.wrap_x)
    mask = partition.partition_data(ds.x, ds.y, tgrid).mask
    cpu = torch.device("cpu")

    def batch(seed, step):
        return sampler.sample_minibatch_indices(sampler.StepDraws(seed, step, cpu), mask, 8)[0]

    assert torch.equal(batch(0, 5), batch(0, 5))
    assert not torch.equal(batch(0, 5), batch(0, 6))
    assert not torch.equal(batch(0, 5), batch(1, 5))
    assert sampler.stream_seed(0, "init") != sampler.stream_seed(0, "step", 0)
    # a counter held in a device tensor (what a captured step reads) draws
    # what the host int draws; successive draws of a step differ
    counter = torch.full((), 5, dtype=torch.int64)
    assert torch.equal(
        sampler.sample_minibatch_indices(sampler.StepDraws(0, counter, cpu), mask, 8)[0],
        batch(0, 5))
    rand = sampler.StepDraws(0, 5, cpu)
    assert not torch.equal(rand.uniform((64,)), rand.uniform((64,)))
    # the bits: SplitMix64 outputs, so the CPU and the card draw the same
    # numbers (int64 multiplies wrap the same way on both)
    full = (1 << 64) - 1

    def splitmix(z):
        z &= full
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & full
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & full
        return z ^ (z >> 31)

    golden = 0x9E3779B97F4A7C15
    start = splitmix(5 * golden + sampler.stream_seed(7, "step"))
    start += 0xD1B54A32D192ED03  # the step's second draw
    want = [(splitmix(start + i * golden) >> 40) / 2**24 for i in range(1, 33)]
    rand = sampler.StepDraws(7, 5, cpu)
    rand.uniform((3,))
    assert rand.uniform((4, 8)).flatten().tolist() == want


# ---------------------------------------------------------------------------
# routing tables, partitioning, probes, metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gx,gy,wrap", [(3, 3, False), (4, 2, True), (1, 5, False)])
def test_tables_partitioning_and_probes_equal_jax_bitwise(gx, gy, wrap):
    ds = e3sm_like_field(n=500, seed=gx + gy)
    jg = jpartition.make_grid(ds.x, gx, gy, wrap_x=wrap)
    tg = partition.make_grid(ds.x, gx, gy, wrap_x=wrap)
    assert np.array_equal(jg.x_edges, tg.x_edges) and np.array_equal(jg.y_edges, tg.y_edges)
    assert np.array_equal(jneighbors.neighbor_table(jg), neighbors.neighbor_table(tg))
    assert np.array_equal(jneighbors.direction_permutations(jg),
                          neighbors.direction_permutations(tg))
    for n_max in (None, 24):
        jd = jpartition.partition_data(ds.x, ds.y, jg, n_max=n_max)
        td = partition.partition_data(ds.x, ds.y, tg, n_max=n_max)
        for name in ("x", "y", "mask", "counts"):
            assert np.array_equal(np.asarray(getattr(jd, name)),
                                  getattr(td, name).numpy()), (name, n_max)
    if gx * gy > 1:
        jp, tp = jneighbors.boundary_probes(jg, 7), neighbors.boundary_probes(tg, 7)
        for name in ("points", "left", "right"):
            assert np.array_equal(np.asarray(getattr(jp, name)), getattr(tp, name)), name


def test_metrics_on_the_committed_artifact_equal_jax():
    jf = japi.FittedPSVGP.load(FIXTURE)
    tf = api.FittedPSVGP.load(FIXTURE, device="cpu")
    ds = e3sm_like_field(n=48602, seed=0)
    jd = jpartition.partition_data(ds.x, ds.y, jf.grid)
    td = partition.partition_data(ds.x, ds.y, tf.grid)
    jprobes = jneighbors.boundary_probes(jf.grid, 23)
    tprobes = neighbors.boundary_probes(tf.grid, 23)
    want = {
        "rmspe": jmetrics.rmspe(jf.static, jf.state, jd, cache=jf.cache),
        "rmsd": jmetrics.boundary_rmsd(jf.static, jf.state, jprobes, cache=jf.cache),
        "per": jmetrics.per_partition_rmspe(jf.static, jf.state, jd, cache=jf.cache),
        "hold": jmetrics.holdout_rmspe(jf.static, jf.state, jd.x[:, :16], jd.y[:, :16],
                                       jd.mask[:, :16], cache=jf.cache),
    }
    got = {
        "rmspe": metrics.rmspe(tf.static, tf.state, td, cache=tf.cache),
        "rmsd": metrics.boundary_rmsd(tf.static, tf.state, tprobes),
        "per": metrics.per_partition_rmspe(tf.static, tf.state, td, cache=tf.cache),
        "hold": metrics.holdout_rmspe(tf.static, tf.state, td.x[:, :16], td.y[:, :16],
                                      td.mask[:, :16], cache=tf.cache),
    }
    for key in want:
        # the fitted means cancel (sum_j |k_j c_j| ~ 3e3): 1e-4 relative
        _close(got[key], want[key], rtol=1e-4, atol=1e-6, what=key)
    assert 0.04 < float(got["rmspe"]) < 0.08 and 0.04 < float(got["rmsd"]) < 0.09


# ---------------------------------------------------------------------------
# the artifact round trip, the lifecycle, the device rule
# ---------------------------------------------------------------------------


def test_port_saved_artifact_loads_and_serves_in_jax(tmp_path):
    ds = e3sm_like_field(n=300, seed=2)
    cfg = api.FitConfig(grid=2, m=4, train_iters=30, batch_size=8, seed=1)
    fitted = api.fit(cfg, ds, device="cpu")
    # the factors are row-major: the CUDA serving kernels take nothing else
    assert all(t.is_contiguous() for t in posterior.cache_leaves(fitted.cache))
    path = fitted.save(str(tmp_path / "art"))
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        raw = f.read()
    manifest = msgpack.unpackb(raw)
    assert raw == msgpack.packb(manifest)
    assert manifest["keys"][0] == "cache/z" and "params/log_beta" in manifest["keys"]
    jf = japi.FittedPSVGP.load(path)
    q = np.random.default_rng(0).uniform(
        [fitted.grid.x_edges[0], fitted.grid.y_edges[0]],
        [fitted.grid.x_edges[-1], fitted.grid.y_edges[-1]], (64, 2)).astype(np.float32)
    jm, jv = jf.predict(q)
    tm, tv = fitted.predict(q)
    mean_s, var_s = blend_error_scales(fitted.cache, fitted.grid, q)
    assert tolerance_ratio(tm, torch.as_tensor(np.asarray(jm)), mean_s) <= 1
    assert tolerance_ratio(tv, torch.as_tensor(np.asarray(jv)), var_s) <= 1
    back = api.FittedPSVGP.load(path, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.cache[:4], fitted.cache[:4], strict=True))
    bm, bv = back.predict(q)
    assert torch.equal(bm, tm) and torch.equal(bv, tv)


def test_packb_matches_msgpack_across_size_classes():
    for obj in (
        {"keys": ["a" * n for n in (0, 31, 32, 255, 256, 70000)]},
        {"shapes": [[], [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32], [7] * 20]},
        {str(i): [i] * (i % 3) for i in range(20)},
        {"keys": [], "dtypes": ["float32"] * 70000},
    ):
        assert packb(obj) == msgpack.packb(obj)
    # the codec grew floats, negative ints, bytes, None and bools for the
    # wire frames (tests/test_torch_net.py); a set has no msgpack form
    assert packb({"x": -1.5}) == msgpack.packb({"x": -1.5})
    with pytest.raises(TypeError):
        packb({"x": {1, 2}})


def test_refit_scratch_equals_fit_bitwise_and_warm_continues_the_stream():
    a = e3sm_like_field(n=300, seed=0)
    b = e3sm_like_field(n=300, seed=1)
    cfg = api.FitConfig(grid=2, m=4, train_iters=25, batch_size=8, seed=0)
    fitted = api.fit(cfg, a, device="cpu")
    again = api.fit(cfg, b, device="cpu")
    scratch = api.refit(fitted, b, api.RefitConfig(train_iters=25, init="scratch"))
    same = zip(_flatten_port(scratch.state).values(), _flatten_port(again.state).values(),
               strict=True)
    assert all(np.array_equal(x, y) for x, y in same)
    warm = api.refit(fitted, b, api.RefitConfig(train_iters=5))
    assert warm.state.step == 30 and warm.state.opt.step == 30
    assert not torch.equal(warm.params.m_star, scratch.params.m_star)
    reset = api.refit(fitted, b, api.RefitConfig(train_iters=5, reset_optimizer=True,
                                                 learning_rate=0.01))
    assert reset.state.opt.step == 5 and reset.state.step == 30
    assert reset.config.learning_rate == 0.01 and reset.config.train_iters == 5
    assert torch.equal(fitted.params.m_star, api.fit(cfg, a, device="cpu").params.m_star)


def test_refit_of_a_loaded_artifact_reinitializes_the_optimizer(tmp_path):
    ds = e3sm_like_field(n=300, seed=3)
    fitted = api.fit(api.FitConfig(grid=2, m=4, train_iters=10, batch_size=8), ds, device="cpu")
    loaded = api.FittedPSVGP.load(fitted.save(str(tmp_path / "a")), device="cpu")
    assert loaded.state.opt.mu is None and loaded.static.dist is None
    warm = api.refit(loaded, ds, api.RefitConfig(train_iters=3))
    assert warm.state.opt.step == 3 and np.isfinite(warm.params.m_star.numpy()).all()


def test_fit_config_routes_the_projection_kernel_on_cuda_rbf_only():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _psvgp_config(api.FitConfig(), cuda).svgp.use_pallas
    assert not _psvgp_config(api.FitConfig(), cpu).svgp.use_pallas
    assert not _psvgp_config(api.FitConfig(covariance="matern32"), cuda).svgp.use_pallas
    assert api.RefitConfig.from_json(api.RefitConfig(init="scratch").to_json()).init == "scratch"
    with pytest.raises(ValueError, match="init"):
        api.RefitConfig(init="hot")


def test_fit_without_a_device_refuses_a_machine_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = e3sm_like_field(n=100, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.fit(api.FitConfig(grid=2, m=3, train_iters=1), ds)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fit_launches_the_projection_kernel_once_per_step(cuda_device):
    ds = e3sm_like_field(n=2000, seed=0)
    cfg = api.FitConfig(grid=4, m=5, train_iters=40, batch_size=16)
    launches.reset()
    fitted = api.fit(cfg, ds)
    assert svgp_proj.LAUNCHES["svgp_projection"] == 40
    assert fitted.device.type == "cuda"
    again = api.refit(fitted, ds, api.RefitConfig(train_iters=40, init="scratch"))
    assert all(torch.equal(x, y) for x, y in zip(fitted.params[:3], again.params[:3], strict=True))
