"""The port's covariances and cached-posterior layer against the JAX
package, on the same seeded numpy inputs (CPU, float32).

Tolerances: covariance matrices rtol 1e-5 / atol 1e-6; cache leaves
|d| <= 1e-4 max(1, max|leaf|) on well-conditioned Kmm (cond < 1e3, so
float32 solves agree to ~1e-4 relative); predictions through
``ref.tolerance_ratio`` (1e-5 of the magnitude of the summed terms).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posterior as jpost
from repro.core import svgp as jsvgp
from repro.gp import covariances as jcov
from repro_torch.core import posterior, svgp
from repro_torch.gp import covariances as tcov
from repro_torch.kernels import ref

COVS = ("rbf", "matern32", "matern52", "periodic_lon_rbf")


def _params_np(rng, P: int | None, m: int = 5, d: int = 2) -> dict:
    """Seeded SVGP params; inducing points on a jittered grid so Kmm is
    well conditioned."""
    lead = () if P is None else (P,)
    side = int(np.ceil(np.sqrt(m)))
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2)[:m]
    z = 0.8 * g + rng.uniform(-0.1, 0.1, lead + (m, d))
    return {
        "m_star": rng.normal(0, 1, lead + (m,)),
        "s_tril": rng.normal(0, 0.3, lead + (m, m)),
        "z": z,
        "log_lengthscale": np.log(rng.uniform(0.4, 0.6, lead + (d,))),
        "log_variance": rng.normal(0, 0.3, lead),
        "log_beta": rng.normal(2, 0.3, lead),
    }


def _jparams(p):
    a = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in p.items()}
    return jsvgp.SVGPParams(
        m_star=a["m_star"], s_tril=a["s_tril"], z=a["z"],
        cov=jcov.CovarianceParams(a["log_lengthscale"], a["log_variance"]),
        log_beta=a["log_beta"],
    )


def _tparams(p):
    a = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in p.items()}
    return svgp.SVGPParams(
        m_star=a["m_star"], s_tril=a["s_tril"], z=a["z"],
        cov=tcov.CovarianceParams(a["log_lengthscale"], a["log_variance"]),
        log_beta=a["log_beta"],
    )


def _leaves_j(cache):
    return [np.asarray(a) for a in jax.tree.leaves(cache)]


def _assert_leaves_close(tc, jc):
    for got, want in zip(posterior.cache_leaves(tc), _leaves_j(jc), strict=True):
        assert got.shape == want.shape
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _tcache_from_j(jc) -> posterior.PosteriorCache:
    t = [torch.as_tensor(np.array(a)) for a in jax.tree.leaves(jc)]
    return posterior.PosteriorCache(
        z=t[0], w=t[1], u=t[2], c=t[3], cov=tcov.CovarianceParams(t[4], t[5]), log_beta=t[6]
    )


@pytest.mark.parametrize("name", COVS)
def test_covariances_match_jax_single_and_batched(name):
    rng = np.random.default_rng(0)
    p = _params_np(rng, 3, m=6)
    x = rng.uniform(0, 3, (3, 7, 2)).astype(np.float32)
    tf, jf = tcov.make_covariance(name), jcov.make_covariance(name)
    tp, jp = _tparams(p), _jparams(p)
    got = tf(tp.cov, torch.as_tensor(x), tp.z).numpy()
    want = np.asarray(jax.vmap(jf)(jp.cov, jnp.asarray(x), jp.z))
    assert got.shape == (3, 7, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    one = tf(tcov.CovarianceParams(tp.cov.log_lengthscale[0], tp.cov.log_variance[0]),
             torch.as_tensor(x[0]), tp.z[0]).numpy()
    np.testing.assert_allclose(one, want[0], rtol=1e-5, atol=1e-6)
    kd = tcov.kdiag(tp.cov, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(kd, np.asarray(jax.vmap(jcov.kdiag)(jp.cov, jnp.asarray(x))))
    with pytest.raises(ValueError, match="unknown covariance"):
        tcov.make_covariance("linear")


def test_s_chol_matches_jax():
    s = np.random.default_rng(1).normal(0, 1, (4, 5, 5)).astype(np.float32)
    got = posterior.s_chol(torch.as_tensor(s)).numpy()
    want = np.asarray(jax.vmap(jpost.s_chol)(jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("whitened", [False, True])
def test_build_cache_and_stacked_match_jax(whitened):
    rng = np.random.default_rng(2)
    p1, pP = _params_np(rng, None), _params_np(rng, 4)
    tc = posterior.build_cache(_tparams(p1), tcov.rbf, whitened=whitened)
    jc = jpost.build_cache(_jparams(p1), jcov.rbf, whitened=whitened)
    _assert_leaves_close(tc, jc)
    tcs = posterior.build_cache_stacked(_tparams(pP), tcov.rbf, whitened=whitened)
    jcs = jpost.build_cache_stacked(_jparams(pP), jcov.rbf, whitened=whitened)
    assert tcs.w.shape == (4, 5, 5) and tcs.c.shape == (4, 5)
    _assert_leaves_close(tcs, jcs)
    with pytest.raises(ValueError, match="stacked params"):
        posterior.build_cache_stacked(_tparams(p1), tcov.rbf)


@pytest.mark.parametrize("include_noise", [False, True])
def test_predict_cached_lanes_match_jax(include_noise):
    rng = np.random.default_rng(3)
    jc = jpost.build_cache(_jparams(_params_np(rng, None)), jcov.rbf)
    tc = _tcache_from_j(jc)
    x = rng.uniform(-0.5, 2.5, (23, 2)).astype(np.float32)
    want = jpost.predict_cached(jc, jcov.rbf, jnp.asarray(x), include_noise=include_noise)
    leaves = (tc.z, tc.cov.log_lengthscale, tc.cov.log_variance, tc.w, tc.u, tc.c)
    mean_s, var_s = ref.posterior_predict_scales(torch.as_tensor(x), *leaves)
    for use_pallas in (False, True):
        got = posterior.predict_cached(
            tc, tcov.rbf, torch.as_tensor(x), include_noise=include_noise, use_pallas=use_pallas
        )
        assert ref.tolerance_ratio(got[0], torch.as_tensor(np.array(want[0])), mean_s) <= 1
        assert ref.tolerance_ratio(got[1], torch.as_tensor(np.array(want[1])), var_s) <= 1
        assert float(got[1].min()) >= 1e-12


@pytest.mark.parametrize("use_pallas", [False, True])
def test_predict_cached_stacked_matches_jax(use_pallas):
    rng = np.random.default_rng(4)
    jc = jpost.build_cache_stacked(_jparams(_params_np(rng, 3)), jcov.rbf)
    tc = _tcache_from_j(jc)
    x = rng.uniform(-0.5, 2.5, (3, 17, 2)).astype(np.float32)
    want = jpost.predict_cached_stacked(jc, jcov.rbf, jnp.asarray(x), include_noise=True)
    got = posterior.predict_cached_stacked(
        tc, tcov.rbf, torch.as_tensor(x), include_noise=True, use_pallas=use_pallas
    )
    leaves = [a[:, None] for a in (tc.z, tc.cov.log_lengthscale, tc.cov.log_variance,
                                   tc.w, tc.u, tc.c)]
    mean_s, var_s = ref.posterior_predict_scales(torch.as_tensor(x), *leaves)
    assert got[0].shape == (3, 17)
    assert ref.tolerance_ratio(got[0], torch.as_tensor(np.array(want[0])), mean_s) <= 1
    assert ref.tolerance_ratio(got[1], torch.as_tensor(np.array(want[1])), var_s) <= 1


@pytest.mark.parametrize("backend", ["ref", "pallas", "fused"])
def test_predict_cached_slots_lanes_match_jax_ref_lane(backend):
    rng = np.random.default_rng(5)
    jc = jpost.build_cache(_jparams(_params_np(rng, None)), jcov.rbf)
    tc = _tcache_from_j(jc)
    hx = rng.uniform(-0.5, 2.5, (9, 13, 2)).astype(np.float32)
    want = jpost.predict_cached_slots(jc, jcov.rbf, jnp.asarray(hx), backend="ref")
    got = posterior.predict_cached_slots(tc, tcov.rbf, torch.as_tensor(hx), backend=backend)
    leaves = (tc.z, tc.cov.log_lengthscale, tc.cov.log_variance, tc.w, tc.u, tc.c)
    mean_s, var_s = ref.posterior_predict_scales(torch.as_tensor(hx), *leaves)
    assert got[0].shape == (9, 13)
    assert ref.tolerance_ratio(got[0], torch.as_tensor(np.array(want[0])), mean_s) <= 1
    assert ref.tolerance_ratio(got[1], torch.as_tensor(np.array(want[1])), var_s) <= 1


@pytest.mark.parametrize("backend", ["ref", "pallas", "fused"])
def test_cell_axis_slots_equal_per_cell_slots(backend):
    rng = np.random.default_rng(6)
    jc = jpost.build_cache_stacked(_jparams(_params_np(rng, 4)), jcov.rbf)
    tc = _tcache_from_j(jc)
    hx = torch.as_tensor(rng.uniform(-0.5, 2.5, (4, 9, 11, 2)).astype(np.float32))
    got = posterior.predict_cached_slots_stacked(
        tc, tcov.rbf, hx, include_noise=True, backend=backend
    )
    assert got[0].shape == got[1].shape == (4, 9, 11)
    for p in range(4):
        want = jpost.predict_cached_slots(
            jax.tree.map(lambda a, p=p: a[p], jc), jcov.rbf, jnp.asarray(hx[p].numpy()),
            include_noise=True,
        )
        one = posterior.take_cache(tc, p)
        leaves = (one.z, one.cov.log_lengthscale, one.cov.log_variance, one.w, one.u, one.c)
        mean_s, var_s = ref.posterior_predict_scales(hx[p], *leaves)
        assert ref.tolerance_ratio(got[0][p], torch.as_tensor(np.array(want[0])), mean_s) <= 1
        assert ref.tolerance_ratio(got[1][p], torch.as_tensor(np.array(want[1])), var_s) <= 1


def test_resolve_slot_backend_and_take_cache():
    assert posterior.resolve_slot_backend(False, None) == "ref"
    assert posterior.resolve_slot_backend(True, None) == "fused"
    assert posterior.resolve_slot_backend(False, "pallas") == "pallas"
    with pytest.raises(ValueError, match="either use_pallas or backend"):
        posterior.resolve_slot_backend(True, "ref")
    with pytest.raises(ValueError, match="backend must be"):
        posterior.resolve_slot_backend(False, "triton")
    rng = np.random.default_rng(7)
    tc = _tcache_from_j(jpost.build_cache_stacked(_jparams(_params_np(rng, 3)), jcov.rbf))
    ids = torch.tensor([2, 0, 2])
    got = posterior.take_cache(tc, ids)
    for g, a in zip(posterior.cache_leaves(got), posterior.cache_leaves(tc), strict=True):
        assert torch.equal(g, a[ids])
