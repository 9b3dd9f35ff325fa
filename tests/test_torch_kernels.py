"""The port's prediction kernels: plain versions vs the JAX oracles, the
dispatch rule, the wrappers' refusals, the build, and (on a CUDA machine
only) each CUDA kernel against its plain version.

The plain versions (``repro_torch.kernels.ref``) are held to
``repro.kernels.ref`` — the jnp oracles, never Pallas interpret output —
on the same seeded numpy inputs. Tolerance (``ref.tolerance_ratio``):
|d| <= 1e-5 max(1, scale) per row, scale the magnitude of the terms the
output sums (sum_j |k_j c_j| for the mean, ||Wk||^2 + ||Uk||^2 for the
variance).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build, launches, ops, predict, ref


def _factors(rng, lead: tuple, m: int, d: int) -> list[np.ndarray]:
    """Seeded (z, log_l, log_v, w, u, c) with leading axes ``lead``."""
    return [
        rng.uniform(0, 2, lead + (m, d)).astype(np.float32),
        np.log(rng.uniform(0.3, 1.5, lead + (d,))).astype(np.float32),
        rng.normal(0, 0.5, lead).astype(np.float32),
        (rng.normal(0, 1, lead + (m, m)) / np.sqrt(m)).astype(np.float32),
        (rng.normal(0, 1, lead + (m, m)) / np.sqrt(m)).astype(np.float32),
        rng.normal(0, 1, lead + (m,)).astype(np.float32),
    ]


def _t(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _agrees(got, want, x, factors):
    """Both outputs within tolerance of the JAX/plain answer."""
    mean_s, fvar_s = ref.posterior_predict_scales(x, *factors)
    want = [torch.as_tensor(np.array(w)) for w in want]
    assert ref.tolerance_ratio(got[0], want[0], mean_s) <= 1
    assert ref.tolerance_ratio(got[1], want[1], fvar_s) <= 1


@pytest.mark.parametrize("m,q,d", [(1, 1, 2), (5, 37, 2), (17, 129, 3), (20, 32, 2), (64, 8, 4),
                                   (65, 37, 5), (128, 19, 5)])
def test_plain_posterior_predict_matches_jax_oracle(m, q, d):
    rng = np.random.default_rng(m * 100 + q)
    f = _factors(rng, (), m, d)
    x = rng.uniform(0, 2, (q, d)).astype(np.float32)
    got = ref.posterior_predict(*_t([x, *f]))
    want = jref.posterior_predict(*map(jnp.asarray, [x, *f]))
    assert got[0].shape == got[1].shape == (q,)
    _agrees(got, want, *_t([x]), _t(f))


@pytest.mark.parametrize("b,m,d", [(11, 7, 2), (13, 65, 5), (6, 128, 5)])
def test_plain_rbf_cross_cov_matches_jax_oracle(b, m, d):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 2, (b, d)).astype(np.float32)
    z, log_l, log_v = _factors(rng, (), m, d)[:3]
    got = ref.rbf_cross_cov(*_t([x, z, log_l, log_v]))
    want = np.asarray(jref.rbf_cross_cov(*map(jnp.asarray, [x, z, log_l, log_v])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,q,m", [(9, 32, 5), (3, 77, 10), (9, 32, 20)])
def test_plain_slots_match_jax_oracle(s, q, m):
    rng = np.random.default_rng(s * q)
    f = _factors(rng, (), m, 2)
    hx = rng.uniform(0, 2, (s, q, 2)).astype(np.float32)
    got = ref.posterior_predict_slots(*_t([hx, *f]))
    want = jref.posterior_predict_slots(*map(jnp.asarray, [hx, *f]))
    assert got[0].shape == (s, q)
    _agrees(got, want, *_t([hx]), _t(f))


def test_plain_cell_axis_slots_are_per_cell_jax_slots():
    rng = np.random.default_rng(7)
    P, S, Q, m = 4, 9, 24, 6
    f = _factors(rng, (P,), m, 2)
    hx = rng.uniform(0, 2, (P, S, Q, 2)).astype(np.float32)
    got = ref.posterior_predict_slots_stacked(*_t([hx, *f]))
    assert got[0].shape == got[1].shape == (P, S, Q)
    for p in range(P):
        fp = [a[p] for a in f]
        want = jref.posterior_predict_slots(*map(jnp.asarray, [hx[p], *fp]))
        _agrees((got[0][p], got[1][p]), want, *_t([hx[p]]), _t(fp))


@pytest.mark.parametrize("P,Q,m,d", [(4, 29, 6, 2), (3, 32, 20, 2), (3, 17, 65, 5),
                                     (2, 11, 128, 5)])
def test_cell_axis_posterior_predict_is_per_cell_calls_and_the_jax_oracle(P, Q, m, d):
    """``ops.posterior_predict`` with a leading cell axis (the "pallas"
    lane's one launch on CUDA; its plain version here) agrees with the
    single-model calls cell by cell and with a loop of the JAX oracle,
    within the tolerance above (a batched CPU matmul sums in another order
    than an unbatched one, so not bitwise; the CUDA test below is)."""
    rng = np.random.default_rng(P * Q + m)
    f = _factors(rng, (P,), m, d)
    x = rng.uniform(0, 2, (P, Q, d)).astype(np.float32)
    got = ops.posterior_predict(*_t([x, *f]))
    assert got[0].shape == got[1].shape == (P, Q)
    for p in range(P):
        fp = [a[p] for a in f]
        one = ops.posterior_predict(*_t([x[p], *fp]))
        _agrees((got[0][p], got[1][p]), one, *_t([x[p]]), _t(fp))
        want = jref.posterior_predict(*map(jnp.asarray, [x[p], *fp]))
        _agrees((got[0][p], got[1][p]), want, *_t([x[p]]), _t(fp))


@pytest.mark.parametrize("m,d", [(5, 2), (65, 5)])
def test_pallas_lane_is_its_old_per_cell_form(m, d):
    """``predict_cached_slots_stacked(backend="pallas")``, now one call over
    every cell's (S*Q, d) rows, agrees with the per-cell form it replaced
    (one single-model ``predict_cached_slots(backend="pallas")`` per cell)
    within the tolerance above: on the CPU a batched matmul sums in another
    order (the CUDA test below holds the two bitwise)."""
    from repro_torch.core import posterior
    from repro_torch.gp.covariances import CovarianceParams, rbf

    rng = np.random.default_rng(m)
    P, S, Q = 5, 9, 12
    z, log_l, log_v, w, u, c = _t(_factors(rng, (P,), m, d))
    cache = posterior.PosteriorCache(
        z=z, w=w, u=u, c=c, cov=CovarianceParams(log_lengthscale=log_l, log_variance=log_v),
        log_beta=torch.as_tensor(rng.normal(3, 0.5, P).astype(np.float32)),
    )
    hx = torch.as_tensor(rng.uniform(0, 2, (P, S, Q, d)).astype(np.float32))
    for noise in (False, True):
        got = posterior.predict_cached_slots_stacked(cache, rbf, hx, include_noise=noise,
                                                     backend="pallas")
        per_cell = [posterior.predict_cached_slots(posterior.take_cache(cache, p), rbf, hx[p],
                                                   include_noise=noise, backend="pallas")
                    for p in range(P)]
        want = [torch.stack([o[i] for o in per_cell]) for i in range(2)]
        scales = ref.posterior_predict_scales(hx, *(a[:, None] for a in (z, log_l, log_v, w, u, c)))
        assert got[0].shape == got[1].shape == (P, S, Q)
        assert ref.tolerance_ratio(got[0], want[0], scales[0]) <= 1
        assert ref.tolerance_ratio(got[1], want[1], scales[1]) <= 1


def test_plain_masked_oracle_matches_jax_and_is_row_independent():
    rng = np.random.default_rng(3)
    S, Q, m = 9, 40, 8
    f = _factors(rng, (), m, 2)
    hx = rng.uniform(0, 2, (S, Q, 2)).astype(np.float32)
    qmask = (rng.uniform(size=(S, Q)) < 0.5).astype(np.float32)
    got = ref.posterior_predict_slots_masked(*_t([hx, qmask, *f]))
    want = jref.posterior_predict_slots_masked(*map(jnp.asarray, [hx, qmask, *f]))
    _agrees(got, want, *_t([hx]), _t(f))
    junk = np.where(qmask[..., None] > 0, hx, 1e3).astype(np.float32)
    again = ref.posterior_predict_slots_masked(*_t([junk, qmask, *f]))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("q,q_big", [(16, 64), (64, 256), (32, 216)])
def test_plain_slots_rows_are_bitwise_the_same_at_any_q_max(q, q_big):
    """The CPU lanes sum every row in one fixed order: the first q rows of
    a q_big block equal the same rows of a q block bitwise (P = S = 9,
    m = 4, d = 2), through the kernel lanes' plain version and through the
    "ref" lane (``posterior.predict_cached_slots_stacked``)."""
    from repro_torch.core import posterior
    from repro_torch.gp.covariances import CovarianceParams, rbf

    rng = np.random.default_rng(q_big)
    f = _t(_factors(rng, (9,), 4, 2))
    f[5] = f[5] * 30.0  # fitted means cancel: sum_j |k_j c_j| >> |mean|
    hx = torch.as_tensor(rng.uniform(0, 2, (9, 9, q_big, 2)).astype(np.float32))
    small = hx[:, :, :q].contiguous()
    cache = posterior.PosteriorCache(z=f[0], w=f[3], u=f[4], c=f[5],
                                     cov=CovarianceParams(f[1], f[2]),
                                     log_beta=torch.zeros(9))
    for lane in (lambda x: ref.posterior_predict_slots_stacked(x, *f),
                 lambda x: posterior.predict_cached_slots_stacked(cache, rbf, x)):
        big_out, small_out = lane(hx), lane(small)
        for b, a in zip(big_out, small_out, strict=True):
            assert torch.equal(b[:, :, :q], a)


def test_cpu_tensors_dispatch_to_the_plain_versions_without_launching():
    rng = np.random.default_rng(5)
    f = _t(_factors(rng, (), 5, 2))
    fp = _t(_factors(rng, (3,), 5, 2))
    x = torch.as_tensor(rng.uniform(0, 2, (9, 2)).astype(np.float32))
    hx = torch.as_tensor(rng.uniform(0, 2, (4, 9, 2)).astype(np.float32))
    hxp = torch.as_tensor(rng.uniform(0, 2, (3, 4, 9, 2)).astype(np.float32))
    launches.reset()
    for got, want in (
        (ops.posterior_predict(x, *f), ref.posterior_predict(x, *f)),
        (ops.posterior_predict_slots(hx, *f), ref.posterior_predict_slots(hx, *f)),
        (ops.posterior_predict_slots_stacked(hxp, *fp),
         ref.posterior_predict_slots_stacked(hxp, *fp)),
    ):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert predict.LAUNCHES == {"posterior_predict": 0, "posterior_predict_slots": 0}


def test_kernel_lanes_refuse_non_rbf_covariances():
    from repro_torch.gp.covariances import matern32, rbf

    rng = np.random.default_rng(2)
    f = _t(_factors(rng, (), 3, 2))
    x = torch.zeros(4, 2)
    ops.require_rbf(None)
    ops.require_rbf(rbf)
    with pytest.raises(ValueError, match="only the 'rbf'"):
        ops.posterior_predict(x, *f, cov_fn=matern32)
    with pytest.raises(ValueError, match="only the 'rbf'"):
        ops.posterior_predict_slots(x[None], *f, cov_fn=matern32)


def test_wrappers_take_cuda_tensors_only_and_count_nothing_on_refusal():
    rng = np.random.default_rng(4)
    f = _t(_factors(rng, (2,), 5, 2))
    hx = torch.zeros(2, 9, 8, 2)
    launches.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        predict.posterior_predict_slots(hx, *f)
    with pytest.raises(ValueError, match="CUDA tensors"):
        predict.posterior_predict(hx[:, 0], *f)
    with pytest.raises(ValueError):
        predict.posterior_predict_slots(hx[0], *f)  # (S, Q, d): no cell axis
    assert predict.LAUNCHES == {"posterior_predict": 0, "posterior_predict_slots": 0}


@pytest.mark.parametrize("m", [predict.MAX_M + 1, 4096])
def test_wrappers_refuse_m_past_the_wide_limit_with_the_limit(m):
    """Past the wide body's m (a block's knm tile in shared memory) the
    wrappers raise, naming the limit, before any device work; K(X, Z) has no
    such limit."""
    from repro_torch.kernels import rbf, svgp_proj

    P, d = 1, 2
    x = torch.zeros(P, 3, d)
    z = torch.zeros(P, m, d)
    log_l, log_v = torch.zeros(P, d), torch.zeros(P)
    sq, c = torch.zeros(P, m, m), torch.zeros(P, m)
    launches.reset()
    with pytest.raises(ValueError, match=f"1 <= m <= {predict.MAX_M} inducing points"):
        predict.posterior_predict(x, z, log_l, log_v, sq, sq, c)
    with pytest.raises(ValueError, match=f"1 <= m <= {predict.MAX_M} inducing points"):
        predict.posterior_predict_slots(x[:, None], z, log_l, log_v, sq, sq, c)
    with pytest.raises(ValueError, match=f"1 <= m <= {svgp_proj.MAX_M} inducing points"):
        svgp_proj.svgp_projection(x, z, log_l, log_v, sq)
    with pytest.raises(ValueError, match="CUDA tensors"):  # past the shapes: only the device
        rbf.rbf_cross_cov(x, z, log_l, log_v)
    assert predict.LAUNCHES == {"posterior_predict": 0, "posterior_predict_slots": 0}


def test_build_is_lazy_and_keyed_by_source_content(tmp_path, monkeypatch):
    assert [p.name for p in build.sources()] == ["adam.cu", "draws.cu", "predict.cu",
                                                 "svgp_proj.cu"]
    assert [p.name for p in build.headers()] == ["kernel_common.cuh"]
    assert build._lib is None  # importing the package built nothing
    h = build.source_hash()
    assert h == build.source_hash() and len(h) == 16
    for src in (*build.sources(), *build.headers()):
        (tmp_path / src.name).write_text(src.read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.source_hash() == h
    (tmp_path / "kernel_common.cuh").write_text("// changed\n")
    changed = build.source_hash()
    assert changed != h
    (tmp_path / "predict.cu").write_text("// changed\n")
    assert build.source_hash() not in (h, changed)
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_tolerance_ratio_scales_with_the_summed_terms():
    want = torch.tensor([1.0, 1.0], dtype=torch.float64)
    got = torch.tensor([1.0 + 2e-5, 1.0], dtype=torch.float64)
    assert ref.tolerance_ratio(got, want, torch.tensor([1.0, 1.0])) == pytest.approx(2.0, rel=1e-3)
    assert ref.tolerance_ratio(got, want, torch.tensor([4.0, 1.0])) == pytest.approx(0.5, rel=1e-3)
    x = torch.zeros(1, 2)
    f = [torch.zeros(1, 2), torch.zeros(2), torch.tensor(0.0),
         torch.eye(1), 2 * torch.eye(1), torch.tensor([-3.0])]
    mean_s, fvar_s = ref.posterior_predict_scales(x, *f)
    assert mean_s.dtype == torch.float64
    assert float(mean_s[0]) == pytest.approx(3.0) and float(fvar_s[0]) == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P,S,Q,m,d", [
    (400, 9, 32, 5, 2), (3, 9, 77, 1, 2), (2, 4, 333, 17, 3), (2, 9, 129, 64, 4),
    # a tile edge inside a cell (S*Q not a multiple of the tile), Q = 1,
    # P = 1 at 65,536 rows (the cell spread over many blocks), every MMAX
    (400, 9, 216, 5, 2), (1, 1, 65536, 5, 2), (7, 9, 1, 8, 1), (3, 3, 37, 9, 4),
    (2, 9, 50, 33, 2), (1, 1, 1, 64, 1), (5, 1, 333, 5, 4), (1, 7, 113, 1, 1),
    # the wide body: m past 64 (ragged against its 32-row tiles and 64 x 32
    # factor tiles), d past 4 at any m
    (3, 9, 77, 65, 2), (2, 4, 133, 128, 5), (1, 1, 300, 256, 8), (2, 1, 45, 1024, 2),
    (1, 1, 70, 2048, 3), (5, 9, 32, 5, 5), (2, 3, 41, 8, 8), (1, 1, 19, 100, 1),
])
def test_cuda_slots_kernel_matches_plain(cuda_device, P, S, Q, m, d):
    rng = np.random.default_rng(P + Q)
    f = _t(_factors(rng, (P,), m, d), cuda_device)
    hx = torch.as_tensor(rng.uniform(0, 2, (P, S, Q, d)).astype(np.float32), device=cuda_device)
    launches.reset()
    got = predict.posterior_predict_slots(hx, *f)
    assert predict.LAUNCHES["posterior_predict_slots"] == 1
    want = ref.posterior_predict_slots_stacked(hx, *f)
    scales = ref.posterior_predict_scales(hx, *(a[:, None] for a in f))
    assert ref.tolerance_ratio(got[0], want[0], scales[0]) <= 1
    assert ref.tolerance_ratio(got[1], want[1], scales[1]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("P,Q,m,d", [(1, 1, 1, 2), (1, 1000, 10, 2), (1, 130, 64, 2),
                                     (400, 288, 5, 2), (3, 77, 65, 5), (2, 200, 128, 8),
                                     (1, 33, 1024, 2)])
def test_cuda_single_block_kernel_matches_plain(cuda_device, P, Q, m, d):
    rng = np.random.default_rng(Q + m)
    f = _t(_factors(rng, (P,), m, d), cuda_device)
    x = torch.as_tensor(rng.uniform(0, 2, (P, Q, d)).astype(np.float32), device=cuda_device)
    launches.reset()
    got = predict.posterior_predict(x, *f)
    assert predict.LAUNCHES["posterior_predict"] == 1
    want = ref.posterior_predict(x, *f)
    scales = ref.posterior_predict_scales(x, *f)
    assert ref.tolerance_ratio(got[0], want[0], scales[0]) <= 1
    assert ref.tolerance_ratio(got[1], want[1], scales[1]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(5, 2), (128, 2), (65, 5)])
def test_cuda_pallas_lane_is_one_launch_and_bitwise_the_per_cell_launches(cuda_device, m, d):
    """The "pallas" lane evaluates every cell's (S*Q, d) rows in ONE launch,
    and its answers are bitwise those of one launch per cell."""
    from repro_torch.core import posterior
    from repro_torch.gp.covariances import CovarianceParams, rbf

    rng = np.random.default_rng(m + d)
    P, S, Q = 12, 9, 32
    z, log_l, log_v, w, u, c = _t(_factors(rng, (P,), m, d), cuda_device)
    cache = posterior.PosteriorCache(
        z=z, w=w, u=u, c=c, cov=CovarianceParams(log_lengthscale=log_l, log_variance=log_v),
        log_beta=torch.full((P,), 3.0, device=cuda_device),
    )
    hx = torch.as_tensor(rng.uniform(0, 2, (P, S, Q, d)).astype(np.float32), device=cuda_device)
    launches.reset()
    got = posterior.predict_cached_slots_stacked(cache, rbf, hx, backend="pallas")
    assert predict.LAUNCHES == {"posterior_predict": 1, "posterior_predict_slots": 0}
    per_cell = [posterior.predict_cached_slots(posterior.take_cache(cache, p), rbf, hx[p],
                                               backend="pallas") for p in range(P)]
    for i in range(2):
        assert torch.equal(got[i], torch.stack([o[i] for o in per_cell]))


@pytest.mark.cuda
def test_cuda_slots_kernel_rows_are_independent(cuda_device):
    rng = np.random.default_rng(9)
    f = _t(_factors(rng, (), 10, 2), cuda_device)
    hx = torch.as_tensor(rng.uniform(0, 2, (9, 200, 2)).astype(np.float32), device=cuda_device)
    valid = torch.as_tensor(rng.uniform(size=(9, 200)) < 0.6, device=cuda_device)
    base = ops.posterior_predict_slots(hx, *f)
    junk = torch.where(valid[..., None], hx, torch.full_like(hx, float("nan")))
    again = ops.posterior_predict_slots(junk, *f)
    assert torch.equal(base[0][valid], again[0][valid])
    assert torch.equal(base[1][valid], again[1][valid])


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(5, 2), (9, 1), (33, 4), (128, 2), (65, 5)])
def test_cuda_slots_rows_are_bitwise_the_same_at_any_q_max(cuda_device, m, d):
    """A row's bits do not depend on the tile, thread or row slot it lands
    on, nor on how many rows a thread takes: the same rows at q_max = 32,
    at the end of q_max = 216 and of q_max = 5,120 blocks (a launch past
    one wave, several rows per thread), and read from an address where a
    float2 load does not fit."""
    rng = np.random.default_rng(m + d)
    P, S = 6, 9
    f = _t(_factors(rng, (P,), m, d), cuda_device)
    rows = torch.as_tensor(rng.uniform(0, 2, (P, S, 32, d)).astype(np.float32), device=cuda_device)
    flat = torch.empty(rows.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(rows.shape)  # contiguous, 4 bytes past an 8-byte boundary
    shifted.copy_(rows)
    base = predict.posterior_predict_slots(rows, *f)
    unaligned = predict.posterior_predict_slots(shifted, *f)
    one_cell = [ops.posterior_predict_slots(rows[p], *(a[p] for a in f)) for p in range(P)]
    for i in range(2):
        assert torch.equal(base[i], unaligned[i])
        assert torch.equal(base[i], torch.stack([o[i] for o in one_cell]))
    for q_max in (216, 5120):
        wide = torch.as_tensor(rng.uniform(0, 2, (P, S, q_max, d)).astype(np.float32),
                               device=cuda_device)
        wide[:, :, -32:] = rows
        at_q = predict.posterior_predict_slots(wide, *f)
        for i in range(2):
            assert torch.equal(base[i], at_q[i][:, :, -32:])


# the wide body's edges: m on and either side of its 16-deep chunks, its
# 32-column groups and its 128-column tiles (and m = 20 with d = 5, wide by
# d), each at Q of 1, 255, 256 and 257 in turn
WIDE_EDGE_MS = (20, 65, 127, 128, 129, 255, 256, 257, 1023, 1024, 1025, 2047, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("i,m", list(enumerate(WIDE_EDGE_MS)))
def test_cuda_wide_prediction_tile_edges_match_plain(cuda_device, i, m):
    Q, d, P = (1, 255, 256, 257)[i % 4], 5 if m == 20 else 2 + i % 2, 1 + i % 2
    rng = np.random.default_rng(m + Q)
    f = _t(_factors(rng, (P,), m, d), cuda_device)
    hx = torch.as_tensor(rng.uniform(0, 2, (P, 1, Q, d)).astype(np.float32), device=cuda_device)
    launches.reset()
    got = predict.posterior_predict_slots(hx, *f)
    assert predict.LAUNCHES["posterior_predict_slots"] == 1
    want = ref.posterior_predict_slots_stacked(hx, *f)
    scales = ref.posterior_predict_scales(hx, *(a[:, None] for a in f))
    assert ref.tolerance_ratio(got[0], want[0], scales[0]) <= 1
    assert ref.tolerance_ratio(got[1], want[1], scales[1]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(65, 2), (128, 2), (1024, 2), (300, 5)])
def test_cuda_wide_prediction_rows_are_bitwise_across_row_tiles(cuda_device, m, d):
    """A row's bits do not depend on the launch's row tile: 257 rows of one
    cell alone (small row tiles), at the head of 9 x 4,096 rows and as cell
    0 of 64 cells (large ones) agree bitwise."""
    rng = np.random.default_rng(m)
    f = _t(_factors(rng, (1,), m, d), cuda_device)
    hx = torch.as_tensor(rng.uniform(0, 2, (1, 9, 4096, d)).astype(np.float32), device=cuda_device)
    big = predict.posterior_predict_slots(hx, *f)
    head = predict.posterior_predict_slots(hx[:, :1, :257].contiguous(), *f)
    many = predict.posterior_predict_slots(hx[:, :1, :257].expand(64, -1, -1, -1).contiguous(),
                                           *(a.expand(64, *a.shape[1:]).contiguous() for a in f))
    for b, h, y in zip(big, head, many, strict=True):
        assert torch.equal(b[:, :1, :257], h)
        assert torch.equal(y[:1], h)
        assert torch.equal(y[-1:], h)
