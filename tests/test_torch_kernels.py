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
from repro_torch.kernels import build, ops, predict, ref


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


@pytest.mark.parametrize("m,q,d", [(1, 1, 2), (5, 37, 2), (17, 129, 3), (64, 8, 4)])
def test_plain_posterior_predict_matches_jax_oracle(m, q, d):
    rng = np.random.default_rng(m * 100 + q)
    f = _factors(rng, (), m, d)
    x = rng.uniform(0, 2, (q, d)).astype(np.float32)
    got = ref.posterior_predict(*_t([x, *f]))
    want = jref.posterior_predict(*map(jnp.asarray, [x, *f]))
    assert got[0].shape == got[1].shape == (q,)
    _agrees(got, want, *_t([x]), _t(f))


def test_plain_rbf_cross_cov_matches_jax_oracle():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 2, (11, 2)).astype(np.float32)
    z, log_l, log_v = _factors(rng, (), 7, 2)[:3]
    got = ref.rbf_cross_cov(*_t([x, z, log_l, log_v]))
    want = np.asarray(jref.rbf_cross_cov(*map(jnp.asarray, [x, z, log_l, log_v])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,q,m", [(9, 32, 5), (3, 77, 10)])
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


def test_cpu_tensors_dispatch_to_the_plain_versions_without_launching():
    rng = np.random.default_rng(5)
    f = _t(_factors(rng, (), 5, 2))
    fp = _t(_factors(rng, (3,), 5, 2))
    x = torch.as_tensor(rng.uniform(0, 2, (9, 2)).astype(np.float32))
    hx = torch.as_tensor(rng.uniform(0, 2, (4, 9, 2)).astype(np.float32))
    hxp = torch.as_tensor(rng.uniform(0, 2, (3, 4, 9, 2)).astype(np.float32))
    predict.reset_launches()
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
    predict.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        predict.posterior_predict_slots(hx, *f)
    with pytest.raises(ValueError, match="CUDA tensors"):
        predict.posterior_predict(hx[0, 0], *(a[0] for a in f))
    with pytest.raises(ValueError):
        predict.posterior_predict_slots(hx[0], *f)  # (S, Q, d): no cell axis
    assert predict.LAUNCHES == {"posterior_predict": 0, "posterior_predict_slots": 0}


def test_build_is_lazy_and_keyed_by_source_content(tmp_path, monkeypatch):
    assert [p.name for p in build.sources()] == ["predict.cu", "svgp_proj.cu"]
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
])
def test_cuda_slots_kernel_matches_plain(cuda_device, P, S, Q, m, d):
    rng = np.random.default_rng(P + Q)
    f = _t(_factors(rng, (P,), m, d), cuda_device)
    hx = torch.as_tensor(rng.uniform(0, 2, (P, S, Q, d)).astype(np.float32), device=cuda_device)
    predict.reset_launches()
    got = predict.posterior_predict_slots(hx, *f)
    assert predict.LAUNCHES["posterior_predict_slots"] == 1
    want = ref.posterior_predict_slots_stacked(hx, *f)
    scales = ref.posterior_predict_scales(hx, *(a[:, None] for a in f))
    assert ref.tolerance_ratio(got[0], want[0], scales[0]) <= 1
    assert ref.tolerance_ratio(got[1], want[1], scales[1]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("Q,m", [(1, 1), (1000, 10), (130, 64)])
def test_cuda_single_block_kernel_matches_plain(cuda_device, Q, m):
    rng = np.random.default_rng(Q)
    f = _t(_factors(rng, (), m, 2), cuda_device)
    x = torch.as_tensor(rng.uniform(0, 2, (Q, 2)).astype(np.float32), device=cuda_device)
    got = predict.posterior_predict(x, *f)
    want = ref.posterior_predict(x, *f)
    scales = ref.posterior_predict_scales(x, *f)
    assert ref.tolerance_ratio(got[0], want[0], scales[0]) <= 1
    assert ref.tolerance_ratio(got[1], want[1], scales[1]) <= 1


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
@pytest.mark.parametrize("m,d", [(5, 2), (9, 1), (33, 4)])
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
