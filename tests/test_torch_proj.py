"""The port's ELBO-projection and RBF cross-covariance kernels: plain
versions against the JAX oracles, the autograd ``Function`` against the
JAX package's ``custom_vjp`` (its Pallas forward in interpret mode),
gradcheck, the dispatch rule, the wrappers' refusals, and (on a CUDA
machine only) each CUDA kernel against its plain version.

Tolerances (``ref.tolerance_ratio``, float32 rounding scaled by the terms
each output sums): |d knm| <= 1e-5 sigma^2, |d lk_t| <= 1e-5 max(1,
sum_j |k_j W_ij|), |d q_diag| <= 1e-5 max(1, q_diag).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import launches, ops, rbf, ref, svgp_proj


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny batched ops on a many-thread CPU pool pay a large fork cost
    (torch.tril: ~8 ms a call at 8 threads, 7 us at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(rng, lead: tuple, B: int, m: int, d: int):
    """Seeded (x, z, log_l, log_v, lmm): lmm a well-conditioned lower
    Cholesky factor of the RBF Kmm + 1e-3 I of z."""
    x = rng.uniform(0, 2, lead + (B, d)).astype(np.float32)
    z = rng.uniform(0, 2, lead + (m, d)).astype(np.float32)
    log_l = np.log(rng.uniform(0.5, 1.5, lead + (d,))).astype(np.float32)
    log_v = rng.normal(0, 0.3, lead).astype(np.float32)
    zs, ls, vs = z.reshape((-1, m, d)), log_l.reshape((-1, d)), log_v.reshape(-1)
    lmm = np.stack([
        np.linalg.cholesky(
            np.asarray(jref.rbf_cross_cov(zs[i], zs[i], ls[i], vs[i]), np.float64)
            + 1e-3 * np.eye(m)
        )
        for i in range(zs.shape[0])
    ]).reshape(lead + (m, m)).astype(np.float32)
    return x, z, log_l, log_v, lmm


def _t(arrays, dtype=torch.float32, device="cpu"):
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def _lower_inverse(lmm):
    return np.linalg.inv(lmm.astype(np.float64)).astype(np.float32)


def _assert_projection_agrees(got, want, args_w):
    knm_s, lk_s, q_s = ref.svgp_projection_scales(*args_w)
    want = [torch.as_tensor(np.asarray(w)) for w in want]
    assert ref.tolerance_ratio(got[0], want[0], knm_s, floor=0.0) <= 1
    assert ref.tolerance_ratio(got[1], want[1], lk_s) <= 1
    assert ref.tolerance_ratio(got[2], want[2], q_s) <= 1


@pytest.mark.parametrize("B,m,d", [(1, 1, 2), (8, 5, 2), (33, 10, 3), (32, 10, 2), (32, 20, 2),
                                   (7, 64, 4), (9, 65, 5), (5, 128, 5)])
def test_plain_svgp_projection_matches_jax_oracle(B, m, d):
    rng = np.random.default_rng(B * 100 + m)
    x, z, log_l, log_v, lmm = _problem(rng, (), B, m, d)
    w = _lower_inverse(lmm)
    got = ref.svgp_projection(*_t([x, z, log_l, log_v, w]))
    want = jref.svgp_projection(*map(jnp.asarray, [x, z, log_l, log_v, w]))
    assert [tuple(g.shape) for g in got] == [(B, m), (B, m), (B,)]
    _assert_projection_agrees(got, want, _t([x, z, log_l, log_v, w]))


def test_plain_cell_axis_is_per_cell_jax_oracle():
    rng = np.random.default_rng(11)
    P, B, m = 4, 8, 6
    x, z, log_l, log_v, lmm = _problem(rng, (P,), B, m, 2)
    w = _lower_inverse(lmm)
    knm, lk_t, q = ref.svgp_projection(*_t([x, z, log_l, log_v, w]))
    k2 = ref.rbf_cross_cov(*_t([x, z, log_l, log_v]))
    assert torch.equal(knm, k2) and tuple(knm.shape) == (P, B, m)
    for p in range(P):
        one = [a[p] for a in (x, z, log_l, log_v, w)]
        want = jref.svgp_projection(*map(jnp.asarray, one))
        _assert_projection_agrees((knm[p], lk_t[p], q[p]), want, _t(one))


def test_function_cpu_lane_matches_jax_custom_vjp_outputs_and_vjp():
    """The port's autograd Function (CPU: plain forward, plain recompute in
    the backward) against ``repro.kernels.ops.svgp_projection`` — the Pallas
    forward in interpret mode and its jnp-recompute VJP — on the JAX
    single-model signature."""
    rng = np.random.default_rng(5)
    args = _problem(rng, (), 8, 5, 2)
    cot = [rng.normal(size=s).astype(np.float32) for s in ((8, 5), (8, 5), (8,))]
    want, vjp = jax.vjp(jops.svgp_projection, *map(jnp.asarray, args))
    want_grads = vjp(tuple(map(jnp.asarray, cot)))
    leaves = [t.requires_grad_(True) for t in _t(args)]
    got = ops.svgp_projection(*leaves)
    w = _t([_lower_inverse(args[-1])])[0]
    _assert_projection_agrees([g.detach() for g in got], want, [*_t(args[:4]), w])
    grads = torch.autograd.grad(got, leaves, _t(cot))
    for name, g, gw in zip(("x", "z", "log_l", "log_v", "lmm"), grads, want_grads, strict=True):
        gw = np.asarray(gw)
        scale = max(1.0, float(np.abs(gw).max()))
        np.testing.assert_allclose(g.numpy(), gw, atol=2e-4 * scale, rtol=1e-4, err_msg=name)


def test_function_cell_axis_equals_single_model_calls():
    rng = np.random.default_rng(8)
    P = 3
    args = _t(_problem(rng, (P,), 8, 5, 2))
    leaves = [a.clone().requires_grad_(True) for a in args]
    knm, lk_t, q = ops.svgp_projection(*leaves)
    g_all = torch.autograd.grad(torch.sum(lk_t) + torch.sum(q), leaves)
    for p in range(P):
        one = [a[p].clone().requires_grad_(True) for a in args]
        k1, l1, q1 = ops.svgp_projection(*one)
        assert torch.allclose(k1, knm[p]) and torch.allclose(l1, lk_t[p], atol=1e-6)
        g1 = torch.autograd.grad(torch.sum(l1) + torch.sum(q1), one)
        for a, b in zip(g1, g_all, strict=True):
            assert torch.allclose(a, b[p], rtol=1e-5, atol=1e-5)


def test_function_gradcheck_float64():
    rng = np.random.default_rng(2)
    args = _t(_problem(rng, (2,), 4, 3, 2), dtype=torch.float64)
    leaves = [a.requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(ops.SVGPProjection.apply, leaves, eps=1e-6, atol=1e-6)


def test_one_training_step_at_m_80_matches_jax_by_injection():
    """A training step past the narrow kernel's m (the wide body's range on
    the card; the Function's plain forward here), held to one JAX step with
    its Pallas projection (interpret mode) by the JAX step's injected draws,
    at the tolerances of ``test_torch_train._assert_states_agree`` except
    the params: 1e-4 absolute, since the JAX package's own two lanes (Pallas
    and jnp) differ by up to 2.5e-4 on them after this step (Adam's first
    step is a sign-like update, and float32 gradients of 80 terms sum in
    another order). Jitter 1e-2: at the default 1e-5, Kmm of 80 inducing
    points among ~200 points a cell is so ill-conditioned that those two
    lanes differ by 2e-3 in the loss."""
    import test_torch_train

    test_torch_train.step_by_injection("gather", True, param_atol=1e-4, m=80, grid=2, n=800,
                                       jitter=1e-2)


def test_rbf_cross_cov_dispatch_matches_jax_and_cpu_launches_nothing():
    rng = np.random.default_rng(3)
    x, z, log_l, log_v, lmm = _problem(rng, (2,), 9, 4, 2)
    launches.reset()
    got = ops.rbf_cross_cov(*_t([x, z, log_l, log_v]))
    one = ops.rbf_cross_cov(*_t([x[0], z[0], log_l[0], log_v[0]]))
    for p in range(2):
        want = np.asarray(jops.rbf_cross_cov_ref(*map(jnp.asarray, (x[p], z[p], log_l[p], log_v[p]))))
        np.testing.assert_allclose(got[p].numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(one, got[0])
    ops.svgp_projection(*_t([x, z, log_l, log_v, lmm]))
    assert svgp_proj.LAUNCHES == {"svgp_projection": 0} and rbf.LAUNCHES == {"rbf_cross_cov": 0}
    with pytest.raises(ValueError, match="x must be"):
        ops.rbf_cross_cov(torch.zeros(2, 3, 4, 2), *_t([z, log_l, log_v]))


def test_new_wrappers_take_cuda_tensors_only_and_count_nothing_on_refusal():
    rng = np.random.default_rng(4)
    x, z, log_l, log_v, lmm = _t(_problem(rng, (2,), 8, 5, 2))
    w = torch.linalg.inv(lmm)
    launches.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        svgp_proj.svgp_projection(x, z, log_l, log_v, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rbf.rbf_cross_cov(x, z, log_l, log_v)
    with pytest.raises(ValueError, match=r"\(P, B, d\)"):
        svgp_proj.svgp_projection(x[0], z, log_l, log_v, w)
    assert svgp_proj.LAUNCHES == {"svgp_projection": 0} and rbf.LAUNCHES == {"rbf_cross_cov": 0}


@pytest.mark.parametrize("m", [5, 9, 17, 80])
def test_function_hands_the_kernel_a_lower_triangular_w(monkeypatch, m):
    """The kernel's precondition (its wide body skips W's tiles above the
    diagonal): the Function's forward hands it W = Lmm^{-1} with every
    entry above the diagonal exactly zero, on either side of the wide
    body's m = 17. The CUDA dispatch is rehearsed here: ``on_cuda``
    forced, the wrapper swapped for a recorder of its W that answers with
    the plain version."""
    rng = np.random.default_rng(m)
    args = _t(_problem(rng, (3,), 6, m, 2))
    seen = []

    def recorder(x, z, log_l, log_v, w):
        seen.append(w)
        return ref.svgp_projection(x, z, log_l, log_v, w)

    monkeypatch.setattr(ops, "on_cuda", lambda x: True)
    monkeypatch.setattr(svgp_proj, "svgp_projection", recorder)
    ops.svgp_projection(*args)
    (w,) = seen
    assert w.shape == (3, m, m) and w.is_contiguous()
    assert int(torch.count_nonzero(torch.triu(w, 1))) == 0
    assert int(torch.count_nonzero(torch.diagonal(w, dim1=-2, dim2=-1))) == 3 * m


def test_projection_scales_bound_knm_by_the_variance():
    x = torch.zeros(1, 1, 2)
    z = torch.zeros(1, 2, 2)
    args = [x, z, torch.zeros(1, 2), torch.log(torch.tensor([0.5])), 3 * torch.eye(2)[None]]
    knm_s, lk_s, q_s = ref.svgp_projection_scales(*args)
    assert float(knm_s.flatten()[0]) == pytest.approx(0.5)
    assert torch.allclose(lk_s, torch.full((1, 1, 2), 1.5, dtype=torch.float64))
    assert float(q_s[0, 0]) == pytest.approx(4.5)
    got = torch.tensor([[[0.5 + 4e-6, 0.5]]], dtype=torch.float64)
    want = torch.tensor([[[0.5, 0.5]]], dtype=torch.float64)
    assert ref.tolerance_ratio(got, want, knm_s, floor=0.0) == pytest.approx(0.8, rel=1e-3)


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
@pytest.mark.parametrize("P,B,m,d", [
    (400, 32, 5, 2), (1, 1, 1, 2), (1, 33, 10, 3), (1, 200, 17, 4), (1, 200, 64, 2),
    # packed cells and one cell's tiles, B = 1, P = 1 at 65,536 rows, every
    # MMAX; (600, 111, 5) and (70, 1000, 8) store slabs (>= 65,536 rows)
    # that start on unaligned addresses
    (1, 65536, 5, 2), (50, 7, 5, 2), (2, 129, 5, 2), (400, 1, 1, 2), (7, 1, 8, 1),
    (3, 33, 9, 4), (1, 127, 33, 2), (2, 200, 64, 4), (600, 111, 5, 2), (70, 1000, 8, 4),
    # the wide body: m past 64 (ragged against its 32-row tiles and 64 x 32
    # tiles of W), d past 4 at any m
    (3, 50, 65, 2), (2, 100, 128, 5), (1, 70, 256, 8), (1, 33, 1024, 2), (1, 40, 2048, 3),
    (400, 32, 5, 5), (5, 17, 8, 8), (4, 64, 100, 1),
    # K(X, Z) past one wave of the card (z/l staged; m % 4 == 0 and not)
    (40, 1024, 32, 2), (30, 1500, 25, 3),
])
def test_cuda_projection_and_rbf_kernels_match_plain(cuda_device, P, B, m, d):
    rng = np.random.default_rng(P + B + m)
    x, z, log_l, log_v, lmm = _problem(rng, (P,), B, m, d)
    args = _t([x, z, log_l, log_v, _lower_inverse(lmm)], device=cuda_device)
    launches.reset()
    got = svgp_proj.svgp_projection(*args)
    assert svgp_proj.LAUNCHES["svgp_projection"] == 1
    _assert_projection_agrees([g.cpu() for g in got],
                              [g.cpu() for g in ref.svgp_projection(*args)], [a.cpu() for a in args])
    knm = rbf.rbf_cross_cov(*args[:4])
    assert torch.equal(knm, got[0])


@pytest.mark.cuda
def test_cuda_function_gradient_matches_plain_autograd_with_one_launch(cuda_device):
    rng = np.random.default_rng(1)
    args = _t(_problem(rng, (400,), 32, 5, 2), device=cuda_device)
    cot = [torch.randn(s, device=cuda_device) for s in ((400, 32, 5), (400, 32, 5), (400, 32))]
    leaves = [a.clone().requires_grad_(True) for a in args]
    launches.reset()
    got = torch.autograd.grad(ops.svgp_projection(*leaves), leaves, cot)
    assert svgp_proj.LAUNCHES["svgp_projection"] == 1  # the backward launches none
    plain = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ops.svgp_projection_ref(*plain), plain, cot)
    for g, w in zip(got, want, strict=True):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_function_gradient_at_m_128_matches_plain_autograd(cuda_device):
    """The wide body's forward under the autograd Function: the gradient
    against autograd through the plain version, one launch."""
    rng = np.random.default_rng(3)
    args = _t(_problem(rng, (6,), 40, 128, 2), device=cuda_device)
    cot = [torch.randn(s, device=cuda_device) for s in ((6, 40, 128), (6, 40, 128), (6, 40))]
    leaves = [a.clone().requires_grad_(True) for a in args]
    launches.reset()
    got = torch.autograd.grad(ops.svgp_projection(*leaves), leaves, cot)
    assert svgp_proj.LAUNCHES["svgp_projection"] == 1
    plain = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ops.svgp_projection_ref(*plain), plain, cot)
    for g, w in zip(got, want, strict=True):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,m,d", [(50, 7, 5, 2), (2, 129, 5, 2), (5, 33, 9, 4),
                                     (600, 111, 5, 2), (70, 1000, 8, 4), (5, 70, 128, 2),
                                     (3, 33, 65, 5)])
def test_cuda_projection_rows_are_bitwise_the_same_however_packed(cuda_device, P, B, m, d):
    """A row's outputs do not depend on how cells are packed into blocks,
    on which tile a row lands, on whether the launch stores through
    shared-memory slabs, or on where a slab starts: all P cells in one
    launch equal each cell alone, bitwise, and an x read from an address
    where a float2 load does not fit gives the same bits. K(X, Z)'s own
    elementwise body gives the projection's knm, bitwise."""
    rng = np.random.default_rng(P * B + m)
    x, z, log_l, log_v, lmm = _problem(rng, (P,), B, m, d)
    args = _t([x, z, log_l, log_v, _lower_inverse(lmm)], device=cuda_device)
    together = svgp_proj.svgp_projection(*args)
    flat = torch.empty(args[0].numel() + 1, device=cuda_device)
    shifted = flat[1:].view(args[0].shape)
    shifted.copy_(args[0])
    unaligned = svgp_proj.svgp_projection(shifted, *args[1:])
    knm = rbf.rbf_cross_cov(*args[:4])
    assert torch.equal(knm, together[0])
    for p in range(P):
        alone = svgp_proj.svgp_projection(*(a[p:p + 1] for a in args))
        for got, one, again in zip(together, alone, unaligned, strict=True):
            assert torch.equal(got[p:p + 1], one)
            assert torch.equal(got, again)


# the wide body's edges: m on and either side of its 16-deep chunks, its
# 32-column groups and its 128-column tiles (the Fig. 4 width m = 20, the
# most m = 2,048), each at B of 1, 255, 256 and 257 in turn
WIDE_EDGE_MS = (17, 20, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1023, 1024, 1025, 2047, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("i,m", list(enumerate(WIDE_EDGE_MS)))
def test_cuda_wide_projection_tile_edges_match_plain(cuda_device, i, m):
    """The wide projection at every tile edge against its plain version,
    with K(X, Z)'s knm bitwise the projection's."""
    B, d, P = (1, 255, 256, 257)[i % 4], 3 if i % 5 == 4 else 2, 1 + i % 2
    rng = np.random.default_rng(m + B)
    x, z, log_l, log_v, lmm = _problem(rng, (P,), B, m, d)
    args = _t([x, z, log_l, log_v, _lower_inverse(lmm)], device=cuda_device)
    launches.reset()
    got = svgp_proj.svgp_projection(*args)
    assert svgp_proj.LAUNCHES["svgp_projection"] == 1
    want = ref.svgp_projection(*args)
    _assert_projection_agrees([g.cpu() for g in got], [g.cpu() for g in want],
                              [a.cpu() for a in args])
    assert torch.equal(rbf.rbf_cross_cov(*args[:4]), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,d", [(4097, 1024, 2), (16385, 129, 2), (8191, 520, 3)])
def test_cuda_wide_projection_large_launches_match_plain(cuda_device, B, m, d):
    """Launches of thousands of rows, each with a ragged last 64-row tile,
    against the plain version: column tiles paired over a cluster (m = 520
    and 1,024) and one block walking both of its tiles (m = 129)."""
    rng = np.random.default_rng(B)
    x, z, log_l, log_v, lmm = _problem(rng, (1,), B, m, d)
    args = _t([x, z, log_l, log_v, _lower_inverse(lmm)], device=cuda_device)
    got = svgp_proj.svgp_projection(*args)
    want = ref.svgp_projection(*args)
    _assert_projection_agrees([g.cpu() for g in got], [g.cpu() for g in want],
                              [a.cpu() for a in args])
    assert torch.equal(rbf.rbf_cross_cov(*args[:4]), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(20, 2), (128, 2), (1024, 2), (300, 5)])
def test_cuda_wide_projection_rows_are_bitwise_across_row_tiles_and_splits(cuda_device, m, d):
    """A row's bits do not depend on the launch's row tile, rows a thread or
    cluster split: 257 rows of one cell alone (a few blocks: small row
    tiles, column tiles split over a cluster), the same rows at the head of
    4,096 (large row tiles) and as cell 0 of 64 cells (one block a row
    tile walks every column tile) agree bitwise."""
    rng = np.random.default_rng(m)
    x, z, log_l, log_v, lmm = _problem(rng, (1,), 4096, m, d)
    args = _t([x, z, log_l, log_v, _lower_inverse(lmm)], device=cuda_device)
    big = svgp_proj.svgp_projection(*args)
    head = svgp_proj.svgp_projection(args[0][:, :257].contiguous(), *args[1:])
    many = svgp_proj.svgp_projection(args[0][:, :257].expand(64, -1, -1).contiguous(),
                                     *(a.expand(64, *a.shape[1:]).contiguous() for a in args[1:]))
    for b, h, y in zip(big, head, many, strict=True):
        assert torch.equal(b[:, :257], h)
        assert torch.equal(y[:1], h)
        assert torch.equal(y[-1:], h)
