"""Plain PyTorch versions of the kernels (the allclose targets).

Port of ``repro.kernels.ref``, in the exact input convention of the CUDA
kernels in ``csrc/``: the CPU lanes run these, and ``chip_smoke.py`` holds
each kernel to them on the card. Leading batch axes broadcast (the JAX
package's ``vmap`` written out), which is all the slot-stacked and
cell-stacked variants below are: with x (P, B, d) against P-stacked
z (P, m, d), log_lengthscale (P, d), log_variance (P,) and w (P, m, m),
``rbf_cross_cov`` and ``svgp_projection`` compute what ONE launch of the
cell-axis kernel computes for every cell.
"""
from __future__ import annotations

import torch


def rbf_cross_cov(
    x: torch.Tensor, z: torch.Tensor, log_lengthscale: torch.Tensor, log_variance: torch.Tensor
) -> torch.Tensor:
    """ARD-RBF K(X,Z): exp(lv) * exp(-0.5 sum_d (x_d - z_d)^2 / l_d^2).

    x: (..., n, d), z: (..., m, d), log_lengthscale (..., d),
    log_variance (...) -> (..., n, m); with a leading cell axis P this is
    the cell-axis K(X, Z) of ``csrc/svgp_proj.cu``'s rbf entry.
    """
    inv_l = torch.exp(-log_lengthscale)[..., None, :]
    diff = (x * inv_l)[..., :, None, :] - (z * inv_l)[..., None, :, :]
    r2 = torch.sum(diff * diff, dim=-1)
    return torch.exp(log_variance)[..., None, None] * torch.exp(-0.5 * r2)


def svgp_projection(
    x: torch.Tensor,
    z: torch.Tensor,
    log_lengthscale: torch.Tensor,
    log_variance: torch.Tensor,
    w: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused SVGP projection (the ELBO's O(B m^2) hot path).

    w: (..., m, m) = Lmm^{-1} (dense lower-triangular inverse of chol(Kmm)).
    x (..., B, d) -> (knm (..., B, m), lk_t (..., B, m), q_diag (..., B)):
      knm    K(X, Z)
      lk_t   K(X, Z) @ W^T   (row i = (Lmm^{-1} k_i)^T)
      q_diag ||Lmm^{-1} k_i||^2 = k_i^T Kmm^{-1} k_i
    """
    knm = rbf_cross_cov(x, z, log_lengthscale, log_variance)
    lk_t = knm @ w.mT
    q_diag = torch.sum(lk_t * lk_t, dim=-1)
    return knm, lk_t, q_diag


def posterior_predict(
    x: torch.Tensor,
    z: torch.Tensor,
    log_lengthscale: torch.Tensor,
    log_variance: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    c: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cached-posterior prediction (the serving hot path).

    w: (m, m) = Lmm^{-1};  u: (m, m) = Sl^T A;  c: (m,) projected mean
    (see repro_torch.core.posterior). x (Q, d) -> (Q,) pairs:
      mean  K(X*,Z) @ c
      fvar  k_** - ||W k_*||^2 + ||U k_*||^2   (un-clamped)
    """
    knm = rbf_cross_cov(x, z, log_lengthscale, log_variance)
    mean = (knm @ c[..., :, None])[..., 0]
    lk = knm @ w.mT
    su = knm @ u.mT
    fvar = (
        torch.exp(log_variance)[..., None]
        - torch.sum(lk * lk, dim=-1)
        + torch.sum(su * su, dim=-1)
    )
    return mean, fvar


def posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c):
    """Slot-stacked ``posterior_predict``: hx (S, Q, d) -> (S, Q) pairs.

    One model, S stacked query blocks (the serving program's 9 halo slots).
    """
    return posterior_predict(hx, z, log_lengthscale, log_variance, w, u, c)


def posterior_predict_slots_stacked(hx, z, log_lengthscale, log_variance, w, u, c):
    """Cell-axis slots: hx (P, S, Q, d) against P-stacked leaves z (P, m, d),
    log_lengthscale (P, d), log_variance (P,), w/u (P, m, m), c (P, m)
    -> (P, S, Q) pairs — cell p's model on its own S blocks, which is what
    ONE launch of the CUDA slots kernel computes for the whole grid."""
    return posterior_predict(
        hx, z[:, None], log_lengthscale[:, None], log_variance[:, None],
        w[:, None], u[:, None], c[:, None],
    )


def posterior_predict_slots_masked(hx, qmask, z, log_lengthscale, log_variance, w, u, c):
    """Masked slot-stacked oracle — the TWO-LEVEL routing contract.

    A block mixes owner rows, spill rows and padded rows (qmask 0). The
    kernel's ROW INDEPENDENCE makes the mix safe: every output row is a
    function of its own input row and the resident factors only. This
    oracle states that contract as math: :func:`posterior_predict_slots`
    with masked rows forced to zero. qmask: (S, Q) {0,1}.
    """
    mean, fvar = posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c)
    return mean * qmask, fvar * qmask


# ---------------------------------------------------------------------------
# tolerance scales: how far two float32 evaluations of the same function may
# honestly differ. The mean sums the terms k_j c_j, and fitted c_j cancel
# (on the paper's 400-cell artifact sum_j |k_j c_j| reaches ~3e3 at |mean|
# < 3, and the JAX package's own routed and replicated lanes differ by 9e-5
# there); the variance k** - ||Wk||^2 + ||Uk||^2 cancels at the scale of its
# two norms. Two evaluations agree when, per row,
#     |d mean| <= TOL * max(1, mean_scale),  |d fvar| <= TOL * max(1, fvar_scale).
# ---------------------------------------------------------------------------

TOL = 1e-5


def posterior_predict_scales(x, z, log_lengthscale, log_variance, w, u, c):
    """Per-row (mean_scale, fvar_scale) of :func:`posterior_predict`, in
    float64: mean_scale = sum_j |k_j c_j|, fvar_scale = ||Wk||^2 + ||Uk||^2.
    Same arguments and broadcasting as :func:`posterior_predict`."""
    x, z, log_lengthscale, log_variance, w, u, c = (
        t.double() for t in (x, z, log_lengthscale, log_variance, w, u, c)
    )
    knm = rbf_cross_cov(x, z, log_lengthscale, log_variance)
    mean_scale = torch.sum(torch.abs(knm * c[..., None, :]), dim=-1)
    lk = knm @ w.mT
    su = knm @ u.mT
    return mean_scale, torch.sum(lk * lk, dim=-1) + torch.sum(su * su, dim=-1)


def svgp_projection_scales(x, z, log_lengthscale, log_variance, w):
    """(knm_scale, lk_scale, q_scale) of :func:`svgp_projection`, in float64,
    each broadcastable to its output: knm_scale = sigma^2 (..., 1, 1),
    lk_scale = sum_j |k_j W_ij| (..., B, m), q_scale = q_diag (..., B).
    Compare knm with ``floor=0`` (|d knm| <= TOL sigma^2), the other two
    with the default floor of 1."""
    x, z, log_lengthscale, log_variance, w = (
        t.double() for t in (x, z, log_lengthscale, log_variance, w)
    )
    knm, _, q_diag = svgp_projection(x, z, log_lengthscale, log_variance, w)
    lk_scale = torch.abs(knm) @ torch.abs(w).mT
    return torch.exp(log_variance)[..., None, None], lk_scale, q_diag


def tolerance_ratio(
    got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor, floor: float = 1.0
) -> float:
    """max over entries of |got - want| / (TOL * max(floor, scale)); <= 1
    agrees. ``scale`` broadcasts against ``got``."""
    err = torch.abs(got.double() - want.double())
    return float(torch.max(err / (TOL * torch.clamp_min(scale.double(), floor))))
