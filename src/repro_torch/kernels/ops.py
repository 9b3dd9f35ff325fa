"""Dispatch between the CUDA kernels and their plain versions.

The rule is the tensor's device and nothing else (:func:`on_cuda`, which
every kernel call site asks): a CPU tensor goes to the plain PyTorch
version (``ref.py``); a CUDA tensor launches the kernel (``predict.py``,
``svgp_proj.py``, ``rbf.py``, ``draws.py``; ``optim.adam_update``'s
``adam.py``) or raises. Unlike ``repro.kernels.ops`` there is no padding:
the kernels take any m up to ``predict.MAX_M`` (2,048; K(X, Z) any m), any
d and any row count >= 1. Every prediction entry takes the JAX signature
and, with a leading cell axis P, the one that runs P cells in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.gp.covariances import rbf as _rbf_covariance
from repro_torch.core.sampler import StepDraws
from repro_torch.kernels import draws, predict, ref, svgp_proj
from repro_torch.kernels import rbf as rbf_kernel


def require_rbf(cov_fn) -> None:
    """Refuse to route a non-RBF covariance through the kernels.

    The kernels hard-code the ARD-RBF; dispatching any other covariance
    through them would silently return RBF answers. ``None`` is accepted
    for call sites that only handle the RBF by construction.
    """
    if cov_fn is not None and cov_fn is not _rbf_covariance:
        name = getattr(cov_fn, "__name__", repr(cov_fn))
        raise ValueError(
            f"the CUDA prediction kernels implement only the 'rbf' "
            f"covariance, got {name!r}; serve with backend='ref' (the plain "
            "path supports every covariance in repro_torch.gp.covariances)"
        )


def on_cuda(x: torch.Tensor) -> bool:
    """The one dispatch rule: True on CUDA (the kernel), False on the CPU."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"tensors must be on 'cuda' or 'cpu', got {x.device}")


def posterior_predict(x, z, log_lengthscale, log_variance, w, u, c, *, cov_fn=None):
    """x (Q, d) against one model -> (mean (Q,), fvar (Q,)), or with a cell
    axis x (P, Q, d) against P-stacked factors -> (P, Q) pairs in one launch
    on CUDA; fvar un-clamped and without noise (callers own both)."""
    require_rbf(cov_fn)
    single = _single(x)
    if not on_cuda(x):
        return ref.posterior_predict(x, z, log_lengthscale, log_variance, w, u, c)
    if single:
        mean, fvar = predict.posterior_predict(
            x[None], z[None], log_lengthscale[None], log_variance.reshape(1),
            w[None], u[None], c[None],
        )
        return mean[0], fvar[0]
    return predict.posterior_predict(x, z, log_lengthscale, log_variance, w, u, c)


def posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c, *, cov_fn=None):
    """One model on S stacked query blocks: hx (S, Q, d) -> (S, Q) pairs
    (the JAX signature; on CUDA the cell-axis kernel with P = 1)."""
    require_rbf(cov_fn)
    if on_cuda(hx):
        mean, fvar = predict.posterior_predict_slots(
            hx[None], z[None], log_lengthscale[None], log_variance.reshape(1),
            w[None], u[None], c[None],
        )
        return mean[0], fvar[0]
    return ref.posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c)


def posterior_predict_slots_stacked(
    hx, z, log_lengthscale, log_variance, w, u, c, *, cov_fn=None
):
    """Every cell's model on its own S blocks: hx (P, S, Q, d) against
    P-stacked factors -> (P, S, Q) pairs, one kernel launch on CUDA."""
    require_rbf(cov_fn)
    if on_cuda(hx):
        return predict.posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c)
    return ref.posterior_predict_slots_stacked(hx, z, log_lengthscale, log_variance, w, u, c)


def _single(x: torch.Tensor) -> bool:
    """True for the single-model signature (x (B, d)), False for the cell
    axis (x (P, B, d)); anything else raises."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (B, d) or (P, B, d), got shape {tuple(x.shape)}")
    return x.dim() == 2


def rbf_cross_cov(x, z, log_lengthscale, log_variance):
    """K(X, Z): x (B, d), z (m, d) -> (B, m), or with a cell axis x (P, B, d),
    z (P, m, d), log_lengthscale (P, d), log_variance (P,) -> (P, B, m) in
    one launch on CUDA. Not differentiable on CUDA (the Pallas kernel has
    no VJP either)."""
    single = _single(x)
    if not on_cuda(x):
        return ref.rbf_cross_cov(x, z, log_lengthscale, log_variance)
    if single:
        return rbf_kernel.rbf_cross_cov(
            x[None], z[None], log_lengthscale[None], log_variance.reshape(1)
        )[0]
    return rbf_kernel.rbf_cross_cov(x, z, log_lengthscale, log_variance)


def lower_inverse(lmm: torch.Tensor) -> torch.Tensor:
    """W = Lmm^{-1} (..., m, m): a library triangular solve, as the JAX
    package leaves it to XLA."""
    eye = torch.eye(lmm.shape[-1], dtype=lmm.dtype, device=lmm.device).expand_as(lmm)
    return torch.linalg.solve_triangular(lmm, eye, upper=False)


def svgp_projection_ref(x, z, log_lengthscale, log_variance, lmm):
    """The plain version with the same signature (also the backward path)."""
    return ref.svgp_projection(x, z, log_lengthscale, log_variance, lower_inverse(lmm))


class SVGPProjection(torch.autograd.Function):
    """Cell-axis fused ELBO projection, the counterpart of the JAX package's
    ``custom_vjp`` ``ops.svgp_projection``: the forward runs the CUDA kernel
    on CUDA tensors (the plain version on CPU ones) after W = Lmm^{-1}; the
    backward recomputes through the plain version from the saved inputs and
    returns its VJP (the kernel has no backward, as the Pallas one has
    none), so a training step launches the kernel exactly once."""

    @staticmethod
    def forward(ctx, x, z, log_lengthscale, log_variance, lmm):
        ctx.save_for_backward(x, z, log_lengthscale, log_variance, lmm)
        w = lower_inverse(lmm)
        if on_cuda(x):
            return svgp_proj.svgp_projection(x, z, log_lengthscale, log_variance, w.contiguous())
        return ref.svgp_projection(x, z, log_lengthscale, log_variance, w)

    @staticmethod
    def backward(ctx, *cotangents):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs, strict=True)]
            outs = svgp_projection_ref(*leaves)
            wanted = [t for t, n in zip(leaves, needs, strict=True) if n]
            grads = iter(torch.autograd.grad(outs, wanted, cotangents, allow_unused=True))
        return tuple(next(grads) if n else None for n in needs)


def svgp_projection(x, z, log_lengthscale, log_variance, lmm):
    """Fused ELBO projection; lmm the lower Cholesky factor of Kmm.

    x (B, d), z (m, d), lmm (m, m) -> (knm (B, m), lk_t (B, m), q_diag (B,)),
    or with a cell axis on every argument -> (P, B, m), (P, B, m), (P, B)
    in one launch on CUDA. Differentiable (:class:`SVGPProjection`)."""
    if _single(x):
        outs = SVGPProjection.apply(
            x[None], z[None], log_lengthscale[None], log_variance.reshape(1), lmm[None]
        )
        return tuple(o[0] for o in outs)
    return SVGPProjection.apply(x, z, log_lengthscale, log_variance, lmm)


def minibatch_draws(dist, mask, batch: int, seed: int, step) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather step's draws: dist a ``sampler.SlotDistribution``, mask
    (P, n_max) -> (kprime (P,), idx (P, B)); one launch on CUDA, on the CPU
    the kernel's plain twin ``ref.minibatch_draws`` (the same bits)."""
    if on_cuda(mask):
        return draws.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, batch, seed, step)
    return ref.minibatch_draws(StepDraws(seed, step, mask.device), dist, mask, batch)
