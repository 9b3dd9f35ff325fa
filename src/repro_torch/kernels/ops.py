"""Dispatch between the CUDA kernels and their plain versions.

The rule is the tensor's device and nothing else: a CPU tensor goes to the
plain PyTorch version (``kernels/ref.py``); a CUDA tensor launches the
kernel (``kernels/predict.py``) or raises — there is no fallback. Unlike
the JAX package's ``repro.kernels.ops`` there is no padding here: the
kernel takes any m <= 64 and any Q >= 1 as they are.
"""
from __future__ import annotations

import torch

from repro_torch.gp.covariances import rbf as _rbf_covariance
from repro_torch.kernels import predict, ref


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


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"tensors must be on 'cuda' or 'cpu', got {x.device}")


def posterior_predict(x, z, log_lengthscale, log_variance, w, u, c, *, cov_fn=None):
    """x (Q, d) against one model -> (mean (Q,), fvar (Q,)), fvar
    un-clamped and without noise (callers own both)."""
    require_rbf(cov_fn)
    if _on_cuda(x):
        return predict.posterior_predict(x, z, log_lengthscale, log_variance, w, u, c)
    return ref.posterior_predict(x, z, log_lengthscale, log_variance, w, u, c)


def posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c, *, cov_fn=None):
    """One model on S stacked query blocks: hx (S, Q, d) -> (S, Q) pairs
    (the JAX signature; on CUDA the cell-axis kernel with P = 1)."""
    require_rbf(cov_fn)
    if _on_cuda(hx):
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
    if _on_cuda(hx):
        return predict.posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c)
    return ref.posterior_predict_slots_stacked(hx, z, log_lengthscale, log_variance, w, u, c)
