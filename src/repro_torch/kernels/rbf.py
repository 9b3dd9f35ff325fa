"""Wrapper of the hand-written CUDA RBF cross-covariance kernel
(``csrc/svgp_proj.cu``, entry ``psvgp_rbf_cross_cov``).

Replaces the Pallas TPU kernel ``rbf_cross_cov_pallas``
(``repro.kernels.rbf``): K(X, Z) with a cell axis, x (P, B, d) against
z (P, m, d) -> (P, B, m) in ONE launch. It is the first half of the
projection kernel's body. As in the JAX package, only
``ops.rbf_cross_cov`` reaches it.

Same contract as ``kernels/svgp_proj.py``: CUDA tensors only, checked,
outputs from ``torch.empty``, the current stream, a raise on a failed
launch, one count in :data:`LAUNCHES` per launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.predict import device_index
from repro_torch.kernels.svgp_proj import check_problem

LAUNCHES = {"rbf_cross_cov": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rbf_cross_cov(x, z, log_lengthscale, log_variance):
    """x (P, B, d); z (P, m, d); log_lengthscale (P, d); log_variance (P,)
    -> knm (P, B, m). One launch."""
    device, P, B, m, d = check_problem(x, z, log_lengthscale, log_variance)
    knm = torch.empty((P, B, m), dtype=torch.float32, device=device)
    rc = build.library().psvgp_rbf_cross_cov(
        x.data_ptr(), z.data_ptr(), log_lengthscale.data_ptr(), log_variance.data_ptr(),
        knm.data_ptr(), P, B, m, d, device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"rbf-cross-cov kernel launch failed: cudaError {rc}")
    LAUNCHES["rbf_cross_cov"] += 1
    return knm
