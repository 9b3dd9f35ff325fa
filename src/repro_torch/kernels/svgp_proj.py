"""Wrapper of the hand-written CUDA ELBO-projection kernel (``csrc/svgp_proj.cu``).

Replaces the Pallas TPU kernel ``svgp_projection_pallas``
(``repro.kernels.svgp_proj``) on the training path: ONE launch computes,
for every cell p and mini-batch row b,

    knm    (P, B, m)  K(x_pb, Z_p)
    lk_t   (P, B, m)  knm @ W_p^T        (W_p = Lmm_p^{-1})
    q_diag (P, B)     ||lk_t||^2 per row

The wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch failed, and adds one to :data:`LAUNCHES`. It takes CUDA tensors
only; the CPU lane is ``ref.svgp_projection``, chosen by ``kernels/ops.py``
(which also owns the autograd rule and ``W = Lmm^{-1}``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.predict import MAX_D, MAX_GRID_YZ, MAX_M, check_tensor, device_index

# kernel launches; ``reset_launches`` zeroes it (chip_smoke.py reads it
# around a fit to show that every training step ran the kernel once)
LAUNCHES = {"svgp_projection": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_problem(x, z, log_lengthscale, log_variance) -> tuple[torch.device, int, int, int, int]:
    """Validate the cell-axis (P, B, d) problem shared by the projection and
    the RBF kernels; return (device, P, B, m, d)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("x must be a (P, B, d) tensor")
    device = x.device
    if device.type != "cuda":
        raise ValueError(
            f"the CUDA kernels take CUDA tensors, got {device}; CPU tensors go "
            "to the plain versions in repro_torch.kernels.ref"
        )
    P, B, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel takes 1 <= d <= {MAX_D} input dims, got {d}")
    if not 1 <= P <= MAX_GRID_YZ or B < 1:
        raise ValueError(f"need 1 <= P <= {MAX_GRID_YZ} and B >= 1, got {(P, B)}")
    if not isinstance(z, torch.Tensor) or z.dim() != 3:
        raise ValueError("z must be (P, m, d)")
    m = z.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"the kernel takes 1 <= m <= {MAX_M} inducing points, got {m}")
    check_tensor("x", x, (P, B, d), device)
    check_tensor("z", z, (P, m, d), device)
    check_tensor("log_lengthscale", log_lengthscale, (P, d), device)
    check_tensor("log_variance", log_variance, (P,), device)
    return device, P, B, m, d


def svgp_projection(x, z, log_lengthscale, log_variance, w):
    """x (P, B, d); z (P, m, d); log_lengthscale (P, d); log_variance (P,);
    w (P, m, m) -> (knm (P, B, m), lk_t (P, B, m), q_diag (P, B)). One launch."""
    device, P, B, m, d = check_problem(x, z, log_lengthscale, log_variance)
    check_tensor("w", w, (P, m, m), device)
    knm = torch.empty((P, B, m), dtype=torch.float32, device=device)
    lk_t = torch.empty((P, B, m), dtype=torch.float32, device=device)
    q_diag = torch.empty((P, B), dtype=torch.float32, device=device)
    rc = build.library().psvgp_svgp_projection(
        x.data_ptr(), z.data_ptr(), log_lengthscale.data_ptr(), log_variance.data_ptr(),
        w.data_ptr(), knm.data_ptr(), lk_t.data_ptr(), q_diag.data_ptr(),
        P, B, m, d, device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"svgp-projection kernel launch failed: cudaError {rc}")
    LAUNCHES["svgp_projection"] += 1
    return knm, lk_t, q_diag
