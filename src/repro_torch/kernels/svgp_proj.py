"""Wrapper of the hand-written CUDA ELBO-projection kernel (``csrc/svgp_proj.cu``).

Replaces the Pallas TPU kernel ``svgp_projection_pallas``
(``repro.kernels.svgp_proj``) on the training path, at any m in [1, MAX_M]
and any d: ONE launch computes, for every cell p and mini-batch row b,

    knm    (P, B, m)  K(x_pb, Z_p)
    lk_t   (P, B, m)  knm @ W_p^T        (W_p = Lmm_p^{-1})
    q_diag (P, B)     ||lk_t||^2 per row

W_p must be lower triangular, as Lmm_p^{-1} is (``ops.lower_inverse``):
the wide body (m >= 17, or d > 4) skips W's tiles above the diagonal, so
a nonzero entry there would give an answer that depends on m. The
wrapper does not check it (that would read W back to the host every
step).

The wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch failed, and adds one to :data:`LAUNCHES`. It takes CUDA tensors
only; the CPU lane is ``ref.svgp_projection``, chosen by ``kernels/ops.py``
(which also owns the autograd rule and ``W = Lmm^{-1}``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.predict import MAX_GRID_YZ, MAX_M

LAUNCHES = launches.counter({"svgp_projection": 0})


def check_problem(
    x, z, log_lengthscale, log_variance, max_m: int = MAX_M
) -> tuple[torch.device, int, int, int, int]:
    """Validate the cell-axis (P, B, d) problem shared by the projection and
    the RBF kernels (m at most ``max_m``); return (device, P, B, m, d)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("x must be a (P, B, d) tensor")
    P, B, d = x.shape
    if d < 1:
        raise ValueError(f"the kernel takes d >= 1 input dims, got {d}")
    if not 1 <= P <= MAX_GRID_YZ or B < 1:
        raise ValueError(f"need 1 <= P <= {MAX_GRID_YZ} and B >= 1, got {(P, B)}")
    if not isinstance(z, torch.Tensor) or z.dim() != 3:
        raise ValueError("z must be (P, m, d)")
    m = z.shape[1]
    if not 1 <= m <= max_m:
        raise ValueError(f"the kernel takes 1 <= m <= {max_m} inducing points, got {m}")
    device = x.device
    if device.type != "cuda":
        raise ValueError(
            f"the CUDA kernels take CUDA tensors, got {device}; CPU tensors go "
            "to the plain versions in repro_torch.kernels.ref"
        )
    build.check_tensor("x", x, (P, B, d), device)
    build.check_tensor("z", z, (P, m, d), device)
    build.check_tensor("log_lengthscale", log_lengthscale, (P, d), device)
    build.check_tensor("log_variance", log_variance, (P,), device)
    return device, P, B, m, d


def svgp_projection(x, z, log_lengthscale, log_variance, w):
    """x (P, B, d); z (P, m, d); log_lengthscale (P, d); log_variance (P,);
    w (P, m, m), lower triangular -> (knm (P, B, m), lk_t (P, B, m),
    q_diag (P, B)). One launch."""
    device, P, B, m, d = check_problem(x, z, log_lengthscale, log_variance)
    build.check_tensor("w", w, (P, m, m), device)
    knm = torch.empty((P, B, m), dtype=torch.float32, device=device)
    lk_t = torch.empty((P, B, m), dtype=torch.float32, device=device)
    q_diag = torch.empty((P, B), dtype=torch.float32, device=device)
    rc = build.library().psvgp_svgp_projection(
        x.data_ptr(), z.data_ptr(), log_lengthscale.data_ptr(), log_variance.data_ptr(),
        w.data_ptr(), knm.data_ptr(), lk_t.data_ptr(), q_diag.data_ptr(),
        P, B, m, d, build.device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"svgp-projection kernel launch failed: cudaError {rc}")
    LAUNCHES["svgp_projection"] += 1
    return knm, lk_t, q_diag
