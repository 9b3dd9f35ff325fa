"""Wrappers of the hand-written CUDA prediction kernels (``csrc/predict.cu``).

Two entries into the kernel, each replacing a Pallas TPU kernel of
``repro.kernels.predict``, each ONE launch over a cell axis:

  posterior_predict_slots  hx (P, S, Q, d) against P-stacked factors, every
                           cell's S halo blocks — replaces
                           ``posterior_predict_slots_pallas`` (the "fused"
                           lane, the production serving path);
  posterior_predict        x (P, Q, d) against P-stacked factors, every
                           cell's one block (S = 1) — replaces
                           ``posterior_predict_pallas`` (the "pallas" lane,
                           where the JAX package vmaps it over the cells).

Both take any m in [1, MAX_M] and any d: m <= 64 with d <= 4 runs the
narrow body (templates on m and d), the rest the wide body (csrc/
predict.cu), chosen by m and d alone.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch failed, and adds one to its entry of :data:`LAUNCHES`. They
take CUDA tensors only; the CPU lanes are the plain versions in
``kernels/ref.py``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launches

MAX_M = 2048  # the wide body's limit: a block's knm tile in shared memory
MAX_GRID_YZ = 65535

LAUNCHES = launches.counter({"posterior_predict": 0, "posterior_predict_slots": 0})


def _launch(hx, z, log_l, log_var, w, u, c) -> tuple[torch.Tensor, torch.Tensor]:
    """Validate the (P, S, Q, d) problem and run one launch of the kernel."""
    if not isinstance(hx, torch.Tensor) or hx.dim() != 4:
        raise ValueError("hx must be a (P, S, Q, d) tensor")
    P, S, Q, d = hx.shape
    if d < 1:
        raise ValueError(f"the kernel takes d >= 1 input dims, got {d}")
    if min(P, S, Q) < 1 or P > MAX_GRID_YZ or S > MAX_GRID_YZ:
        raise ValueError(f"need 1 <= P, S <= {MAX_GRID_YZ} and Q >= 1, got {(P, S, Q)}")
    if z.dim() != 3:
        raise ValueError("z must be (P, m, d)")
    m = z.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"the kernel takes 1 <= m <= {MAX_M} inducing points, got {m}")
    device = hx.device
    if device.type != "cuda":
        raise ValueError(
            f"the CUDA prediction kernel takes CUDA tensors, got {device}; "
            "CPU tensors go to the plain versions in repro_torch.kernels.ref"
        )
    build.check_tensor("hx", hx, (P, S, Q, d), device)
    build.check_tensor("z", z, (P, m, d), device)
    build.check_tensor("log_lengthscale", log_l, (P, d), device)
    build.check_tensor("log_variance", log_var, (P,), device)
    build.check_tensor("w", w, (P, m, m), device)
    build.check_tensor("u", u, (P, m, m), device)
    build.check_tensor("c", c, (P, m), device)
    mean = torch.empty((P, S, Q), dtype=torch.float32, device=device)
    fvar = torch.empty((P, S, Q), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = build.library().psvgp_posterior_predict(
        hx.data_ptr(), z.data_ptr(), log_l.data_ptr(), log_var.data_ptr(),
        w.data_ptr(), u.data_ptr(), c.data_ptr(), mean.data_ptr(), fvar.data_ptr(),
        P, S, Q, m, d, build.device_index(device), stream,
    )
    if rc != 0:
        raise RuntimeError(f"posterior-predict kernel launch failed: cudaError {rc}")
    return mean, fvar


def posterior_predict_slots(hx, z, log_lengthscale, log_variance, w, u, c):
    """hx (P, S, Q, d); z (P, m, d); log_lengthscale (P, d); log_variance
    (P,); w/u (P, m, m); c (P, m) -> (mean, fvar) (P, S, Q), fvar
    un-clamped. One launch over every cell and slot."""
    out = _launch(hx, z, log_lengthscale, log_variance, w, u, c)
    LAUNCHES["posterior_predict_slots"] += 1
    return out


def posterior_predict(x, z, log_lengthscale, log_variance, w, u, c):
    """x (P, Q, d) against P-stacked factors z (P, m, d), log_lengthscale
    (P, d), log_variance (P,), w/u (P, m, m), c (P, m) -> (mean, fvar)
    (P, Q), fvar un-clamped. One launch over every cell."""
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError("x must be a (P, Q, d) tensor")
    mean, fvar = _launch(x[:, None], z, log_lengthscale, log_variance, w, u, c)
    LAUNCHES["posterior_predict"] += 1
    return mean[:, 0], fvar[:, 0]
