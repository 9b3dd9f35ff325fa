"""Wrappers of the hand-written CUDA prediction kernels (``csrc/predict.cu``).

Two entries into the one kernel body, each replacing a Pallas TPU kernel
of ``repro.kernels.predict``:

  posterior_predict_slots  hx (P, S, Q, d) against P-stacked factors, ONE
                           launch for every cell's S halo blocks — replaces
                           ``posterior_predict_slots_pallas`` (the "fused"
                           lane, the production serving path);
  posterior_predict        x (Q, d) against one model (P = S = 1) —
                           replaces ``posterior_predict_pallas`` (the
                           "pallas" lane).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch failed, and adds one to its entry of :data:`LAUNCHES`. They
take CUDA tensors only; the CPU lanes are the plain versions in
``kernels/ref.py``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_M = 64
MAX_D = 4
MAX_GRID_YZ = 65535

# kernel launches per entry; ``reset_launches`` zeroes them (chip_smoke.py
# reads them around a run of the main path to show it ran the kernels)
LAUNCHES = {"posterior_predict": 0, "posterior_predict_slots": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Refuse what a kernel does not take: a non-tensor, another device,
    another dtype than float32, another shape, a non-contiguous layout."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_index(device: torch.device) -> int:
    """The CUDA ordinal of ``device`` (the current device for bare "cuda")."""
    return device.index if device.index is not None else torch.cuda.current_device()


def _launch(hx, z, log_l, log_var, w, u, c) -> tuple[torch.Tensor, torch.Tensor]:
    """Validate the (P, S, Q, d) problem and run one launch of the kernel."""
    if not isinstance(hx, torch.Tensor) or hx.dim() != 4:
        raise ValueError("hx must be a (P, S, Q, d) tensor")
    device = hx.device
    if device.type != "cuda":
        raise ValueError(
            f"the CUDA prediction kernel takes CUDA tensors, got {device}; "
            "CPU tensors go to the plain versions in repro_torch.kernels.ref"
        )
    P, S, Q, d = hx.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel takes 1 <= d <= {MAX_D} input dims, got {d}")
    if min(P, S, Q) < 1 or P > MAX_GRID_YZ or S > MAX_GRID_YZ:
        raise ValueError(f"need 1 <= P, S <= {MAX_GRID_YZ} and Q >= 1, got {(P, S, Q)}")
    if z.dim() != 3:
        raise ValueError("z must be (P, m, d)")
    m = z.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"the kernel takes 1 <= m <= {MAX_M} inducing points, got {m}")
    check_tensor("hx", hx, (P, S, Q, d), device)
    check_tensor("z", z, (P, m, d), device)
    check_tensor("log_lengthscale", log_l, (P, d), device)
    check_tensor("log_variance", log_var, (P,), device)
    check_tensor("w", w, (P, m, m), device)
    check_tensor("u", u, (P, m, m), device)
    check_tensor("c", c, (P, m), device)
    mean = torch.empty((P, S, Q), dtype=torch.float32, device=device)
    fvar = torch.empty((P, S, Q), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = build.library().psvgp_posterior_predict(
        hx.data_ptr(), z.data_ptr(), log_l.data_ptr(), log_var.data_ptr(),
        w.data_ptr(), u.data_ptr(), c.data_ptr(), mean.data_ptr(), fvar.data_ptr(),
        P, S, Q, m, d, device_index(device), stream,
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
    """x (Q, d); z (m, d); log_lengthscale (d,); log_variance (); w/u
    (m, m); c (m,) -> (mean, fvar) (Q,), fvar un-clamped."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2 or z.dim() != 2:
        raise ValueError("x must be (Q, d) and z (m, d)")
    mean, fvar = _launch(
        x[None, None], z[None], log_lengthscale[None], log_variance.reshape(1),
        w[None], u[None], c[None],
    )
    LAUNCHES["posterior_predict"] += 1
    return mean[0, 0], fvar[0, 0]
