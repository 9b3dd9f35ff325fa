"""The one device rule of the port's entry points.

An entry point that is not told where to run uses ``"cuda"``, and a
machine without a CUDA device raises instead of quietly serving from the
CPU: a number measured on the CPU must never pass for a GPU number. The
CPU lanes (plain PyTorch versions of every kernel) run only when the
caller asks for them with ``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request on a machine without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by default "
            "— pass device='cpu' to run its plain PyTorch lanes on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
