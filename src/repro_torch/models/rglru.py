"""The depthwise causal conv of the recurrent blocks (PyTorch).

Port of ``repro.models.rglru._causal_conv``, which the JAX package keeps
beside its RG-LRU block and which the mLSTM block imports from there. The
RG-LRU block itself comes with ``ROADMAP.md`` queue 1, item 6.4.
"""
from __future__ import annotations

import torch


def _causal_conv(u: torch.Tensor, kernel: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv. u (B, S, W), kernel (cw, W), cast to u's dtype.
    state (B, cw-1, W) holds the trailing inputs for streaming decode.
    Returns (out (B, S, W), the new state: the trailing cw - 1 inputs)."""
    cw = kernel.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+cw-1, W)
    S = u.shape[1]
    # JAX's order: Python's sum over the taps, from 0
    out = sum(full[:, i:i + S] * kernel[i].to(u.dtype) for i in range(cw))
    new_state = full[:, -(cw - 1):] if cw > 1 else None
    return out, new_state
