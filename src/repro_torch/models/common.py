"""Shared neural building blocks: norms, RoPE, MLPs, initializers (PyTorch).

Port of ``repro.models.common``. Params are plain nested dicts of tensors,
with the JAX package's key paths, so a checkpoint of either package loads
in the other. The initializers draw from an explicit ``torch.Generator``
on the device the parameters live on (a model is never built on the host
and copied over); their distributions are JAX's, their bits are not.
Norms and RoPE compute in float32 and cast back to the input dtype, as
JAX's do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: tuple[int, ...], in_axis: int = 0,
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    """LeCun-normal in fp32 (params are always fp32; activations may be
    bf16). ``lead`` prepends stacked axes (one draw per period) that do not
    count in the fan-in."""
    fan_in = shape[in_axis]
    out = torch.randn(lead + tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32)
    return out.div_(math.sqrt(fan_in))


def embed_init(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    out = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return out.mul_(0.02)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return (((x32 - mu) * torch.rsqrt(var + eps)) * scale + bias).to(dt)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., dim/2)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) with cos/sin (S, hd/2) — rotate-half convention;
    the tables broadcast as (1, S, 1, hd/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[None, :, None, :].to(torch.float32)
    s = sin[None, :, None, :].to(torch.float32)
    x1f, x2f = x1.to(torch.float32), x2.to(torch.float32)
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             lead: tuple[int, ...] = ()) -> Params:
    zeros = {"dtype": torch.float32, "device": gen.device}
    if kind == "swiglu":
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), lead=lead),
            "w_up": dense_init(gen, (d_model, d_ff), lead=lead),
            "w_down": dense_init(gen, (d_ff, d_model), lead=lead),
        }
    if kind == "gelu":
        return {
            "w_up": dense_init(gen, (d_model, d_ff), lead=lead),
            "b_up": torch.zeros(lead + (d_ff,), **zeros),
            "w_down": dense_init(gen, (d_ff, d_model), lead=lead),
            "b_down": torch.zeros(lead + (d_model,), **zeros),
        }
    raise ValueError(kind)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: its default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        gate = F.silu(x @ p["w_gate"].to(dt))
        return (gate * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    if kind == "gelu":
        h = gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
        return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
    raise ValueError(kind)


def causal_mask(sq: int, skv: int, offset: torch.Tensor | int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """(sq, skv) bool mask: query i attends kv j iff j <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    return kj <= qi


def window_mask(sq: int, skv: int, window: int, offset: torch.Tensor | int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """Causal + sliding window: i - window < j <= i (absolute positions)."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)
