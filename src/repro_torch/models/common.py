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

from repro_torch.sharding.dtensor import linear

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


def rope_angles(positions: torch.Tensor, dim: int, theta: float,
                scaling=None) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., dim/2). ``scaling``, a
    ``config.YaRNConfig``, takes YaRN's frequencies and cos/sin factor
    (:func:`yarn_inv_freq`, :func:`yarn_mscale`)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    if scaling is not None:
        freqs = yarn_inv_freq(freqs, dim, theta, scaling)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., dim/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None:
        factor = yarn_mscale(scaling.factor, scaling.mscale) / yarn_mscale(
            scaling.factor, scaling.mscale_all_dim)
        if factor != 1.0:
            cos, sin = cos * factor, sin * factor
    return cos, sin


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention factor 0.1 m ln(s) + 1 (1 where s <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(dim: int, theta: float, scaling) -> tuple[int, int]:
    """(low, high): the dims whose wavelength turns ``beta_fast`` and
    ``beta_slow`` times over the original context, c(r) = d ln(L / (2 pi
    r)) / (2 ln theta), floored and ceiled and clipped to [0, d - 1]."""
    def c(r):
        return dim * math.log(scaling.original_max_position / (r * 2 * math.pi)) / (
            2 * math.log(theta))

    return max(math.floor(c(scaling.beta_fast)), 0), min(math.ceil(c(scaling.beta_slow)), dim - 1)


def yarn_inv_freq(freqs: torch.Tensor, dim: int, theta: float, scaling) -> torch.Tensor:
    """YaRN's blend of the extrapolated frequencies ``freqs`` (theta^-2i/d)
    and the interpolated ones (``freqs / factor``): i below ``low`` keeps
    its own, i above ``high`` is interpolated, a linear ramp between, as
    DeepSeek-V2's published ``DeepseekV2YarnRotaryEmbedding`` computes it."""
    low, high = yarn_correction_range(dim, theta, scaling)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=freqs.device)
    extra = 1.0 - torch.clamp((i - low) / (high - low), 0, 1)
    return (freqs / scaling.factor) * (1 - extra) + freqs * extra


def deinterleave_pairs(x: torch.Tensor) -> torch.Tensor:
    """(..., d) with rotary pairs adjacent (x0, x1), (x2, x3), ... -> the
    rotate-half layout (x0, x2, ..., x1, x3, ...), as DeepSeek-V2's
    published ``apply_rotary_pos_emb`` reads q and k."""
    d = x.shape[-1]
    return x.reshape(x.shape[:-1] + (d // 2, 2)).transpose(-1, -2).reshape(x.shape)


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
        gate = F.silu(linear(x, p["w_gate"].to(dt)))
        return linear(gate * linear(x, p["w_up"].to(dt)), p["w_down"].to(dt))
    if kind == "gelu":
        h = gelu(linear(x, p["w_up"].to(dt)) + p["b_up"].to(dt))
        return linear(h, p["w_down"].to(dt)) + p["b_down"].to(dt)
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
