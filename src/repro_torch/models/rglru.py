"""RG-LRU temporal-mixing block (Griffin / RecurrentGemma) in PyTorch.

Port of ``repro.models.rglru``. Block structure (De et al. 2024,
arXiv:2402.19427):

    x -> [branch a] linear -> GeLU
      -> [branch b] linear -> causal conv1d(w=4) -> RG-LRU
    out = W_out (a * b)

RG-LRU recurrence (per channel), in float32:

    r_t = sigmoid(W_r u_t),  i_t = sigmoid(W_i u_t)
    a_t = exp(c * r_t * (-softplus(lam)))          # lam learned, c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Where JAX takes ``jax.lax.associative_scan`` over the sequence, the port
takes a log-step (Hillis-Steele) scan: ceil(log2 S) whole-tensor passes of
(a, b) <- (a_t a_{t-k}, a_t b_{t-k} + b_t), no loop over positions. The two
scans associate the products differently, so they agree to float32
rounding, not bitwise. Decode is the exact one-step update with (conv
window, h) carried as cache; a given cache is written in place (its
tensors are views of the model's stacked cache). ``causal_conv`` is
shared with the mLSTM block (``models/ssm.py``), as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import Params, dense_init, gelu
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.dtensor import batch_local, linear

_C = 8.0
_F32 = torch.float32


def init_rglru_params(gen: torch.Generator, cfg: ModelConfig,
                      lead: tuple[int, ...] = ()) -> Params:
    D = cfg.d_model
    W = cfg.rnn_width or cfg.d_model
    cw = cfg.conv_width
    f32 = {"dtype": _F32, "device": gen.device}
    # lam init so that a^c spreads over ~(0.9, 0.999) (Griffin's init range)
    u = torch.rand(lead + (W,), generator=gen, **f32).mul_(0.999 - 0.9).add_(0.9)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^{-1}(-log u / c)
    return {
        "w_a": dense_init(gen, (D, W), lead=lead),
        "w_b": dense_init(gen, (D, W), lead=lead),
        "conv": torch.randn(lead + (cw, W), generator=gen, **f32).div_(cw ** 0.5),
        "w_r": dense_init(gen, (W, W), lead=lead),
        "w_i": dense_init(gen, (W, W), lead=lead),
        "lam": lam,
        "w_out": dense_init(gen, (W, D), lead=lead),
    }


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


def causal_conv(u: torch.Tensor, kernel: torch.Tensor, state: torch.Tensor | None):
    """:func:`_causal_conv`; sharded, each rank convolves its rows and its
    channels (the conv is depthwise)."""
    return batch_local(lambda u, state, kernel: _causal_conv(u, kernel, state), (u, state),
                       (kernel,), split=(2, 2, 1), out_split=(2, 2))


def _gate_scan(u, r, i, h0, lam, one_step: bool):
    """The gated recurrence of u, r, i (B, S, W) from h0 (B, W) fp32 (None:
    from 0), channel by channel: (h (B, S, W) fp32,)."""
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus is linear past 20)
    sp = torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-_C * r * sp)  # (B,S,W) fp32, in (0, 1]
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i * u.to(_F32)
    if h0 is None:
        return (_rglru_scan(gated, a, None),)
    if not one_step:
        return (_rglru_scan(gated, a, h0),)
    return ((a[:, 0] * h0 + gated[:, 0])[:, None],)


def _rglru_scan(u: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t over axis 1 by a log-step scan. u, a (B, S, W);
    h0 (B, W) or None (h_{-1} = 0)."""
    if h0 is not None:
        # fold the initial state in as a virtual step 0 (a = 0), as JAX does
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        u = torch.cat([h0[:, None].to(u.dtype), u], dim=1)
    k, S = 1, a.shape[1]
    while k < S:
        # the element t takes in the prefix ending at t - k
        u = torch.cat([u[:, :k], a[:, k:] * u[:, :-k] + u[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return u[:, 1:] if h0 is not None else u


def rglru_forward(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    cache: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """x (B, S, D) -> (out (B, S, D), cache {"conv", "h"}). Three modes: the
    full sequence (no cache), a prefill from the cache's h (S > 1) and the
    exact one-step decode (S == 1); a given cache is written in place."""
    dt = x.dtype
    branch_a = gelu(linear(x, p["w_a"].to(dt)))  # (B,S,W)
    u = linear(x, p["w_b"].to(dt))
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = causal_conv(u, p["conv"], conv_state)

    r = torch.sigmoid(linear(u, p["w_r"].to(dt))).to(_F32)
    i = torch.sigmoid(linear(u, p["w_i"].to(dt))).to(_F32)
    h0 = cache["h"].to(_F32) if cache is not None else None
    # channel by channel: sharded, each rank its rows and its channels
    (h,) = batch_local(lambda *a: _gate_scan(*a, one_step=x.shape[1] == 1), (u, r, i, h0),
                       (p["lam"],), split=(2, 2, 2, 1, 0), out_split=(2,))
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h[:, -1])

    out = linear(branch_a * h.to(dt), p["w_out"].to(dt))
    return out, cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device=None,
                     lead: tuple[int, ...] = ()) -> Params:
    W = cfg.rnn_width or cfg.d_model
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, W), dtype=dtype, device=device),
        "h": torch.zeros(lead + (batch, W), dtype=_F32, device=device),  # h stays fp32
    }
