"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM (PyTorch).

Port of ``repro.models.ssm``. mLSTM (matrix memory, Beck et al. 2024):

    C_t = f_t C_{t-1} + i_t v_t k_t^T        (per head; C is dk x dv)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t^T q_t / max(|n_t . q_t|, 1)

Training and prefill use the CHUNKWISE form: within a chunk of 64 tokens
the in-chunk tokens contribute a masked (c x c) matmul, and only the
chunk-boundary states are carried, by a Python loop over the chunks where
JAX scans. f = sigmoid(f~), i = exp(min(i~, 8)); decode is the exact
one-step recurrence. The sLSTM (scalar memory, h_{t-1} feedback) is a
Python loop over the positions with stabilized exponential gating, its
carries (c, n, h, m) in float32.

The dtype flow is JAX's: q, k, v are cast to float32 in a chunk, but the
decode step forms k v^T in the activation dtype before the float32 gate
multiplies it; k / sqrt(dh) divides by the scalar rounded to the
activation dtype (JAX's weak-typed scalar); gate preactivations are cast
to float32 before the bias is added; the sLSTM's recurrent weights are
cast back up to float32 (the model's one-shot cast rounded them first).
Where JAX returns new cache leaves, a given cache is written in place
(its tensors are views of the model's stacked cache) and returned.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import _causal_conv
from repro_torch.sharding.dtensor import batch_local, head_reshape

_ICLAMP = 8.0  # clamp on the exp input-gate preactivation
_F32 = torch.float32


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def _mlstm_dims(cfg: ModelConfig):
    inner = cfg.rnn_width or 2 * cfg.d_model
    H = cfg.num_heads
    dh = inner // H  # per-head q/k/v dim
    return inner, H, dh


def init_mlstm_params(gen: torch.Generator, cfg: ModelConfig,
                      lead: tuple[int, ...] = ()) -> Params:
    D = cfg.d_model
    inner, H, dh = _mlstm_dims(cfg)
    cw = cfg.conv_width
    f32 = {"dtype": _F32, "device": gen.device}
    b_if = torch.cat([torch.zeros((H,), **f32), torch.full((H,), 3.0, **f32)])
    return {
        "w_up": dense_init(gen, (D, inner), lead=lead),  # main branch
        "w_gate": dense_init(gen, (D, inner), lead=lead),  # output gating branch
        "conv": torch.randn(lead + (cw, inner), generator=gen, **f32).div_(cw),
        "wq": dense_init(gen, (inner, inner), lead=lead),
        "wk": dense_init(gen, (inner, inner), lead=lead),
        "wv": dense_init(gen, (inner, inner), lead=lead),
        "w_if": dense_init(gen, (inner, 2 * H), lead=lead),  # input & forget gates per head
        "b_if": b_if.expand(lead + (2 * H,)).clone(),
        "out_norm": torch.ones(lead + (inner,), **f32),
        "w_down": dense_init(gen, (inner, D), lead=lead),
    }


def _chunk_mlstm(q, k, v, i_gate, f_gate, state, norm):
    """One chunk. q,k,v (B,H,c,dh); i/f gates (B,H,c); state (B,H,dh,dh);
    norm (B,H,dh). Returns h (B,H,c,dh), new state, new norm."""
    c = q.shape[2]
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    logf = torch.log(f_gate + 1e-12)  # <= 0
    cum = torch.cumsum(logf, dim=-1)  # (B,H,c) log d_t
    d = torch.exp(cum)
    # intra-chunk "attention": A[t,s] = (d_t/d_s) i_s (q_t . k_s), s <= t;
    # the exp is taken before the mask, as JAX's
    ratio = torch.exp(cum[..., :, None] - cum[..., None, :])  # (B,H,c,c) = d_t/d_s
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ratio = torch.where(mask, ratio, 0.0)
    decay_w = ratio * i_gate[..., None, :]  # (B,H,t,s) = (d_t/d_s) i_s, masked
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * decay_w
    intra = torch.einsum("bhts,bhsd->bhtd", scores, v)
    # normalizer numerator n_t = d_t n_0 + sum_s (d_t/d_s) i_s k_s (q-free)
    intra_n = torch.einsum("bhts,bhsd->bhtd", decay_w, k)
    # inter-chunk: contribution of the incoming state
    inter = d[..., None] * torch.einsum("bhtd,bhde->bhte", q, state)
    inter_n = d[..., None] * norm[:, :, None, :]
    h_num = intra + inter
    n_vec = intra_n + inter_n  # (B,H,c,dh)
    denom = torch.clamp_min(torch.abs(torch.einsum("bhtd,bhtd->bht", n_vec, q)), 1.0)
    h = h_num / denom[..., None]
    # chunk-end state: C_c = d_c C_0 + sum_s (d_c/d_s) i_s k_s v_s^T
    w = (torch.exp(cum[..., -1:] - cum) * i_gate)[..., None]  # (B,H,c,1)
    new_state = d[..., -1, None, None] * state + torch.einsum("bhsd,bhse->bhde", k * w, v)
    new_norm = d[..., -1, None] * norm + torch.sum(k * w, dim=2)
    return h, new_state, new_norm


def mlstm_forward(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    cache: Params | None = None,
    chunk: int = 64,
) -> tuple[torch.Tensor, Params | None]:
    """x (B, S, D) -> (out, cache {"conv","state","norm"}); a given cache
    is written in place."""
    B, S, D = x.shape
    inner, H, dh = _mlstm_dims(cfg)
    dt = x.dtype
    z = x @ p["w_gate"].to(dt)  # output gate branch
    u = x @ p["w_up"].to(dt)
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, p["conv"], conv_state)
    u = F.silu(u)

    def heads(w):
        return head_reshape(u @ w.to(dt), (B, S, H, dh), H).transpose(1, 2)

    # JAX divides by sqrt(dh) as a weak-typed scalar: rounded to dt first
    rsd = torch.tensor(math.sqrt(dh), dtype=dt, device=x.device)
    q, k, v = heads(p["wq"]), heads(p["wk"]) / rsd, heads(p["wv"])
    gates = (u @ p["w_if"].to(dt)).to(_F32) + p["b_if"]  # (B,S,2H)
    i_gate = torch.exp(torch.clamp_max(gates[..., :H], _ICLAMP)).transpose(1, 2)  # (B,H,S)
    f_gate = torch.sigmoid(gates[..., H:]).transpose(1, 2)

    if cache is not None:
        state, norm = cache["state"].to(_F32), cache["norm"].to(_F32)
    else:
        state = torch.zeros((B, H, dh, dh), dtype=_F32, device=x.device)
        norm = torch.zeros((B, H, dh), dtype=_F32, device=x.device)

    if S == 1 and cache is not None:
        # decode: exact single-step recurrence; k v^T in dt, then the gate
        f1 = f_gate[..., 0][..., None, None]
        i1 = i_gate[..., 0][..., None, None]
        new_state = f1 * state + i1 * (k[:, :, 0, :, None] * v[:, :, 0, None, :])
        new_norm = f1[..., 0] * norm + i1[..., 0] * k[:, :, 0]
        q0 = q[:, :, 0].to(_F32)
        hq = torch.einsum("bhde,bhd->bhe", new_state, q0)
        den = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", new_norm, q0)), 1.0)
        h = (hq / den[..., None])[:, :, None]  # (B,H,1,dh)
    else:
        def chunks(q, k, v, i_gate, f_gate, state, norm):
            pad = (-S) % chunk
            if pad:
                q, k, v, i_gate = (F.pad(a, (0, 0, 0, pad)) if a.ndim == 4
                                   else F.pad(a, (0, pad)) for a in (q, k, v, i_gate))
                f_gate = F.pad(f_gate, (0, pad), value=1.0)
            hs = []
            for ci in range(q.shape[2] // chunk):
                sl = slice(ci * chunk, (ci + 1) * chunk)
                h, state, norm = _chunk_mlstm(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                              i_gate[..., sl], f_gate[..., sl], state, norm)
                hs.append(h)
            return torch.cat(hs, dim=2)[:, :, :S], state, norm

        # row by row: a sharded trace runs the chunks on each rank's rows
        h, new_state, new_norm = batch_local(chunks, (q, k, v, i_gate, f_gate, state, norm))

    hflat = head_reshape(h.transpose(1, 2), (B, S, inner), H, dim=2).to(dt)
    hflat = rms_norm(hflat, p["out_norm"], cfg.norm_eps)
    out = (hflat * F.silu(z)) @ p["w_down"].to(dt)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
        cache["norm"].copy_(new_norm)
    return out, cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device=None,
                     lead: tuple[int, ...] = ()) -> Params:
    inner, H, dh = _mlstm_dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, inner), dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, H, dh, dh), dtype=_F32, device=device),
        "norm": torch.zeros(lead + (batch, H, dh), dtype=_F32, device=device),
    }


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def init_slstm_params(gen: torch.Generator, cfg: ModelConfig,
                      lead: tuple[int, ...] = ()) -> Params:
    D = cfg.d_model
    W = cfg.rnn_width or cfg.d_model
    f32 = {"dtype": _F32, "device": gen.device}
    b = torch.zeros(lead + (4 * W,), **f32)
    b[..., 2 * W:3 * W] = 1.0  # forget-gate bias
    return {
        "w_in": dense_init(gen, (D, 4 * W), lead=lead),  # z, i, f, o preactivations
        "r": dense_init(gen, (W, 4 * W), lead=lead),  # recurrent weights (h feedback)
        "b": b,
        "out_norm": torch.ones(lead + (W,), **f32),
        "w_down": dense_init(gen, (W, D), lead=lead),
    }


def slstm_forward(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    cache: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Sequential sLSTM with stabilized exponential gating: carries (c, n,
    h, m) — cell, normalizer, hidden, log-max stabilizer — in float32; a
    given cache is written in place."""
    B, S, D = x.shape
    W = cfg.rnn_width or cfg.d_model
    dt = x.dtype
    pre = (x @ p["w_in"].to(dt)).to(_F32)  # (B,S,4W)

    if cache is not None:
        c, n, h, m = (cache[k].to(_F32) for k in ("c", "n", "h", "m"))
    else:
        c = n = h = torch.zeros((B, W), dtype=_F32, device=x.device)
        m = torch.full((B, W), -1e30, dtype=_F32, device=x.device)

    def scan(pre, c, n, h, m, r, b):
        hs = []
        for t in range(S):
            g = pre[:, t] + h @ r + b  # (B, 4W)
            z_t = torch.tanh(g[:, :W])
            i_t = g[:, W:2 * W]  # log-space input gate
            f_t = F.logsigmoid(g[:, 2 * W:3 * W])  # log forget
            o_t = torch.sigmoid(g[:, 3 * W:])
            m2 = torch.maximum(f_t + m, i_t)
            ip = torch.exp(i_t - m2)
            fp = torch.exp(f_t + m - m2)
            c = fp * c + ip * z_t
            n = fp * n + ip
            h = o_t * c / torch.clamp_min(n, 1.0)
            m = m2
            hs.append(h)
        return torch.stack(hs, dim=1), c, n, h, m  # (B,S,W)

    # row by row: a sharded trace runs the loop on each rank's rows
    hseq, c, n, h, m = batch_local(scan, (pre, c, n, h, m), (p["r"].to(_F32), p["b"]))
    hseq = hseq.to(dt)
    hseq = rms_norm(hseq, p["out_norm"], cfg.norm_eps)
    out = hseq @ p["w_down"].to(dt)
    if cache is not None:
        for key, val in (("c", c), ("n", n), ("h", h), ("m", m)):
            cache[key].copy_(val)
    return out, cache


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype, device=None,
                     lead: tuple[int, ...] = ()) -> Params:
    """The carries, float32 whatever ``dtype`` (JAX's); m starts at -1e30."""
    W = cfg.rnn_width or cfg.d_model
    shape = lead + (batch, W)

    def z():
        return torch.zeros(shape, dtype=_F32, device=device)

    return {"c": z(), "n": z(), "h": z(), "m": torch.full(shape, -1e30, dtype=_F32,
                                                            device=device)}
