"""Grouped-query attention (w/ qk-norm, biases, sliding window) in PyTorch.

Port of the GQA half of ``repro.models.attention``: ``einsum`` logits in
float32, a ``-1e30`` mask fill (not ``-inf``, so a fully masked row stays
finite, as in JAX), a float32 softmax whose weights are cast back to the
query dtype. Cross-attention (``encoder_kv``): the queries of ``wq``
alone (no bias, rope or qk-norm) against given keys and values, unmasked.

MLA (Multi-head Latent Attention, DeepSeek-V2 / MiniCPM3) is the port of
JAX's ``init_mla_params`` / ``mla_forward`` / ``init_mla_cache``: train and
prefill expand the latents to per-head keys and values (query-chunked
under ``attn_q_chunk``, each chunk recomputed in the backward); decode is
ABSORBED, attending against the compressed latents ``c_kv`` (B, S, r) and
the shared rope keys ``k_rope`` (B, S, dr) of the cache, written in place.

Cache convention (serve path): a dict per attention block,
  {"k": (B, S_cache, KV, hd), "v": (B, S_cache, KV, hd)}
plus the write position carried by the caller. Sliding-window blocks
allocate only ``window`` slots and write modulo window (a ring buffer).
Where JAX returns an updated copy of the cache, the port writes the new
keys and values into the given cache tensors in place (they are views of
the model's stacked cache) and returns the same dict.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (
    Params,
    apply_rope,
    causal_mask,
    dense_init,
    rms_norm,
    rope_angles,
    window_mask,
)
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.sharding.dtensor import head_reshape, heads_local, is_dtensor, write_slot

_NEG_INF = -1e30


def init_gqa_params(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    f32 = {"dtype": torch.float32, "device": gen.device}
    p = {
        "wq": dense_init(gen, (D, H * hd), lead=lead),
        "wk": dense_init(gen, (D, KV * hd), lead=lead),
        "wv": dense_init(gen, (D, KV * hd), lead=lead),
        "wo": dense_init(gen, (H * hd, D), lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H * hd,), **f32)
        p["bk"] = torch.zeros(lead + (KV * hd,), **f32)
        p["bv"] = torch.zeros(lead + (KV * hd,), **f32)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), **f32)
        p["k_norm"] = torch.ones(lead + (hd,), **f32)
    return p


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = head_reshape(q, (B, S, H, hd), H)
    k = head_reshape(k, (B, S, KV, hd), KV)
    v = head_reshape(v, (B, S, KV, hd), KV)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _sdpa(q, k, v, mask, num_kv: int) -> torch.Tensor:
    """Grouped scaled-dot-product attention.
    q (B,S,H,hd), k/v (B,T,KV,hd), mask (S,T) or (B,S,T) bool. Sharded
    (DTensors), each rank attends its own rows and heads
    (``sharding.dtensor.heads_local``)."""
    if is_dtensor(q) or is_dtensor(k):
        return heads_local(lambda q, k, v: _sdpa_core(q, k, v, mask, k.shape[2]), (q, k, v),
                           (2, 2, 2))
    return _sdpa_core(q, k, v, mask, num_kv)


def _sdpa_core(q, k, v, mask, num_kv: int) -> torch.Tensor:
    B, S, H, hd = q.shape
    G = H // num_kv
    qg = head_reshape(q, (B, S, num_kv, G, hd), num_kv, dim=2)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    logits = logits / math.sqrt(hd)
    m = mask if mask.ndim == 3 else mask[None]
    logits = torch.where(m[:, None, None, :, :], logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return head_reshape(out, (B, S, H, hd), num_kv, dim=2)


def _sdpa_chunked(q, k, v, num_kv: int, window: int, chunk: int) -> torch.Tensor:
    """Query-chunked causal/windowed attention: the (.., S, S) float32
    logits are serialized to (.., chunk, S) chunks, each recomputed in the
    backward (``torch.utils.checkpoint`` for ``jax.checkpoint``; the same
    math, reassociated)."""
    B, S, H, hd = q.shape
    grad = torch.is_grad_enabled()

    def body(qi, off):
        m = (window_mask(qi.shape[1], S, window, off, q.device) if window
             else causal_mask(qi.shape[1], S, off, q.device))
        return _sdpa(qi, k, v, m, num_kv)

    outs = []
    for ci in range(S // chunk):
        qi = q[:, ci * chunk:(ci + 1) * chunk]
        if grad:
            outs.append(checkpoint(body, qi, ci * chunk, use_reentrant=False))
        else:
            outs.append(body(qi, ci * chunk))
    return torch.cat(outs, dim=1)


def _write(buf: torch.Tensor, slot, new: torch.Tensor) -> None:
    """buf[:, slot] = new[:, 0] in place; ``slot`` a host int or a () tensor
    on buf's device (no host sync either way); a DTensor cache is written
    shard by shard (``sharding.dtensor.write_slot``)."""
    if is_dtensor(buf):
        write_slot(buf, slot, new)
    elif isinstance(slot, torch.Tensor):
        buf.index_copy_(1, slot.reshape(1).to(torch.long), new.to(buf.dtype))
    else:
        buf[:, slot] = new[:, 0].to(buf.dtype)


def gqa_forward(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int = 0,
    cache: Params | None = None,
    cache_pos: torch.Tensor | int | None = None,
    encoder_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """One attention call.

    Modes:
      train: cache None — the full sequence, causal (windowed) mask;
      prefill: x (B, S > 1, D), cache allocated — attend within the prompt
        and fill the cache;
      decode: x (B, 1, D), cache holds history, cache_pos = current length;
      cross-attention: encoder_kv (k, v), each (B, T, KV, hd), given — no
        cache, no causal mask (returns None for the cache).
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = x.dtype
    dev = x.device

    if encoder_kv is not None:
        k, v = encoder_kv
        q = head_reshape(x @ p["wq"].to(dt), (B, S, H, hd), H)
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=dev)
        out = _sdpa(q, k, v, mask, KV)
        return head_reshape(out, (B, S, H * hd), H, dim=2) @ p["wo"].to(dt), None

    q, k, v = _qkv(p, cfg, x)
    if cfg.pos_kind == "rope":
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is None:
        # --- training: full sequence ---
        qc = cfg.attn_q_chunk
        if qc and S > qc and S % qc == 0:
            out = _sdpa_chunked(q, k, v, KV, window, qc)
        else:
            mask = window_mask(S, S, window, device=dev) if window else causal_mask(S, S, device=dev)
            out = _sdpa(q, k, v, mask, KV)
    elif S > 1:
        # --- prefill: fill the cache, attend within the prompt ---
        mask = window_mask(S, S, window, device=dev) if window else causal_mask(S, S, device=dev)
        out = _sdpa(q, k, v, mask, KV)
        Sc = cache["k"].shape[1]
        if window and S >= Sc:
            # ring cache: slot s holds the key of absolute position
            # base + (s - base) % Sc (the unique position in [S-Sc, S) that
            # decode's slot = pos % Sc addressing maps to slot s); torch's %
            # takes the divisor's sign, as jnp's does
            base = S - Sc
            take_ids = base + (torch.arange(Sc, device=dev) - base) % Sc
            cache["k"].copy_(k[:, take_ids])
            cache["v"].copy_(v[:, take_ids])
        else:
            # slots [0, S) in order (a window longer than the prompt, or
            # the full cache)
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    else:
        # --- decode: single step against the cache ---
        kk, vv = cache["k"], cache["v"]
        Sc = kk.shape[1]
        slot = (cache_pos % Sc) if window else cache_pos
        _write(kk, slot, k)
        _write(vv, slot, v)
        ar = torch.arange(Sc, device=dev)
        if window:
            valid = (ar <= slot) | (cache_pos >= Sc)  # ring full => all valid
        else:
            valid = ar <= cache_pos
        mask = valid[None, None, :]  # (B=1bc, S=1, T)
        out = _sdpa(q, kk.to(dt), vv.to(dt), mask, KV)

    return head_reshape(out, (B, S, H * hd), H, dim=2) @ p["wo"].to(dt), cache


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int, window: int, dtype,
                   device=None, lead: tuple[int, ...] = ()) -> Params:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    Sc = min(seq, window) if window else seq
    return {
        "k": torch.zeros(lead + (batch, Sc, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros(lead + (batch, Sc, KV, hd), dtype=dtype, device=device),
    }


# --------------------------------------------------------------------------
# MLA (Multi-head Latent Attention)
# --------------------------------------------------------------------------


def init_mla_params(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> Params:
    a: MLAConfig = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qd = a.qk_nope_head_dim + a.qk_rope_head_dim
    ones = {"dtype": torch.float32, "device": gen.device}
    return {
        "w_dq": dense_init(gen, (D, a.q_lora_rank), lead=lead),
        "q_norm": torch.ones(lead + (a.q_lora_rank,), **ones),
        "w_uq": dense_init(gen, (a.q_lora_rank, H * qd), lead=lead),
        "w_dkv": dense_init(gen, (D, a.kv_lora_rank), lead=lead),
        "kv_norm": torch.ones(lead + (a.kv_lora_rank,), **ones),
        "w_kr": dense_init(gen, (D, a.qk_rope_head_dim), lead=lead),
        "w_uk": dense_init(gen, (a.kv_lora_rank, H * a.qk_nope_head_dim), lead=lead),
        "w_uv": dense_init(gen, (a.kv_lora_rank, H * a.v_head_dim), lead=lead),
        "wo": dense_init(gen, (H * a.v_head_dim, D), lead=lead),
    }


def mla_forward(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Params | None = None,
    cache_pos: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """One MLA call; modes as :func:`gqa_forward`'s (train, prefill,
    decode). The cache is written in place and returned."""
    a: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv, r = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim, a.kv_lora_rank
    dt = x.dtype
    dev = x.device
    # float32 1 / sqrt(dn + dr), both ops rounded in float32 as JAX's
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dn + dr)))

    cq = rms_norm(x @ p["w_dq"].to(dt), p["q_norm"], cfg.norm_eps)
    q = head_reshape(cq @ p["w_uq"].to(dt), (B, S, H, dn + dr), H)
    qn, qr = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    qr = apply_rope(qr, cos, sin)

    c_kv = rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"], cfg.norm_eps)  # (B, S, r)
    kr = (x @ p["w_kr"].to(dt)).reshape(B, S, 1, dr)
    kr = apply_rope(kr, cos, sin)[:, :, 0]  # (B, S, dr), shared across heads

    if cache is None or S > 1:
        # train / prefill: expand the latents
        kn = head_reshape(c_kv @ p["w_uk"].to(dt), (B, S, H, dn), H)
        v = head_reshape(c_kv @ p["w_uv"].to(dt), (B, S, H, dv), H)

        def attend(qn_i, qr_i, kn, kr, v, off):
            lg = (torch.einsum("bshd,bthd->bhst", qn_i, kn)
                  + torch.einsum("bshd,btd->bhst", qr_i, kr)).to(torch.float32) * scale
            m = causal_mask(qn_i.shape[1], S, off, dev)
            lg = torch.where(m[None, None], lg, _NEG_INF)
            w = torch.softmax(lg, dim=-1).to(dt)
            return torch.einsum("bhst,bthd->bshd", w, v)

        def block(qn_i, qr_i, off):  # sharded: each rank its rows and heads
            return heads_local(lambda *a: attend(*a, off), (qn_i, qr_i, kn, kr, v),
                               (2, 2, 2, None, 2))

        qc = cfg.attn_q_chunk
        if cache is None and qc and S > qc and S % qc == 0:
            # query-chunked, each chunk recomputed in the backward
            grad = torch.is_grad_enabled()
            outs = []
            for ci in range(S // qc):
                sl = slice(ci * qc, (ci + 1) * qc)
                if grad:
                    outs.append(checkpoint(block, qn[:, sl], qr[:, sl], ci * qc,
                                           use_reentrant=False))
                else:
                    outs.append(block(qn[:, sl], qr[:, sl], ci * qc))
            out = head_reshape(torch.cat(outs, dim=1), (B, S, H * dv), H, dim=2)
        else:
            out = head_reshape(block(qn, qr, 0), (B, S, H * dv), H, dim=2)
        if cache is not None:
            # the prefill writes the latents at offset 0
            cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
            cache["k_rope"][:, :S] = kr.to(cache["k_rope"].dtype)
    else:
        # decode: ABSORBED attention against the compressed latents
        ck, kk = cache["c_kv"], cache["k_rope"]
        _write(ck, cache_pos, c_kv)
        _write(kk, cache_pos, kr)
        T = ck.shape[1]
        w_uk = head_reshape(p["w_uk"].to(dt), (r, H, dn), H)
        q_lat = torch.einsum("bshd,rhd->bshr", qn, w_uk)  # (B, 1, H, r)
        ckd = ck.to(dt)
        logits = (torch.einsum("bshr,btr->bhst", q_lat, ckd)
                  + torch.einsum("bshd,btd->bhst", qr, kk.to(dt))).to(torch.float32) * scale
        valid = torch.arange(T, device=dev) <= cache_pos
        logits = torch.where(valid[None, None, None], logits, _NEG_INF)
        w = torch.softmax(logits, dim=-1).to(dt)
        o_lat = torch.einsum("bhst,btr->bshr", w, ckd)  # (B, 1, H, r)
        w_uv = head_reshape(p["w_uv"].to(dt), (r, H, dv), H)
        out = head_reshape(torch.einsum("bshr,rhd->bshd", o_lat, w_uv), (B, S, H * dv), H, dim=2)

    return out @ p["wo"].to(dt), cache


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, dtype, device=None,
                   lead: tuple[int, ...] = ()) -> Params:
    a: MLAConfig = cfg.mla
    return {
        "c_kv": torch.zeros(lead + (batch, seq, a.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros(lead + (batch, seq, a.qk_rope_head_dim), dtype=dtype,
                              device=device),
    }
