"""Model assembly: pattern periods over composable blocks (PyTorch).

Port of ``repro.models.transformer``: a LAYER is a temporal-mixing block
(``attn``, ``local_attn``, ``mla``, the xLSTM blocks ``mlstm`` and
``slstm``, or the RG-LRU block ``rglru``) plus — unless ``mlp_kind ==
"none"`` — a feed-forward block (SwiGLU/GeLU, or MoE for MoE archs), each
pre-normed with residuals. A VLM's stubbed patch embeddings go through
the ``projector`` (gelu(patches @ w1) @ w2) and are prepended to the
token embeddings. An encoder-decoder (whisper) runs a bidirectional
encoder over stubbed frame embeddings, and every decoder layer adds
cross-attention to its output (``ln_x``, ``cross``) after the mixing
block; the prefill writes the projected cross keys and values into the
cache (``cross_k``, ``cross_v``), and decode reads them there.

The parameter and cache trees are JAX's, key path for key path: the
layers of all full PATTERN PERIODS (cfg.block_pattern) are stacked on a
leading period axis under ``"stack"`` (a cache leaf is (P, B, S, KV, hd)),
a partial trailing period is the list ``"remainder"``, DeepSeekMoE's dense
layer 0 (``moe.first_layer_dense``) is ``"prelude"``, then
``"final_norm"``, and ``"lm_head"`` only when embeddings are untied; the
encoder's layers are stacked under ``"encoder"``/``"b0"``. So
:func:`params_from_numpy` carries JAX's parameters across leaf by leaf,
and LM train states checkpoint both ways (``repro_torch.checkpoint``).
Where JAX scans over the periods, the port loops over them in Python on
views of the stacked leaves; decode writes into the stacked cache in
place (the recurrent blocks ``copy_`` their new states into it).
``cfg.remat`` becomes ``torch.utils.checkpoint`` per period (and per
encoder layer), in training only. The MoE layers' load-balance losses
are summed over the layers in JAX's order (prelude, periods, remainder).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (
    Params,
    apply_mlp,
    gelu,
    dense_init,
    embed_init,
    init_mlp,
    rms_norm,
)
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import tree_map
from repro_torch.sharding.dtensor import embed_lookup, head_reshape

Cache = dict[str, Any]

def layout(cfg: ModelConfig) -> tuple[bool, int, tuple[str, ...]]:
    """(dense prelude layer?, full periods, remainder kinds), as JAX's
    ``init_model_params`` splits the layers: DeepSeekMoE's dense layer 0
    stands before the periods."""
    prelude = cfg.moe is not None and cfg.moe.first_layer_dense
    n_scan = cfg.num_layers - (1 if prelude else 0)
    return prelude, n_scan // cfg.period, cfg.block_pattern[: n_scan % cfg.period]


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# --------------------------------------------------------------------------
# single layer
# --------------------------------------------------------------------------


def _mlp_kind(cfg: ModelConfig) -> str:
    return "gelu" if cfg.mlp_kind == "gelu" else "swiglu"


def init_layer_params(gen: torch.Generator, cfg: ModelConfig, kind: str,
                      lead: tuple[int, ...] = (), *, dense_ffn: bool = False,
                      cross: bool = False) -> Params:
    """One layer: mixing + optional FFN (+ optional cross-attention);
    ``lead`` stacks periods; ``dense_ffn`` gives an MoE config's prelude
    its dense FFN."""
    ones = {"dtype": torch.float32, "device": gen.device}
    if kind == "mla":
        mix = attn.init_mla_params(gen, cfg, lead)
    elif kind == "mlstm":
        mix = ssm_lib.init_mlstm_params(gen, cfg, lead)
    elif kind == "slstm":
        mix = ssm_lib.init_slstm_params(gen, cfg, lead)
    elif kind == "rglru":
        mix = rglru_lib.init_rglru_params(gen, cfg, lead)
    elif kind in ("attn", "local_attn"):
        mix = attn.init_gqa_params(gen, cfg, lead)
    else:
        raise ValueError(kind)
    p: Params = {"ln1": torch.ones(lead + (cfg.d_model,), **ones), "mix": mix}
    if cross:
        p["ln_x"] = torch.ones(lead + (cfg.d_model,), **ones)
        p["cross"] = attn.init_gqa_params(gen, cfg, lead)
    if cfg.mlp_kind != "none":
        p["ln2"] = torch.ones(lead + (cfg.d_model,), **ones)
        if cfg.moe is not None and not dense_ffn:
            p["moe"] = moe_lib.init_moe_params(gen, cfg, lead)
        else:
            d_ff = cfg.moe.dense_d_ff if (cfg.moe is not None and dense_ffn) else cfg.d_ff
            p["mlp"] = init_mlp(gen, cfg.d_model, d_ff, _mlp_kind(cfg), lead)
    return p


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq: int, dtype,
                     device=None, lead: tuple[int, ...] = (), cross_len: int = 0) -> Cache:
    """One layer's cache; ``cross_len`` > 0 adds the cross-attention keys
    and values ``cross_k``/``cross_v``, each (B, cross_len, KV, hd)."""
    if kind == "attn":
        c = attn.init_gqa_cache(cfg, batch, seq, 0, dtype, device, lead)
    elif kind == "local_attn":
        c = attn.init_gqa_cache(cfg, batch, seq, cfg.sliding_window, dtype, device, lead)
    elif kind == "mla":
        c = attn.init_mla_cache(cfg, batch, seq, dtype, device, lead)
    elif kind == "mlstm":
        c = ssm_lib.init_mlstm_cache(cfg, batch, dtype, device, lead)
    elif kind == "slstm":
        c = ssm_lib.init_slstm_cache(cfg, batch, dtype, device, lead)
    elif kind == "rglru":
        c = rglru_lib.init_rglru_cache(cfg, batch, dtype, device, lead)
    else:
        raise ValueError(kind)
    if cross_len:
        shape = lead + (batch, cross_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def layer_forward(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Cache | None = None,
    cache_pos: torch.Tensor | int | None = None,
    encoder_out: torch.Tensor | None = None,
    moe_group=None,
) -> tuple[torch.Tensor, Cache | None, torch.Tensor]:
    """Returns (x, cache, aux_loss); a given cache is written in place.
    With cross-attention, ``encoder_out`` (B, T, D) is projected to the
    cross keys and values (and written into the cache at a prefill);
    without it, decode reads them from the cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mix_cache = None
    if cache is not None:
        mix_cache = {k: v for k, v in cache.items() if not k.startswith("cross_")}
    if kind == "mla":
        out, _ = attn.mla_forward(p["mix"], cfg, h, positions, cache=mix_cache,
                                  cache_pos=cache_pos)
    elif kind == "mlstm":
        out, _ = ssm_lib.mlstm_forward(p["mix"], cfg, h, cache=mix_cache)
    elif kind == "slstm":
        out, _ = ssm_lib.slstm_forward(p["mix"], cfg, h, cache=mix_cache)
    elif kind == "rglru":
        out, _ = rglru_lib.rglru_forward(p["mix"], cfg, h, cache=mix_cache)
    elif kind in ("attn", "local_attn"):
        window = cfg.sliding_window if kind == "local_attn" else 0
        out, _ = attn.gqa_forward(p["mix"], cfg, h, positions, window=window, cache=mix_cache,
                                  cache_pos=cache_pos)
    else:
        raise ValueError(kind)
    x = x + out

    if "cross" in p:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        dt = x.dtype
        if encoder_out is not None:
            # prefill / training: project the encoder's output to cross K/V
            B, T, _ = encoder_out.shape
            shape = (B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
            kv = tuple(head_reshape(encoder_out @ p["cross"][w].to(dt), shape, cfg.num_kv_heads)
                       for w in ("wk", "wv"))
            if cache is not None:
                cache["cross_k"].copy_(kv[0])
                cache["cross_v"].copy_(kv[1])
        elif cache is not None:  # decode: the prefill's cross K/V
            kv = (cache["cross_k"].to(dt), cache["cross_v"].to(dt))
        else:
            raise ValueError(f"{cfg.name}: cross-attention needs the encoder's output "
                             "(frames) or a prefilled cache")
        out, _ = attn.gqa_forward(p["cross"], cfg, hx, positions, encoder_kv=kv)
        x = x + out

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        out, aux = moe_lib.moe_forward(p["moe"], cfg, h, group=moe_group)
        x = x + out
    elif "mlp" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + apply_mlp(p["mlp"], h, _mlp_kind(cfg))
    return x, cache, aux


# --------------------------------------------------------------------------
# whole-model parameters and caches
# --------------------------------------------------------------------------


def init_model_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, in JAX's tree."""
    cfg.validate()
    D, V = cfg.d_model, cfg.padded_vocab_size
    prelude, n_periods, rem = layout(cfg)
    cross = cfg.encoder is not None
    p: Params = {"embed": embed_init(gen, (V, D))}
    if cfg.pos_kind == "learned":
        p["pos_embed"] = embed_init(gen, (cfg.max_position, D))
    if prelude:
        p["prelude"] = init_layer_params(gen, cfg, cfg.block_pattern[0], dense_ffn=True)
    p["stack"] = {
        f"b{i}": init_layer_params(gen, cfg, kind, lead=(n_periods,), cross=cross)
        for i, kind in enumerate(cfg.block_pattern)
    }
    p["remainder"] = [init_layer_params(gen, cfg, kind, cross=cross) for kind in rem]
    p["final_norm"] = torch.ones((D,), dtype=torch.float32, device=gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (D, V))
    if cross:
        e = cfg.encoder
        if e.frontend_dim != D:
            p["enc_proj"] = dense_init(gen, (e.frontend_dim, D))
        p["enc_pos"] = embed_init(gen, (e.num_frames, D))
        p["encoder"] = {"b0": init_layer_params(gen, cfg, "attn", lead=(e.num_layers,))}
        p["enc_norm"] = torch.ones((D,), dtype=torch.float32, device=gen.device)
    if cfg.vision is not None:
        p["projector"] = {"w1": dense_init(gen, (cfg.vision.vit_dim, D)),
                          "w2": dense_init(gen, (D, D))}
    return p


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    """Decode cache sized for ``seq`` total positions (and, with an
    encoder, its ``num_frames`` cross positions)."""
    cross_len = cfg.encoder.num_frames if cfg.encoder is not None else 0
    prelude, n_periods, rem = layout(cfg)
    c: Cache = {
        "stack": {
            f"b{i}": init_layer_cache(cfg, kind, batch, seq, dtype, device, lead=(n_periods,),
                                      cross_len=cross_len)
            for i, kind in enumerate(cfg.block_pattern)
        },
        "remainder": [init_layer_cache(cfg, kind, batch, seq, dtype, device,
                                       cross_len=cross_len) for kind in rem],
    }
    if prelude:
        c["prelude"] = init_layer_cache(cfg, cfg.block_pattern[0], batch, seq, dtype, device,
                                        cross_len=cross_len)
    return c


def params_from_numpy(tree: Any, device=None) -> Any:
    """A JAX parameter (or cache) tree, its leaves as numpy arrays, as
    tensors on ``device``: one ``torch.from_numpy`` a leaf, the nesting
    kept (dicts, lists)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list | tuple):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` period trees of a stacked tree, as views. ``unbind``, whose
    backward is one stack, so a gradient is not scattered n times."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in tree} for i in range(n)]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _encoder_forward(p: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B, T, F):
    bidirectional self-attention (no positions in the attention, no mask),
    learned frame positions, the GeLU/SwiGLU MLP; ``p`` already cast."""
    dt = torch_dtype(cfg.dtype)
    x = frames.to(dt)
    if "enc_proj" in p:
        x = x @ p["enc_proj"].to(dt)
    x = x + p["enc_pos"].to(dt)[None, :x.shape[1]]

    def body(h, lp):
        h2 = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(lp["mix"], cfg, h2)
        mask = torch.ones((h.shape[1], h.shape[1]), dtype=torch.bool, device=h.device)
        o = attn._sdpa(q, k, v, mask, cfg.num_kv_heads)
        o = head_reshape(o, (h.shape[0], h.shape[1], -1), cfg.num_heads, dim=2)
        h = h + o @ lp["mix"]["wo"].to(h.dtype)
        h2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
        return h + apply_mlp(lp["mlp"], h2, _mlp_kind(cfg))

    remat = cfg.remat and torch.is_grad_enabled()
    layers = _unstack(p["encoder"]["b0"], cfg.encoder.num_layers)
    for lp in layers:
        x = checkpoint(body, x, lp, use_reentrant=False) if remat else body(x, lp)
    return rms_norm(x, p["enc_norm"], cfg.norm_eps)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    frames: torch.Tensor | None = None,
    patches: torch.Tensor | None = None,
    cache: Cache | None = None,
    cache_pos: torch.Tensor | int | None = None,
    moe_group=None,
) -> tuple[torch.Tensor, Cache | None, torch.Tensor]:
    """Full model forward.

    tokens (B, S) integer. frames: (B, T, frontend_dim) stub audio
    embeddings of an encoder-decoder, run through the encoder (a prefill
    writes the cross keys and values into the cache; decode goes without
    frames). patches: (B, P, vit_dim) stub ViT embeddings of a VLM,
    projected and prepended (the logits are then (B, P + S, V)).
    cache/cache_pos: decode state (cache_pos =
    #tokens already consumed; a host int or a () tensor); the cache is
    written in place and returned. moe_group: a ``torch.distributed``
    group every MoE layer splits its experts over (``moe.moe_forward``).
    Returns (logits fp32 (B, S, V), cache, aux_loss), aux_loss the MoE
    layers' load-balance losses summed (0 without MoE).
    """
    dt = torch_dtype(cfg.dtype)
    if dt != torch.float32:
        # one-shot mixed-precision cast of all >=2-D weights, as JAX's
        # (stacked norm scales are 2-D and cast too; 1-D ones stay fp32);
        # autograd carries the gradient back to the fp32 masters
        params = tree_map(
            lambda a: a.to(dt) if (a.dtype == torch.float32 and a.ndim >= 2) else a, params
        )
    B, S = tokens.shape
    dev = tokens.device
    x = embed_lookup(params["embed"].to(dt), tokens)

    if cfg.vision is not None and patches is not None:
        pr = params["projector"]
        pe = gelu(patches.to(dt) @ pr["w1"].to(dt)) @ pr["w2"].to(dt)
        x = torch.cat([pe, x], dim=1)  # image tokens first
        S = x.shape[1]

    pos0 = cache_pos if cache_pos is not None else 0
    positions = pos0 + torch.arange(S, device=dev)
    if cfg.pos_kind == "learned":
        pe = params["pos_embed"][torch.clamp(positions, max=cfg.max_position - 1)]
        x = x + pe.to(dt)[None]

    encoder_out = None
    if cfg.encoder is not None and frames is not None:
        encoder_out = _encoder_forward(params, cfg, frames)
    layer_kw = {"cache_pos": cache_pos, "encoder_out": encoder_out, "moe_group": moe_group}

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    if "prelude" in params:
        pc = cache["prelude"] if cache is not None else None
        x, _, aux = layer_forward(params["prelude"], cfg, cfg.block_pattern[0], x, positions,
                                  cache=pc, **layer_kw)
        aux_total = aux_total + aux

    def period_body(h, aux_acc, p_per, c_per):
        for i, kind in enumerate(cfg.block_pattern):
            ci = c_per[f"b{i}"] if c_per is not None else None
            h, _, aux = layer_forward(p_per[f"b{i}"], cfg, kind, h, positions, cache=ci,
                                      **layer_kw)
            aux_acc = aux_acc + aux
        return h, aux_acc

    _, n_per, _ = layout(cfg)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    per_params = _unstack(params["stack"], n_per)
    for pi in range(n_per):
        c_per = tree_map(lambda a, pi=pi: a[pi], cache["stack"]) if cache is not None else None
        if remat:
            x, aux_total = checkpoint(period_body, x, aux_total, per_params[pi], None,
                                      use_reentrant=False)
        else:
            x, aux_total = period_body(x, aux_total, per_params[pi], c_per)

    for i, lp in enumerate(params["remainder"]):
        ci = cache["remainder"][i] if cache is not None else None
        x, _, aux = layer_forward(lp, cfg, cfg.block_pattern[i], x, positions, cache=ci,
                                  **layer_kw)
        aux_total = aux_total + aux

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(dt)).to(torch.float32)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask the pad slots (targets never reference them)
        pad_mask = torch.arange(cfg.padded_vocab_size, device=dev) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits, cache, aux_total
