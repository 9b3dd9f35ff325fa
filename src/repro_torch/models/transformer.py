"""Model assembly for the dense blocks: pattern periods over GQA layers.

Port of the dense half of ``repro.models.transformer``. A LAYER is a
temporal-mixing block (``attn`` or ``local_attn``) plus — unless
``mlp_kind == "none"`` — a SwiGLU or GeLU feed-forward block, each
pre-normed with residuals.

The parameter and cache trees are JAX's, key path for key path: the
layers of all full PATTERN PERIODS (cfg.block_pattern) are stacked on a
leading period axis under ``"stack"`` (a cache leaf is (P, B, S, KV, hd)),
a partial trailing period is the list ``"remainder"``, then
``"final_norm"``, and ``"lm_head"`` only when embeddings are untied. So
:func:`params_from_numpy` carries JAX's parameters across leaf by leaf,
and LM train states checkpoint both ways (``repro_torch.checkpoint``).
Where JAX scans over the periods, the port loops over them in Python on
views of the stacked leaves; decode writes into the stacked cache in
place. ``cfg.remat`` becomes ``torch.utils.checkpoint`` per period, in
training only.

The other block kinds and sub-models (MoE, MLA, xLSTM, RG-LRU, the
encoder and the vision stub) raise ``NotImplementedError`` naming their
slice of ``ROADMAP.md`` queue 1, item 6.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    Params,
    apply_mlp,
    dense_init,
    embed_init,
    init_mlp,
    rms_norm,
)
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import tree_map

Cache = dict[str, Any]

# what the port does not have yet, and the slice of ROADMAP.md queue 1,
# item 6 that brings it
NOT_PORTED = {
    "moe": "MoE blocks: ROADMAP.md queue 1, item 6.2",
    "mlstm": "xLSTM blocks: ROADMAP.md queue 1, item 6.3",
    "slstm": "xLSTM blocks: ROADMAP.md queue 1, item 6.3",
    "rglru": "RG-LRU blocks: ROADMAP.md queue 1, item 6.4",
    "mla": "MLA blocks: ROADMAP.md queue 1, item 6.5",
    "encoder": "the encoder-decoder: ROADMAP.md queue 1, item 6.6",
    "vision": "the vision stub: ROADMAP.md queue 1, item 6.7",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the slice that brings what
    ``cfg`` needs and the port does not have yet."""
    parts = [b for b in cfg.block_pattern if b not in ("attn", "local_attn")]
    parts += [name for name in ("moe", "encoder", "vision") if getattr(cfg, name) is not None]
    if parts:
        raise NotImplementedError(
            f"{cfg.name}: the port has the dense attention blocks only; "
            f"{NOT_PORTED[parts[0]]}"
        )


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
                      lead: tuple[int, ...] = ()) -> Params:
    """One layer: mixing + optional FFN; ``lead`` stacks periods."""
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(NOT_PORTED.get(kind, kind))
    ones = {"dtype": torch.float32, "device": gen.device}
    p: Params = {"ln1": torch.ones(lead + (cfg.d_model,), **ones),
                 "mix": attn.init_gqa_params(gen, cfg, lead)}
    if cfg.mlp_kind != "none":
        p["ln2"] = torch.ones(lead + (cfg.d_model,), **ones)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, _mlp_kind(cfg), lead)
    return p


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq: int, dtype,
                     device=None, lead: tuple[int, ...] = ()) -> Cache:
    if kind == "attn":
        return attn.init_gqa_cache(cfg, batch, seq, 0, dtype, device, lead)
    if kind == "local_attn":
        return attn.init_gqa_cache(cfg, batch, seq, cfg.sliding_window, dtype, device, lead)
    raise NotImplementedError(NOT_PORTED.get(kind, kind))


def layer_forward(
    p: Params,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Cache | None = None,
    cache_pos: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, Cache | None]:
    """Returns (x, cache); a given cache is written in place."""
    if kind not in ("attn", "local_attn"):
        raise NotImplementedError(NOT_PORTED.get(kind, kind))
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == "local_attn" else 0
    out, cache = attn.gqa_forward(p["mix"], cfg, h, positions, window=window, cache=cache,
                                  cache_pos=cache_pos)
    x = x + out
    if "mlp" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + apply_mlp(p["mlp"], h, _mlp_kind(cfg))
    return x, cache


# --------------------------------------------------------------------------
# whole-model parameters and caches
# --------------------------------------------------------------------------


def init_model_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, in JAX's tree."""
    cfg.validate()
    check_ported(cfg)
    D, V = cfg.d_model, cfg.padded_vocab_size
    p: Params = {"embed": embed_init(gen, (V, D))}
    if cfg.pos_kind == "learned":
        p["pos_embed"] = embed_init(gen, (cfg.max_position, D))
    p["stack"] = {
        f"b{i}": init_layer_params(gen, cfg, kind, lead=(cfg.num_periods,))
        for i, kind in enumerate(cfg.block_pattern)
    }
    p["remainder"] = [init_layer_params(gen, cfg, kind) for kind in cfg.remainder_pattern]
    p["final_norm"] = torch.ones((D,), dtype=torch.float32, device=gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (D, V))
    return p


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    """Decode cache sized for ``seq`` total positions."""
    check_ported(cfg)
    return {
        "stack": {
            f"b{i}": init_layer_cache(cfg, kind, batch, seq, dtype, device,
                                      lead=(cfg.num_periods,))
            for i, kind in enumerate(cfg.block_pattern)
        },
        "remainder": [init_layer_cache(cfg, kind, batch, seq, dtype, device)
                      for kind in cfg.remainder_pattern],
    }


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


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    cache: Cache | None = None,
    cache_pos: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, Cache | None, torch.Tensor]:
    """Full model forward.

    tokens (B, S) integer. cache/cache_pos: decode state (cache_pos =
    #tokens already consumed; a host int or a () tensor); the cache is
    written in place and returned. Returns (logits fp32 (B, S, V), cache,
    aux_loss), aux_loss 0 for the dense blocks.
    """
    check_ported(cfg)
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
    x = params["embed"].to(dt)[tokens]

    pos0 = cache_pos if cache_pos is not None else 0
    positions = pos0 + torch.arange(S, device=dev)
    if cfg.pos_kind == "learned":
        pe = params["pos_embed"][torch.clamp(positions, max=cfg.max_position - 1)]
        x = x + pe.to(dt)[None]

    def period_body(h, p_per, c_per):
        for i, kind in enumerate(cfg.block_pattern):
            ci = c_per[f"b{i}"] if c_per is not None else None
            h, _ = layer_forward(p_per[f"b{i}"], cfg, kind, h, positions, cache=ci,
                                 cache_pos=cache_pos)
        return h

    n_per = cfg.num_periods
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    per_params = _unstack(params["stack"], n_per)
    for pi in range(n_per):
        c_per = tree_map(lambda a, pi=pi: a[pi], cache["stack"]) if cache is not None else None
        if remat:
            x = checkpoint(period_body, x, per_params[pi], None, use_reentrant=False)
        else:
            x = period_body(x, per_params[pi], c_per)

    for i, lp in enumerate(params["remainder"]):
        ci = cache["remainder"][i] if cache is not None else None
        x, _ = layer_forward(lp, cfg, cfg.block_pattern[i], x, positions, cache=ci,
                             cache_pos=cache_pos)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(dt)).to(torch.float32)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask the pad slots (targets never reference them)
        pad_mask = torch.arange(cfg.padded_vocab_size, device=dev) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits, cache, torch.zeros((), dtype=torch.float32, device=dev)
