"""Train / prefill / decode steps for the LM substrate (PyTorch).

Port of ``repro.runtime.steps``:
  train_step   — fwd + CE loss + clip + AdamW (gradient accumulation over
                 ``microbatches`` chunks, then averaged)
  prefill_step — fwd over the prompt, builds the cache
  decode_step  — ONE token against the cache (written in place)

The steps run eagerly on the tensors' device; nothing in them reads a
value back to the host. Both serving steps run with ``remat=False``, as
JAX's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import (
    AdamState,
    adam_init,
    adamw_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.sharding.dtensor import is_dtensor, sharded_cache, vocab_parallel_ce


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    step: int | torch.Tensor  # steps taken (an int32 () array in a checkpoint)


def init_train_state(gen: torch.Generator, cfg: ModelConfig) -> TrainState:
    """Random parameters on ``gen``'s device, zero moments, step 0."""
    params = transformer.init_model_params(gen, cfg)
    return TrainState(params=params, opt=adam_init(params), step=0)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token CE in fp32. logits (B, S, V), targets (B, S) integer;
    sharded logits go vocab-parallel (``sharding.dtensor.vocab_parallel_ce``)."""
    if is_dtensor(logits):
        return vocab_parallel_ce(logits, targets, cross_entropy)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].to(torch.long))[..., 0]
    return torch.mean(logz - gold)


def _loss_fn(params, cfg: ModelConfig, batch: dict[str, torch.Tensor]):
    logits, _, aux = transformer.forward(params, cfg, batch["tokens"],
                                         frames=batch.get("frames"),
                                         patches=batch.get("patches"))
    targets = batch["targets"]
    if logits.shape[1] != targets.shape[1]:
        # VLM: image positions prepended — loss on the text region only
        logits = logits[:, -targets.shape[1]:]
    ce = cross_entropy(logits, targets)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    return ce + aux_w * aux, ce, aux


def _value_and_grad(params, cfg: ModelConfig, batch):
    """(loss, ce, aux), grads — detached, the grads in ``params``' tree."""
    live = tree_map(lambda a: a.detach().requires_grad_(True), params)
    loss, ce, aux = _loss_fn(live, cfg, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return (loss.detach(), ce.detach(), aux.detach()), tree_map(lambda _: next(grads), live)


def make_train_step(
    cfg: ModelConfig,
    learning_rate: float = 3e-4,
    clip_norm: float = 1.0,
    microbatches: int = 1,
):
    """Build the train step: (state, batch) -> (new state, metrics).

    microbatches > 1 runs gradient accumulation: the batch is split into M
    chunks run in turn, activation memory scales ~1/M while the optimizer
    sees the same averaged gradient.
    """

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        if microbatches == 1:
            (loss, ce, aux), grads = _value_and_grad(state.params, cfg, batch)
        else:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            grads = tree_map(torch.zeros_like, state.params)
            loss = ce = aux = 0.0
            for i in range(microbatches):
                (l_i, ce_i, aux_i), g = _value_and_grad(
                    state.params, cfg, {k: v[i] for k, v in mb.items()})
                grads = tree_map(torch.add, grads, g)
                loss, ce, aux = loss + l_i, ce + ce_i, aux + aux_i
            inv = 1.0 / microbatches
            grads = tree_map(lambda g: g * inv, grads)
            loss, ce, aux = loss * inv, ce * inv, aux * inv
        grads = clip_by_global_norm(grads, clip_norm)
        params, opt = adamw_update(state.params, grads, state.opt, lr=learning_rate)
        metrics = {"loss": loss, "ce": ce, "aux": aux}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """Prompt (an encoder-decoder's frames through the encoder, a VLM's
    patches prepended) -> (last-token logits, filled cache); ``cache_len``
    counts the patches' positions too. The step's signature is JAX's,
    ``(params, tokens, frames=None, patches=None)``."""
    serve_cfg = dataclasses.replace(cfg, remat=False)

    @torch.no_grad()
    def prefill_step(params, tokens, frames=None, patches=None):
        dt = transformer.torch_dtype(serve_cfg.dtype)
        if is_dtensor(tokens):  # the dry-run's trace: the cache sharded as the tokens
            cache = sharded_cache(serve_cfg, tokens, tokens.shape[0], cache_len, dt)
        else:
            cache = transformer.init_cache(serve_cfg, tokens.shape[0], cache_len, dt,
                                           tokens.device)
        logits, cache, _ = transformer.forward(params, serve_cfg, tokens, frames=frames,
                                               patches=patches, cache=cache, cache_pos=0)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(cache, pos, token) -> (logits, cache). ONE new token; ``pos`` a host
    int or a () tensor on the device."""
    serve_cfg = dataclasses.replace(cfg, remat=False)

    @torch.no_grad()
    def decode_step(params, cache, cache_pos, tokens):
        logits, cache, _ = transformer.forward(params, serve_cfg, tokens, cache=cache,
                                               cache_pos=cache_pos)
        return logits[:, -1], cache

    return decode_step
