"""Faults planted in the LM program, for the check's own tests and for the
readings that set the LM cells' limits (``calibrate_lm.py``): each must
make a run's ``correct`` come out false.

* ``renormalised_gates``: the top-k gates renormalised to sum to 1, as
  ``norm_topk_prob`` would, where the configuration states raw
  probabilities;
* ``no_mscale``: YaRN's mscale^2 left out of MLA's softmax scale;
* ``capacity``: GShard's capacity discipline (factor 1.25) in place of
  dropless dispatch: each held expert computes at most int(1.25 T K / E)
  of its assignments, the first in token order, and drops the rest;
* ``no_shared``: the shared experts left out.

And the control, a precision below the configuration's bf16:
``fp8_experts`` rounds the held experts' inputs and weights through
``float8_e4m3fn`` (each tensor scaled so its largest magnitude lands on
the format's largest, as fp8 training scales them).

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def renormalised_gates():
    from repro_torch.models import moe

    def make(original):
        def route(p, cfg, xt, batch=1):
            probs, gates, ids, aux = original(p, cfg, xt, batch)
            return probs, gates / gates.sum(-1, keepdim=True), ids, aux
        return route

    return _patched(moe, "route", make)


def no_mscale():
    from repro_torch.models import attention

    def make(original):
        def mla_softmax_scale(cfg):
            a = cfg.mla
            return (a.qk_nope_head_dim + a.qk_rope_head_dim) ** -0.5
        return mla_softmax_scale

    return _patched(attention, "mla_softmax_scale", make)


def capacity(factor: float = 1.25):
    from repro_torch.models import moe

    def make(original):
        def held_plan(local, routed, cfg):
            order, counts = original(local, routed, cfg)
            m = cfg.moe
            cap = max(int(factor * local.numel() / m.num_experts), 1)  # T K / E a expert
            starts = [sum(counts[:e]) for e in range(len(counts))]
            keep = torch.cat([torch.arange(s, s + min(c, cap), device=order.device)
                              for s, c in zip(starts, counts, strict=True)])
            return order[keep], [min(c, cap) for c in counts]
        return held_plan

    return _patched(moe, "held_plan", make)


def no_shared():
    from repro_torch.models import moe

    def make(original):
        def _shared(p, xt):  # nought, its weights still in the graph (their gradient 0)
            return original(p, xt) * 0
        return _shared

    return _patched(moe, "_shared", make)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8_e4m3fn, scaled per tensor; its gradient
    passes as it is."""
    fmax = torch.finfo(torch.float8_e4m3fn).max
    scale = fmax / torch.clamp_min(t.detach().abs().amax().to(torch.float32), 1e-30)
    q = ((t.detach().to(torch.float32) * scale).to(torch.float8_e4m3fn).to(torch.float32)
         / scale).to(t.dtype)
    return t + (q - t.detach())


def fp8_experts():
    from repro_torch.models import moe

    def make(original):
        def held_experts(rows, counts, p, dt):
            p = dict(p, **{k: fp8_round(p[k]) for k in ("w_gate", "w_up", "w_down")})
            return original(fp8_round(rows), counts, p, dt)
        return held_experts

    return _patched(moe, "held_experts", make)


FAULTS = {"renormalised_gates": renormalised_gates, "no_mscale": no_mscale,
          "capacity": capacity, "no_shared": no_shared}
CONTROL = {"fp8_experts": fp8_experts}
