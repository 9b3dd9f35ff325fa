"""Mixture-of-Experts FFN: shared + routed top-k experts (DeepSeekMoE /
Qwen3-MoE style) with capacity-based scatter dispatch (PyTorch).

Port of ``repro.models.moe``, with JAX's parameter tree: ``router`` (D, E),
``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D) and, with shared
experts, ``shared`` {w_gate, w_up (D, S*F), w_down (S*F, D)}.

Routing runs in float32: softmax over the router logits, top-k, the gates
renormalized with a floor of 1e-9. ``jax.lax.top_k`` breaks ties toward
the lower expert index and ``torch.topk`` promises no order, so the top-k
is a STABLE descending sort's first K columns (equal probabilities keep
index order). The Switch load-balance loss is E * sum(dispatch fraction *
mean probability), the counts a ``bincount``.

Dispatch is JAX's GShard discipline: the T tokens split into G groups
(``dispatch_groups``, halved until it divides T), each ranking its (token,
k) assignments per expert by a stable sort and keeping the first
Cg = max(int(capacity_factor * Tg * K / E), 1) of each expert. Kept
assignments own distinct slots of a (G, E*Cg, D) buffer; a dropped one
adds 0 * x to a clipped slot, so the scatter sums at most one nonzero row
a slot and is exact in any order (on the card too, where ``scatter_add_``
uses atomics). The combine gathers each assignment's expert row and sums
a token's K rows in index order, one add at a time in the activation
dtype, as JAX's scatter-add does; no atomics.

``moe_forward(..., group=g)`` takes the expert-parallel path when the
group's size n divides E (JAX takes it under a mesh with a ``model``
axis): rank r keeps experts [r*E/n, (r+1)*E/n), routes and ranks the
whole token set (the same on every rank), dispatches only to its own
experts, and ONE all-reduce (sum) adds the ranks' partial outputs; the
shared experts follow it. In the backward the all-reduce passes the
gradient through, and the gradients of the dispatched tokens and of the
gates are summed over the group, so every rank gets the whole gradient of
x and the router, and its own experts' gradients.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.sharding.dtensor import is_dtensor, moe_forward_sharded

# the expert-parallel path's collectives (forward all-reduces of the
# partial outputs; backward all-reduces of the token and gate gradients)
COLLECTIVES = {"forward_all_reduce": 0, "backward_all_reduce": 0}

_ROUTING_LOG: list | None = None


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@contextlib.contextmanager
def routing_log():
    """Collect, per MoE call in the block, the device tensors (kept
    assignments, all assignments) of the capacity discipline; nothing is
    read back to the host until the caller reads them."""
    global _ROUTING_LOG
    prev, _ROUTING_LOG = _ROUTING_LOG, []
    try:
        yield _ROUTING_LOG
    finally:
        _ROUTING_LOG = prev


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> Params:
    m: MoEConfig = cfg.moe
    D, E, Fx = cfg.d_model, m.num_experts, m.d_expert
    p = {
        "router": dense_init(gen, (D, E), lead=lead),
        "w_gate": dense_init(gen, (E, D, Fx), in_axis=1, lead=lead),
        "w_up": dense_init(gen, (E, D, Fx), in_axis=1, lead=lead),
        "w_down": dense_init(gen, (E, Fx, D), in_axis=1, lead=lead),
    }
    if m.num_shared > 0:
        sf = m.num_shared * Fx
        p["shared"] = {
            "w_gate": dense_init(gen, (D, sf), lead=lead),
            "w_up": dense_init(gen, (D, sf), lead=lead),
            "w_down": dense_init(gen, (sf, D), lead=lead),
        }
    return p


def route(p: Params, cfg: ModelConfig, xt: torch.Tensor):
    """xt (T, D) -> (probs fp32 (T, E), gates fp32 (T, K), expert ids (T, K)
    int64, aux fp32 ())."""
    m: MoEConfig = cfg.moe
    E, K = m.num_experts, m.top_k
    T = xt.shape[0]
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = srt.values[:, :K], srt.indices[:, :K]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    counts = torch.bincount(expert_ids.reshape(-1), minlength=E).to(torch.float32)
    dispatch_frac = counts / (T * K)
    aux = E * torch.sum(dispatch_frac * probs.mean(0))
    return probs, gate_vals, expert_ids, aux


def group_ranks(eid_g: torch.Tensor, E: int) -> torch.Tensor:
    """(G, N) expert ids -> (G, N) rank of each assignment within its
    expert, in assignment order (a stable sort per group)."""
    G, N = eid_g.shape
    srt = torch.sort(eid_g, dim=-1, stable=True)
    counts = torch.zeros((G, E), dtype=torch.long, device=eid_g.device)
    counts.scatter_add_(1, eid_g, torch.ones_like(eid_g))
    seg_start = torch.cumsum(counts, dim=-1) - counts
    rank_sorted = torch.arange(N, device=eid_g.device) - torch.gather(seg_start, 1, srt.values)
    return torch.empty_like(eid_g).scatter_(1, srt.indices, rank_sorted)


def dispatch_layout(cfg: ModelConfig, T: int) -> tuple[int, int, int]:
    """(G, Tg, Cg) of the local path for T tokens."""
    m: MoEConfig = cfg.moe
    G = m.dispatch_groups
    while T % G:
        G //= 2
    Tg = T // G
    return G, Tg, max(int(m.capacity_factor * Tg * m.top_k / m.num_experts), 1)


def _experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """(E, C, D) -> (E, C, D): the grouped SwiGLU experts."""
    dt = buf.dtype
    h = F.silu(torch.bmm(buf, w_gate.to(dt)))
    h = h * torch.bmm(buf, w_up.to(dt))
    return torch.bmm(h, w_down.to(dt))


def _shared(p: Params, xt: torch.Tensor) -> torch.Tensor:
    sp, dt = p["shared"], xt.dtype
    g = F.silu(xt @ sp["w_gate"].to(dt))
    return (g * (xt @ sp["w_up"].to(dt))) @ sp["w_down"].to(dt)


def _combine_k(per_assign: torch.Tensor, K: int) -> torch.Tensor:
    """(..., N*K, D) -> (..., N, D): each token's K rows added in index
    order, one rounding an add, as JAX's scatter-add into zeros."""
    per = per_assign.reshape(per_assign.shape[:-2] + (-1, K, per_assign.shape[-1]))
    out = per[..., 0, :]
    for k in range(1, K):
        out = out + per[..., k, :]
    return out


def _log(keep: torch.Tensor) -> None:
    if _ROUTING_LOG is not None:
        _ROUTING_LOG.append((keep.detach().sum(), keep.numel()))


def moe_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *, group=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux load-balance loss scalar fp32).

    ``group``: a ``torch.distributed`` process group; when its size n > 1
    divides the expert count, every rank of it calls this with the same x
    and the experts are split over the ranks (the module docstring). A
    DTensor ``x`` (the dry-run's trace) takes the mesh's model axis as the
    group, as JAX's takes the ambient mesh's
    (``sharding.dtensor.moe_forward_sharded``)."""
    if is_dtensor(x):
        sharded = moe_forward_sharded(p, cfg, x)
        if sharded is not None:
            return sharded
    if group is not None:
        import torch.distributed as dist

        n = dist.get_world_size(group)
        if n > 1 and cfg.moe.num_experts % n == 0:
            return _moe_forward_spmd(p, cfg, x, group)
    return _moe_forward_local(p, cfg, x)


def _moe_forward_local(p: Params, cfg: ModelConfig, x: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)
    _, gate_vals, expert_ids, aux = route(p, cfg, xt)

    # GShard group-local capacity ranks
    G, Tg, Cg = dispatch_layout(cfg, T)
    tok_l = torch.arange(Tg, device=x.device).repeat_interleave(K)
    eid_g = expert_ids.reshape(G, Tg * K)
    rank_g = group_ranks(eid_g, E)
    keep_g = (rank_g < Cg).to(dt)
    slot_g = eid_g * Cg + torch.clamp_max(rank_g, Cg - 1)
    _log(keep_g)

    # dispatch: per-group scatter into (G, E*Cg, D), then expert-major
    rows = x.reshape(G, Tg, D)[:, tok_l] * keep_g[..., None]
    buf = torch.zeros((G, E * Cg, D), dtype=dt, device=x.device)
    buf = buf.scatter_add(1, slot_g[..., None].expand(G, Tg * K, D), rows)
    buf = buf.reshape(G, E, Cg, D).transpose(0, 1).reshape(E, G * Cg, D)

    eout = _experts(buf, p["w_gate"], p["w_up"], p["w_down"])

    # combine: back to group-major, gather each assignment's row, weight
    eout = eout.reshape(E, G, Cg, D).transpose(0, 1).reshape(G, E * Cg, D)
    gate_g = gate_vals.reshape(G, Tg * K).to(dt)
    per_assign = torch.gather(eout, 1, slot_g[..., None].expand(G, Tg * K, D))
    per_assign = per_assign * (keep_g * gate_g)[..., None]
    out = _combine_k(per_assign, K).reshape(T, D)

    if m.num_shared > 0:
        out = out + _shared(p, xt)
    return out.reshape(B, S, D), aux


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``. gloo moves CPU tensors,
    so over gloo a card's tensor travels through host memory."""
    import torch.distributed as dist

    host = dist.get_backend(group) == "gloo" and t.device.type != "cpu"
    out = t.detach().to("cpu", copy=True) if host else t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device) if host else out


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the gradient as it is
    (the loss downstream is the same on every rank)."""

    @staticmethod
    def forward(ctx, t, group):
        COLLECTIVES["forward_all_reduce"] += 1
        return _all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumGradients(torch.autograd.Function):
    """Forward: the tensor as it is. Backward: its gradient summed over the
    group (each rank saw the tensor through its own experts only)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        COLLECTIVES["backward_all_reduce"] += 1
        return _all_reduce_sum(grad.contiguous(), ctx.group), None


def _moe_forward_spmd(p: Params, cfg: ModelConfig, x: torch.Tensor, group
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel path (JAX's ``_moe_forward_spmd``): this rank's
    E/n experts, the whole token set, one all-reduce of the partial
    outputs. The expert leaves are the whole (E, ...) tensors, sliced here,
    or this rank's (E/n, ...) shard."""
    import torch.distributed as dist

    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    dt = x.dtype
    n, r = dist.get_world_size(group), dist.get_rank(group)
    e_local = E // n
    e_lo = r * e_local
    xt = x.reshape(T, D)
    _, gate_vals, expert_ids, aux = route(p, cfg, xt)

    # ranks over the whole token set (one group)
    C = max(int(m.capacity_factor * T * K / E), 1)
    eid = expert_ids.reshape(-1)
    rank = group_ranks(eid[None], E)[0]
    keep = (rank < C).to(dt)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    mine = ((eid >= e_lo) & (eid < e_lo + e_local)).to(dt)
    keep = keep * mine
    slot = torch.clamp(eid - e_lo, 0, e_local - 1) * C + torch.clamp_max(rank, C - 1)
    _log(keep)

    xs = _SumGradients.apply(xt, group)
    gates = _SumGradients.apply(gate_vals, group)
    rows = xs[tok] * keep[:, None]
    buf = torch.zeros((e_local * C, D), dtype=dt, device=x.device)
    buf = buf.scatter_add(0, slot[:, None].expand(T * K, D), rows)

    def mine_of(w):
        return w if w.shape[0] == e_local else w[e_lo:e_lo + e_local]

    eout = _experts(buf.reshape(e_local, C, D), mine_of(p["w_gate"]), mine_of(p["w_up"]),
                    mine_of(p["w_down"])).reshape(e_local * C, D)
    per_assign = eout[slot] * (keep * gates.reshape(-1).to(dt))[:, None]
    out = _AllReduceSum.apply(_combine_k(per_assign, K), group)

    if m.num_shared > 0:
        out = out + _shared(p, xt)
    return out.reshape(B, S, D), aux
