"""Roofline terms from a traced program (port of ``repro.launch.hlo_analysis``).

The JAX package reads its terms from the compiled XLA module: the cost
analysis and the optimized HLO text. The port has no HLO. What it reads
instead is a :class:`Trace`: one device's record of a program run eagerly
on fake tensors (no allocation) under a fake process group, with every
tensor a DTensor shard. The trace's dispatch mode sits beneath DTensor's
dispatch, so it sees the ops each rank runs on its LOCAL shards and the
collectives that DTensor and the models issue:

  flops            the product ops' FLOPs on the local shards, by the
                   formulas of ``torch.utils.flop_counter`` (what
                   ``FlopCounterMode`` counts on a real run of the step)
  bytes            each local op's input and output bytes (views and
                   allocations excluded)
  collectives      each collective's result bytes, by XLA's mnemonic
  arguments        the bytes of the step's inputs on one device
  outputs          the bytes of its outputs
  peak             the most bytes of live storage at once: the arguments
                   plus every op output until Python frees it

  compute term    = per-device FLOPs / peak FLOP/s      [s]
  memory term     = per-device bytes / HBM rate         [s]
  collective term = per-device collective bytes / link  [s]

The constants are the H100's (below), never a TPU's.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import sys
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.hlo import _C10D_KINDS

# NVIDIA H100 SXM 80GB, per device, from NVIDIA's data sheet: dense bf16
# tensor-core rate, HBM3 rate, and NVLink 4 (900 GB/s both directions
# together over 18 links, so 450 GB/s each way) for the collective term.
PEAK_FLOPS = 989e12  # bf16 FLOP/s, dense
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s one way

# functional collectives (what DTensor issues) -> XLA's mnemonics
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
_SKIP_OPS = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


_NOT_SITES = (os.sep + "torch" + os.sep, "contextlib",
              os.path.join("repro_torch", "launch", "hlo_analysis.py"),
              os.path.join("repro_torch", "sharding", "dtensor.py"))


def op_site() -> str:
    """The innermost frame that issued the current op outside torch, this
    module and the DTensor helpers (whose collectives a model line asks
    for): "repro_torch/<path>:<line>"."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith("<") and not any(n in fn for n in _NOT_SITES):
            norm = fn.replace(os.sep, "/")
            i = norm.rfind("/repro_torch/")
            return f"{norm[i + 1:] if i >= 0 else os.path.basename(norm)}:{f.f_lineno}"
        f = f.f_back
    return "?:?"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


class Trace:
    """One device's record of a traced program (see the module docstring).

    ``collectives`` holds (mnemonic, result bytes, site) per collective;
    the site is the innermost frame outside torch that issued it (the
    model line of a head reshard). ``suppress`` > 0 pauses the record
    (building the state, DTensor's own shape propagation)."""

    def __init__(self):
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: list[tuple[str, int, str]] = []
        self.arguments = 0
        self.outputs = 0
        self.live = 0
        self.peak = 0
        self.suppress = 0
        self._seen = None

    # -- storage tracking ----------------------------------------------------

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> int:
        import weakref

        from torch.utils.weak import WeakIdKeyDictionary

        if self._seen is None:
            self._seen = WeakIdKeyDictionary()
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return n

    def add_arguments(self, tree) -> None:
        """Count the program's inputs (DTensors by their local shards):
        their bytes, held live from the start."""
        for t in _tensors(tree):
            t = _local(t)
            self.arguments += _nbytes(t)
            self._track(t)

    def add_outputs(self, tree) -> None:
        self.outputs += sum(_nbytes(_local(t)) for t in _tensors(tree))

    # -- what the dispatch mode sees -----------------------------------------

    def collective(self, kind: str, nbytes: int) -> None:
        self.collectives.append((kind, int(nbytes), op_site()))

    def on_op(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        ns, name = func.namespace, func.overloadpacket.__name__
        if ns in ("_c10d_functional", "_dtensor") and name in _FUNCOL_KINDS:
            self.collective(_FUNCOL_KINDS[name], sum(_nbytes(t) for t in _tensors(out)))
            return
        if ns == "c10d":
            kind = _C10D_KINDS.get(name)
            if kind is not None and name != "send":  # a shift counts where it lands
                self.collective(kind, sum(_nbytes(t) for t in _tensors(args[:1])))
            return
        if ns in ("_c10d_functional", "prim") or func.is_view or name in _SKIP_OPS:
            return
        outs = _tensors(out)
        if any(t.device.type == "meta" for t in outs):
            return  # shapes only: nothing runs on a device
        ins = _tensors((args, kwargs))
        if func.overloadpacket in flop_registry:
            self.flops += int(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
        self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if not name.endswith("_") and "out" not in kwargs:  # in place: no new storage
            for t in outs:
                self._track(t)

    # -- summaries -------------------------------------------------------------

    @property
    def temps(self) -> int:
        """Live bytes at the peak beyond the arguments and outputs."""
        return max(0, self.peak - self.arguments - self.outputs)

    def memory(self) -> dict:
        return {"arguments": self.arguments, "outputs": self.outputs, "temps": self.temps,
                "peak_est": self.arguments + self.outputs + self.temps}

    def collective_sites(self) -> dict:
        """(site, mnemonic) -> [count, result bytes]."""
        out: dict = {}
        for kind, n, site in self.collectives:
            c = out.setdefault((site, kind), [0, 0])
            c[0] += 1
            c[1] += n
        return out


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, type) and issubclass(t, DTensor)


class _FakeTraceMode(FakeTensorMode):
    """A ``FakeTensorMode`` that records every op it runs on local shards
    into its trace: the ops DTensor itself dispatches (with DTensor
    arguments) are left to DTensor, which comes back here with the local
    ones."""

    def __init__(self, trace: Trace):
        super().__init__(allow_non_fake_inputs=True)
        self.trace = trace
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        top = self.depth == 0 and not any(_is_dtensor_type(t) for t in types)
        self.depth += 1
        try:
            minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            if func is torch.ops.aten.bincount.default and minlength:
                # a data-dependent length; with minlength above every id
                # (the MoE router's expert counts) it is minlength
                with self:
                    out = torch.zeros((minlength,), dtype=torch.int64, device=args[0].device)
            else:
                out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self.depth -= 1
        if top and not self.trace.suppress and out is not NotImplemented:
            self.trace.on_op(func, args, kwargs, out)
        return out


class _RealTraceMode(TorchDispatchMode):
    """The record of ops on real tensors (a rank's PSVGP step, whose host
    reads a fake tensor cannot serve)."""

    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.trace.suppress:
            self.trace.on_op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def _shadow_ops_paused(trace: Trace):
    """DTensor computes an output's global metadata by running the op on
    global-shape fake tensors in the ambient fake mode: those shadow ops run
    on no device, so the trace pauses around them. And DTensor issues a
    shard-to-shard move on a CPU mesh as an all-gather plus a chunk, where
    the GPU mesh it stands for runs one all-to-all: the trace issues the
    all-to-all."""
    from torch.distributed.tensor import _sharding_prop, placement_types

    prop = _sharding_prop.ShardingPropagator
    orig_meta = prop._propagate_tensor_meta_non_cached
    orig_a2a = placement_types.shard_dim_alltoall

    def meta(self, op_schema):
        trace.suppress += 1
        try:
            return orig_meta(self, op_schema)
        finally:
            trace.suppress -= 1

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    strided = placement_types._StridedShard
    orig_strided = strided.local_shard_size_and_offset

    def strided_size(self, *args, **kwargs):
        with unset_fake_temporarily():  # index arithmetic on real host tensors
            return orig_strided(self, *args, **kwargs)

    prop._propagate_tensor_meta_non_cached = meta
    placement_types.shard_dim_alltoall = alltoall
    strided.local_shard_size_and_offset = strided_size
    try:
        yield
    finally:
        prop._propagate_tensor_meta_non_cached = orig_meta
        placement_types.shard_dim_alltoall = orig_a2a
        strided.local_shard_size_and_offset = orig_strided


@functools.cache
def _add_pointwise_strategies() -> None:
    """DTensor has no sharding strategy for ``log_sigmoid`` (the xLSTM
    gates): an elementwise op, it keeps any one placement, given to its
    inputs and outputs alike."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    def alike(n_out: int, n_in: int):
        def strategy(*args, **kwargs):
            ndim = args[0].ndim
            return [([pl] * n_out, [pl] * n_in)
                    for pl in [Replicate()] + [Shard(d) for d in range(ndim)]]
        return strategy

    register_sharding(aten.log_sigmoid_forward.default)(alike(2, 1))
    register_sharding(aten.log_sigmoid_backward.default)(alike(1, 3))


@contextlib.contextmanager
def fake_tracing(trace: Trace):
    """Enter the fake trace mode with ``trace.suppress`` raised: build the
    program's state inside, then :meth:`Trace.add_arguments` and lower
    ``trace.suppress`` by one to record the program. Yields the mode."""
    _add_pointwise_strategies()
    mode = _FakeTraceMode(trace)
    trace.suppress += 1
    with _shadow_ops_paused(trace), mode:
        yield mode


@contextlib.contextmanager
def real_tracing(trace: Trace):
    """Record the ops run inside on real tensors."""
    with _RealTraceMode(trace):
        yield


# --------------------------------------------------------------------------
# Roofline terms
# --------------------------------------------------------------------------


def collective_bytes(records) -> dict[str, int]:
    """Per-kind result bytes, per device, of ``records``: a :class:`Trace`,
    or (mnemonic, result bytes[, site]) tuples."""
    if isinstance(records, Trace):
        records = records.collectives
    out: dict[str, int] = collections.defaultdict(int)
    for rec in records:
        out[rec[0]] += int(rec[1])
    return dict(out)


class RooflineTerms(NamedTuple):
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        # no-overlap upper bound; perfect overlap would be max() instead
        return self.compute_s + self.memory_s + self.collective_s


def terms_from(flops: float, byts: float, breakdown: dict) -> RooflineTerms:
    cb = float(sum(breakdown.values()))
    return RooflineTerms(
        flops_per_device=float(flops),
        bytes_per_device=float(byts),
        collective_bytes_per_device=cb,
        collective_breakdown=dict(breakdown),
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=cb / LINK_BW,
    )


def roofline(trace: Trace) -> RooflineTerms:
    return terms_from(trace.flops, trace.bytes_accessed, collective_bytes(trace))


# --------------------------------------------------------------------------
# Model FLOPs (copied from the JAX package: pure Python on the config)
# --------------------------------------------------------------------------


def model_flops_train(cfg, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS = 6 N D with N = active params (MoE: routed active only),
    D = tokens. Per the assignment's definition for the 'useful compute'
    ratio (train includes fwd+bwd: the 6x already accounts for it)."""
    n_active = active_param_count(cfg)
    return 6.0 * n_active * seq_len * global_batch


def model_flops_decode(cfg, global_batch: int) -> float:
    """One decoded token per sequence: 2 N D (fwd only)."""
    return 2.0 * active_param_count(cfg) * global_batch


def has_time_while_loops(cfg) -> bool:
    """True if any block runs a scan over TIME (mlstm chunk scan, slstm
    step scan): the dry-run takes the analytical count below for the
    compute term, as the JAX package's does."""
    return any(b in ("mlstm", "slstm") for b in cfg.block_pattern)


def analytical_flops_recurrent(cfg, seq_len: int, batch: int, kind: str, chunk: int = 64) -> float:
    """TOTAL (all-device) flops for mlstm/slstm architectures, matmul-level
    accounting of exactly what the models' ssm module computes.

    Train counts fwd x 4 (backward 2x + remat recompute 1x, matching
    cfg.remat=True); prefill counts fwd; decode counts the one-step path.
    """
    D, V = cfg.d_model, cfg.vocab_size
    H = cfg.num_heads
    inner = cfg.rnn_width or 2 * D
    dh = inner // H
    W = cfg.rnn_width or D

    def mlstm_tok(decode: bool) -> float:
        proj = 2 * D * inner * 2 + 3 * 2 * inner * inner + 2 * inner * 2 * H + 2 * inner * D
        conv = 2 * cfg.conv_width * inner
        if decode:
            rec = H * (6 * dh * dh + 6 * dh)  # kv outer + state read + norms
        else:
            # per-chunk: scores 2c^2 dh, intra-out 2c^2 dh, decay ~4c^2,
            # inter q@C 2c dh^2, state update 2c dh^2  => per token:
            rec = H * (4 * chunk * dh + 4 * dh * dh + 4 * chunk)
        return proj + conv + rec

    def slstm_tok(decode: bool) -> float:
        return 2 * D * 4 * W + 2 * W * 4 * W + 24 * W + 2 * W * D

    per_tok = 0.0
    for i in range(cfg.num_layers):
        kind_i = cfg.block_pattern[i % cfg.period]
        if kind_i == "mlstm":
            per_tok += mlstm_tok(kind == "decode")
        elif kind_i == "slstm":
            per_tok += slstm_tok(kind == "decode")
    per_tok += 2 * D * V  # lm head
    tokens = batch * (1 if kind == "decode" else seq_len)
    fwd = per_tok * tokens
    if kind == "train":
        return 4.0 * fwd
    return fwd


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count from the config — non-embedding
    blocks + embeddings; MoE counts top_k + shared experts only."""
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    total = V * D * (1 if cfg.tie_embeddings else 2)  # embed + head
    per_pattern = {}
    for kind in set(cfg.block_pattern):
        if kind in ("attn", "local_attn"):
            p = D * H * hd + 2 * D * KV * hd + H * hd * D
        elif kind == "mla":
            a = cfg.mla
            qd = a.qk_nope_head_dim + a.qk_rope_head_dim
            p = (D * a.q_lora_rank + a.q_lora_rank * H * qd + D * a.kv_lora_rank
                 + D * a.qk_rope_head_dim + a.kv_lora_rank * H * a.qk_nope_head_dim
                 + a.kv_lora_rank * H * a.v_head_dim + H * a.v_head_dim * D)
        elif kind == "mlstm":
            inner = cfg.rnn_width or 2 * D
            p = 2 * D * inner + 3 * inner * inner + inner * 2 * H + inner * D
        elif kind == "slstm":
            W = cfg.rnn_width or D
            p = D * 4 * W + W * 4 * W + W * D
        elif kind == "rglru":
            W = cfg.rnn_width or D
            p = 2 * D * W + 2 * W * W + W * D
        else:
            p = 0
        per_pattern[kind] = p
    # mixing blocks, layer by layer (pattern cycled)
    for i in range(L):
        total += per_pattern[cfg.block_pattern[i % cfg.period]]
    # FFN per layer
    if cfg.mlp_kind != "none":
        if cfg.moe is not None:
            m = cfg.moe
            active_ff = (m.top_k + m.num_shared) * m.d_expert
            per_moe = 3 * D * active_ff + D * m.num_experts  # + router
            n_moe = L - (1 if m.first_layer_dense else 0)
            total += n_moe * per_moe
            if m.first_layer_dense:
                total += 3 * D * m.dense_d_ff
        else:
            mult = 3 if cfg.mlp_kind == "swiglu" else 2
            total += L * mult * D * cfg.d_ff
    # encoder stack (whisper)
    if cfg.encoder is not None:
        e = cfg.encoder
        enc_per = D * H * hd + 2 * D * KV * hd + H * hd * D + 2 * D * cfg.d_ff
        total += e.num_layers * enc_per
        # decoder cross-attention
        total += L * (D * H * hd + 2 * D * KV * hd + H * hd * D)
    return float(total)
