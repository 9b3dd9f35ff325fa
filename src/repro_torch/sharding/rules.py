"""Logical-axis sharding rules with divisibility fallback (MaxText-style).

Port of ``repro.sharding.rules``; the rules, the fallback and the specs
are JAX's, leaf for leaf. Strategy on the production mesh (pod, data,
model):
  * batch dims            -> (pod, data) combined
  * tensor-parallel dims  -> model (FFN hidden, head products, vocab,
                             MoE expert axis, recurrent width)
  * any dim not divisible by its mesh-axis size falls back to REPLICATED
    for that axis — this is what lets qwen2's 14 heads or whisper's 8 heads
    stay on a 16-wide model axis while its FFN/vocab still shard.

A spec is a tuple, as JAX's ``PartitionSpec``: one entry per leading dim
of the leaf (missing trailing entries replicate), each ``None``, a mesh
axis name, or a tuple of axis names (sharded over their product, the
first outermost). ``()`` replicates the whole leaf. A mesh is anything
with ``axis_names``, ``shape`` (axis name -> size) and ``size``
(``repro_torch.launch.mesh.MeshSpec``).

Rules are keyed on parameter-tree path names (dict keys, list indices and
NamedTuple fields), so they cover every block kind in
``repro_torch.models`` without per-arch tables. Stacked leaves (period
stack) carry a leading period axis which is never sharded.
:func:`to_placements` turns a spec into DTensor placements.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Sequence
from typing import Any

from repro_torch.optim.adam import AdamState

Spec = tuple

# name -> per-dim logical axes, innermost dims rightmost. "model" marks the
# tensor-parallel dim; None replicates. Entries match the TRAILING dims of
# the leaf (leading stack/period axes are implicitly None).
_RULES = {
    # embeddings / head
    "embed": ("model", None),  # vocab-parallel
    "pos_embed": (None, None),
    "enc_pos": (None, None),
    "lm_head": (None, "model"),
    # attention projections
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    # MLA
    "w_dq": (None, None),
    "w_uq": (None, "model"),
    "w_dkv": (None, None),
    "w_kr": (None, None),
    "w_uk": (None, "model"),
    "w_uv": (None, "model"),
    # MLP (2D) — MoE expert weights (3D) handled by ndim dispatch below
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    "b_up": ("model",),
    "b_down": (None,),
    "router": (None, None),
    # recurrent blocks
    "w_a": (None, "model"),
    "w_b": (None, "model"),
    "conv": (None, "model"),
    "w_r": ("model", None),
    "w_i": ("model", None),
    "w_out": ("model", None),
    "w_if": ("model", None),
    "w_in": (None, None),
    "r": (None, None),
    "b": (None,),
    "b_if": (None,),
    "out_norm": ("model",),
    # projector (VLM)
    "w1": (None, None),
    "w2": (None, None),
}

_MOE_RULES = {  # 3D expert-stacked weights: expert-parallel on model axis
    "w_gate": ("model", None, None),
    "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes used for batch sharding (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _axes_size(axis, mesh) -> int:
    return math.prod(mesh.shape[a] for a in (axis if isinstance(axis, tuple) else (axis,)))


def _axis_ok(dim: int, axis, mesh):
    if axis is None:
        return None
    return axis if dim % _axes_size(axis, mesh) == 0 else None


def _spec_for(path_names: Sequence[str], leaf, mesh, fsdp: bool = False) -> Spec:
    name = path_names[-1] if path_names else ""
    in_moe = "moe" in path_names
    rule = None
    if in_moe and leaf.ndim >= 3 and name in _MOE_RULES:
        rule = _MOE_RULES[name]
    elif name in _RULES:
        rule = _RULES[name]
    if rule is None:
        return ()  # norms, scalars, anything unnamed: replicate
    nlead = leaf.ndim - len(rule)
    if nlead < 0:
        return ()
    dims = tuple(leaf.shape[nlead:])
    axes = [_axis_ok(d, a, mesh) for d, a in zip(dims, rule, strict=True)]
    if fsdp:
        # ZeRO-3 style: additionally shard the first replicated dim of every
        # weight over the (pod, data) axes; the trace gathers the weight
        # before use and reduce-scatters its gradient.
        daxes = data_axes(mesh)
        for i, (d, a) in enumerate(zip(dims, axes, strict=True)):
            if a is None and _axis_ok(d, daxes, mesh) is not None:
                axes[i] = daxes
                break
    return (None,) * nlead + tuple(axes)


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "ndim")


def tree_map_with_path(fn: Callable, tree: Any, path: tuple[str, ...] = ()) -> Any:
    """``fn(path_names, leaf)`` over the port's trees, as
    ``jax.tree_util.tree_map_with_path`` with JAX's ``_path_names``: dict
    keys (``DictKey``), list and tuple indices (``SequenceKey``) and
    NamedTuple fields (``GetAttrKey``) name the path; ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, list | tuple):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)  # a host scalar (a step count): a leaf


def leaf_specs(specs: Any) -> list[Spec]:
    """The specs of a spec tree (from :func:`params_pspecs` and the like),
    in :func:`tree_map_with_path`'s order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in leaf_specs(v)]
    if isinstance(specs, list) or (isinstance(specs, tuple) and hasattr(specs, "_fields")):
        return [s for v in specs for s in leaf_specs(v)]
    return [specs]


def params_pspecs(params: Any, mesh, fsdp: bool = False) -> Any:
    """Spec tree matching ``params``."""
    return tree_map_with_path(lambda path, leaf: _spec_for(path, leaf, mesh, fsdp),
                              params)


def state_pspecs(state, mesh, fsdp: bool = False):
    """Specs for a TrainState/PSVGPState-like (params, AdamState, step).
    With fsdp=True the optimizer moments shard with the params (ZeRO)."""
    pspec = params_pspecs(state.params, mesh, fsdp)
    return type(state)(
        params=pspec,
        opt=AdamState(step=(), mu=pspec, nu=pspec),
        step=(),
    )


def batch_pspec(mesh, batch_shardable: bool = True) -> Spec:
    """Spec for (B, S) token arrays: batch over (pod, data)."""
    return (data_axes(mesh),) if batch_shardable else ()


def gp_stacked_pspecs(tree: Any, mesh) -> Any:
    """Specs for P-stacked GP serving trees: shard the leading partition
    axis over ALL mesh axes (one partition per device).

    Used for the posterior cache (each device holds exactly its own
    partition's factors) and for the routed query blocks. The leading axis
    of every leaf must equal ``mesh.size`` (partition iy*gx+ix on device
    (row=iy, col=ix)); anything else is a routing bug, so this raises
    instead of falling back to replication.
    """
    lead = (tuple(mesh.axis_names),)

    def spec(_, leaf):
        if leaf.ndim < 1 or leaf.shape[0] != mesh.size:
            raise ValueError(
                f"GP-stacked leaf {tuple(leaf.shape)} does not carry a leading "
                f"partition axis of size mesh.size={mesh.size}"
            )
        return lead

    return tree_map_with_path(spec, tree)


def cache_pspecs(cache: Any, mesh, *, shard_seq: bool) -> Any:
    """Decode-cache specs.

    Default (decode_32k): batch dim over (pod,data), heads/width over model.
    shard_seq (long_500k, batch=1): the SEQUENCE dim of attention caches is
    sharded over (pod,data) instead — sequence-parallel KV.
    """
    daxes = data_axes(mesh)
    dsize = _axes_size(daxes, mesh)

    def spec(path, leaf):
        names = path
        name = names[-1]
        nlead = 1 if "stack" in names else 0  # stacked period axis
        lead = (None,) * nlead
        if name in ("k", "v", "cross_k", "cross_v"):  # (B, S, KV, hd)
            kv = leaf.shape[nlead + 2]
            head_ax = "model" if kv % mesh.shape["model"] == 0 else None
            if shard_seq:
                seq_ok = leaf.shape[nlead + 1] % dsize == 0
                return lead + (None, daxes if seq_ok else None, head_ax, None)
            b_ok = leaf.shape[nlead] % dsize == 0
            return lead + (daxes if b_ok else None, None, head_ax, None)
        if name in ("c_kv", "k_rope"):  # (B, S, r) MLA latents
            if shard_seq:
                seq_ok = leaf.shape[nlead + 1] % dsize == 0
                return lead + (None, daxes if seq_ok else None, None)
            b_ok = leaf.shape[nlead] % dsize == 0
            return lead + (daxes if b_ok else None, None, None)
        if name in ("conv", "h", "state", "norm", "c", "n", "m"):
            # recurrent states: last dim is width/heads -> model if divisible
            ax = "model" if leaf.shape[-1] % mesh.shape["model"] == 0 else None
            return (None,) * (leaf.ndim - 1) + (ax,)
        return ()

    return tree_map_with_path(spec, cache)


def fold_spec(spec: Spec, mesh) -> Spec:
    """``spec`` on ``launch.mesh.trace_mesh(mesh)``: the data axes, which
    every rule names together, as the one folded "data" axis."""
    daxes = data_axes(mesh)

    def entry(e):
        if e is None or e == "model":
            return e
        axes = e if isinstance(e, tuple) else (e,)
        rest = tuple(a for a in axes if a not in daxes)
        if len(axes) - len(rest) not in (0, len(daxes)) or rest not in ((), ("model",)):
            raise ValueError(f"spec entry {e} splits the data axes {daxes}")
        out = (("data",) if len(rest) < len(axes) else ()) + rest
        return out[0] if len(out) == 1 else out

    return tuple(entry(e) for e in spec)


def map_specs(fn: Callable, specs: Any) -> Any:
    """``fn`` over every spec of a spec tree (a spec is a plain tuple)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v) for v in specs))
    if isinstance(specs, list):
        return [map_specs(fn, v) for v in specs]
    return fn(specs)


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements for ``spec`` on ``mesh`` (one per mesh axis):
    ``Shard(i)`` on every mesh axis that entry i names, ``Replicate()``
    elsewhere (and on an axis of size 1, where the two are one layout). An
    entry naming several axes (("pod", "data")) shards dim i over them in
    mesh order, the first outermost, as JAX lays them out."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh axes out of mesh order {names}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {names[j]!r} used twice in spec {spec}")
            if mesh.shape[names[j]] > 1:  # a size-1 axis holds the whole dim either way
                out[j] = Shard(i)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` leaf under ``spec``
    (every sharded dim divides its axes' product: the rules only shard
    such dims)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            n = _axes_size(entry, mesh)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide {entry} ({n})")
            out[i] //= n
    return tuple(out)
