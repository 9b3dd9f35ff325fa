"""What the models need from DTensor when the dry-run traces them sharded.

The single-device paths never reach past the first line of each helper:
a plain tensor is returned as it is (the same object).

GSPMD reshards a tensor whenever a reshape splits a sharded dim unevenly
(JAX's rules shard ``wk`` when KV x hd divides the model axis, though KV
alone may not). DTensor refuses such a view instead, so the models call
:func:`reshard_for_heads` before each head reshape: it makes GSPMD's
implicit all-gather explicit.
"""
from __future__ import annotations

import torch


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    return type(x) is not torch.Tensor and isinstance(x, _dtensor_type())


def reshard_for_heads(x, n_heads: int, dim: int = -1):
    """``x`` ready for a reshape that splits its dim ``dim`` into
    (n_heads, ...) or flattens it (n_heads long) into the next: a plain
    tensor unchanged; a DTensor whose dim ``dim`` is sharded over a mesh
    dim whose size does not divide ``n_heads`` with that mesh dim
    replicated (an all-gather), and a pending sum over a mesh dim reduced
    (an all-reduce)."""
    if type(x) is torch.Tensor or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim = dim % x.ndim
    mesh_sizes = x.device_mesh.shape
    placements = list(x.placements)
    changed = False
    for j, pl in enumerate(placements):
        uneven = pl.is_shard() and pl.dim % x.ndim == dim and n_heads % mesh_sizes[j]
        if uneven or pl.is_partial():  # a pending sum: the view would scatter it unevenly
            placements[j] = Replicate()
            changed = True
    return x.redistribute(x.device_mesh, placements) if changed else x


class _GradForHeads(torch.autograd.Function):
    """Forward: the tensor as it is. Backward: its gradient through
    :func:`reshard_for_heads`, so that the reshape's backward can undo
    the split or merge of heads."""

    @staticmethod
    def forward(ctx, y, n_heads, dim):
        ctx.n_heads, ctx.dim = n_heads, dim
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return reshard_for_heads(grad, ctx.n_heads, ctx.dim), None, None


def head_reshape(x, shape, n_heads: int, dim: int = -1):
    """``x.reshape(shape)``, a reshape that splits ``x``'s dim ``dim`` into
    (n_heads, ...) or merges (n_heads, ...) starting at ``dim`` into one
    dim. A plain tensor is reshaped and nothing else. A DTensor goes
    through :func:`reshard_for_heads` first (and, for a merge, the dims it
    folds in replicated), and its gradient after (at the same dim of the
    result), as GSPMD reshards both ways unasked."""
    if type(x) is torch.Tensor or not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate

    dim = dim % x.ndim
    x = reshard_for_heads(x, n_heads, dim)
    merged = range(dim + 1, dim + 1 + x.ndim - len(shape))  # the dims a merge folds in
    if any(pl.is_shard() and pl.dim % x.ndim in merged for pl in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if pl.is_shard() and pl.dim % x.ndim
                                           in merged else pl for pl in x.placements])
    return _GradForHeads.apply(x.reshape(shape), n_heads, dim)


def mesh_spec_of(dmesh):
    """The ``MeshSpec`` (axis names, sizes) of a ``DeviceMesh``."""
    from repro_torch.launch.mesh import MeshSpec

    return MeshSpec(tuple(dmesh.mesh_dim_names), tuple(dmesh.shape))


def distribute(tree, specs, dmesh, *, fill=torch.empty):
    """Each tensor leaf of ``tree`` (its global shape and dtype; its values
    unused) as a DTensor on ``dmesh`` whose local shard, of the shape
    ``specs`` gives it, is made by ``fill`` in the ambient mode (a fake
    tensor under the dry-run's). Other leaves pass through."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import local_shape, to_placements
    from repro_torch.optim.adam import tree_map

    mesh = mesh_spec_of(dmesh)

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        loc = fill(local_shape(t.shape, spec, mesh), dtype=t.dtype)
        return DTensor.from_local(loc, dmesh, to_placements(spec, mesh), run_check=False)

    return tree_map(one, tree, specs)


def sharded_cache(cfg, like, batch: int, seq: int, dtype):
    """``transformer.init_cache``'s tree as DTensors on ``like``'s mesh,
    zero-filled local shards laid out by ``cache_pspecs`` (batch over the
    data axes): the cache a sharded prefill fills."""
    from repro_torch.models import transformer
    from repro_torch.sharding.rules import cache_pspecs

    shapes = transformer.init_cache(cfg, batch, seq, dtype, device="meta")
    dmesh = like.device_mesh
    specs = cache_pspecs(shapes, mesh_spec_of(dmesh), shard_seq=False)
    return distribute(shapes, specs, dmesh, fill=torch.zeros)


def moe_forward_sharded(p, cfg, x):
    """JAX's ``shard_map`` MoE on a DTensor ``x`` (B, S, D), or None where
    the mesh has no model axis > 1 dividing the expert count: tokens over
    the data axes (when the batch divides them), experts over ``model``,
    each rank runs ``moe._moe_forward_spmd`` on its shards with the model
    axis's group, whose one all-reduce sums the experts' partial outputs.
    The load-balance loss is averaged over the data axes, as JAX's pmean."""
    import dataclasses
    import math

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import moe

    dmesh = x.device_mesh
    names = tuple(dmesh.mesh_dim_names)
    if "model" not in names:
        return None
    jm = names.index("model")
    n_model = dmesh.shape[jm]
    if n_model <= 1 or cfg.moe.num_experts % n_model:
        return None
    B, S, D = x.shape
    d_size = math.prod(s for j, s in enumerate(dmesh.shape) if j != jm)
    shard_b = B % d_size == 0
    x_pl = [Shard(0) if (j != jm and shard_b) else Replicate() for j in range(len(names))]
    rep = [Replicate()] * len(names)
    w_pl = [Shard(0) if j == jm else Replicate() for j in range(len(names))]
    local = {"router": p["router"].redistribute(dmesh, rep).to_local()}
    for w in ("w_gate", "w_up", "w_down"):
        local[w] = p[w].redistribute(dmesh, w_pl).to_local()
    cfg_l = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared=0))
    out_l, aux_l = moe._moe_forward_spmd(local, cfg_l, x.redistribute(dmesh, x_pl).to_local(),
                                         dmesh.get_group("model"))
    out = DTensor.from_local(out_l, dmesh, x_pl, run_check=False)
    aux_pl = [Partial("avg") if (j != jm and shard_b) else Replicate()
              for j in range(len(names))]
    aux = DTensor.from_local(aux_l, dmesh, aux_pl, run_check=False).redistribute(dmesh, rep)
    if cfg.moe.num_shared > 0:
        out = out + moe._shared(p, x)  # (B, S, D) whole: no flattened batch to split
    return out, aux


def write_slot(buf, slot, new) -> None:
    """``buf[:, slot] = new[:, 0]`` in place on a DTensor cache ``buf`` (B,
    S, ...), each rank writing its own shard: where the sequence dim is
    sharded (``long_500k``'s sequence-parallel cache) the rank holding the
    slot writes it and the others write their own row back, a select, as
    GSPMD lowers a dynamic update of a sharded dim. No collective beyond
    laying ``new`` out as ``buf``."""
    from torch.distributed.tensor import Replicate

    dmesh = buf.device_mesh
    seq_dims = [j for j, pl in enumerate(buf.placements) if pl.is_shard() and pl.dim == 1]
    new_pl = [Replicate() if j in seq_dims else pl for j, pl in enumerate(buf.placements)]
    bl = buf.to_local()
    nl = new.redistribute(dmesh, new_pl).to_local().to(bl.dtype)
    L = bl.shape[1]
    chunk = 0  # this rank's chunk of the sequence dim, row-major over seq_dims
    coord = dmesh.get_coordinate()
    for j in seq_dims:
        chunk = chunk * dmesh.shape[j] + coord[j]
    local = torch.as_tensor(slot, device=bl.device).reshape(1).to(torch.long) - chunk * L
    idx = local.clamp(0, L - 1)
    if seq_dims:
        inside = ((local >= 0) & (local < L)).reshape((1,) * bl.ndim)
        nl = torch.where(inside, nl, bl.index_select(1, idx))
    bl.index_copy_(1, idx, nl)


def batch_local(fn, batched, replicated=()):
    """``fn(*batched, *replicated)`` where every tensor in ``batched`` leads
    with the batch dim and ``fn`` works row by row (the xLSTM's time
    loops): plain tensors go straight in. With DTensors each rank runs
    ``fn`` on its own batch rows and the replicated rest, and the outputs
    (each leading with the batch dim) come back as DTensors sharded as the
    batch: the same local work, without DTensor's dispatch at every step
    of the loop."""
    ref = next((a for a in batched if is_dtensor(a)), None)
    if ref is None and not any(is_dtensor(a) for a in replicated):
        return fn(*batched, *replicated)
    from torch.distributed.tensor import DTensor, Replicate

    dmesh = (ref if ref is not None else next(a for a in replicated if is_dtensor(a))).device_mesh
    rep = [Replicate()] * dmesh.ndim
    rows = _rows_layout(dmesh, ref) if ref is not None else rep
    outs = fn(*(_to_local(a, dmesh, rows) for a in batched),
              *(_to_local(a, dmesh, rep) for a in replicated))
    return tuple(DTensor.from_local(o, dmesh, rows, run_check=False) for o in outs)


def _rows_layout(dmesh, ref, head_dim=None, split_heads=False) -> list:
    """Placements for a tensor that leads with the batch dim: Shard(0)
    where ``ref`` shards its batch, the heads at ``head_dim`` over "model"
    when ``split_heads``, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(dmesh.mesh_dim_names)
    out = []
    for j, pl in enumerate(ref.placements):
        if pl.is_shard() and pl.dim == 0 and names[j] != "model":
            out.append(Shard(0))
        elif split_heads and head_dim is not None and names[j] == "model":
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return out


class _ContiguousGrad(torch.autograd.Function):
    """Forward: the tensor as it is. Backward: its gradient made
    contiguous, as DTensor's moves of a gradient shard expect it (a local
    einsum's backward hands back transposed strides)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _to_local(a, dmesh, placements):
    """``a`` laid out as ``placements`` on ``dmesh``, this rank's shard."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(a):
        a = DTensor.from_local(a, dmesh, [Replicate()] * dmesh.ndim, run_check=False)
    return _ContiguousGrad.apply(a.redistribute(dmesh, placements).to_local())


def heads_local(fn, args, head_dims):
    """``fn(*args)``, attention's core: every tensor in ``args`` leads with
    the batch dim and holds its heads at ``head_dims[i]`` (None: no head
    dim, as MLA's shared rope key); the output leads with the batch and
    holds its heads at ``head_dims[0]``. Plain tensors go straight in.
    With DTensors each rank runs ``fn`` on its batch rows (as the first
    argument shards them) and, where every head count divides the model
    axis, on its heads, the rest gathered first: the work is parallel over
    both, so nothing else moves. A sequence-sharded argument (the
    ``long_500k`` cache) needs a softmax across ranks: DTensor runs ``fn``
    then."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor

    if any(is_dtensor(a) and any(pl.is_shard() and pl.dim % a.ndim not in (0, hd)
                                 for pl in a.placements)
           for a, hd in zip(args, head_dims, strict=True) if hd is not None):
        return fn(*args)
    ref = next(a for a in args if is_dtensor(a))
    dmesh = ref.device_mesh
    names = tuple(dmesh.mesh_dim_names)
    n = dmesh.shape[names.index("model")] if "model" in names else 1
    split = n > 1 and all(a.shape[hd] % n == 0 for a, hd in zip(args, head_dims) if hd is not None)
    lead = args[0] if is_dtensor(args[0]) else ref
    out = fn(*(_to_local(a, dmesh, _rows_layout(dmesh, lead, hd, split))
               for a, hd in zip(args, head_dims, strict=True)))
    return DTensor.from_local(out, dmesh, _rows_layout(dmesh, lead, head_dims[0], split),
                              run_check=False)


def embed_lookup(table, ids):
    """``table[ids]``. A DTensor table sharded on its rows (the vocab) is
    looked up vocab-parallel, as Megatron and GSPMD do: each rank gathers
    the ids its rows hold (zeros for the rest) and the rows' mesh axes sum
    them, one all-reduce."""
    if not is_dtensor(table) and not is_dtensor(ids):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dmesh = (table if is_dtensor(table) else ids).device_mesh
    vocab = [j for j, pl in enumerate(table.placements) if pl.is_shard() and pl.dim == 0] \
        if is_dtensor(table) else []
    ids_pl = _rows_layout(dmesh, ids) if is_dtensor(ids) else [Replicate()] * dmesh.ndim
    ids_pl = [Replicate() if j in vocab else pl for j, pl in enumerate(ids_pl)]
    tl = _to_local(table, dmesh, [Shard(0) if j in vocab else Replicate()
                                  for j in range(dmesh.ndim)])
    il = _to_local(ids, dmesh, ids_pl).to(torch.long)
    if not vocab:
        return DTensor.from_local(tl[il], dmesh, ids_pl, run_check=False)
    chunk, coord = 0, dmesh.get_coordinate()
    for j in vocab:
        chunk = chunk * dmesh.shape[j] + coord[j]
    rows = tl.shape[0]
    local = il - chunk * rows
    inside = ((local >= 0) & (local < rows)).to(tl.dtype)[..., None]
    out = tl[local.clamp(0, rows - 1)] * inside
    part = [Partial() if j in vocab else pl for j, pl in enumerate(ids_pl)]
    return DTensor.from_local(out, dmesh, part, run_check=False).redistribute(dmesh, ids_pl)


def vocab_parallel_ce(logits, targets, ce):
    """``ce(logits, targets)`` (the mean token cross-entropy) on DTensor
    logits (B, S, V): batch rows over the data axes, the vocab over the
    axes that shard it. Each rank takes its rows' max, sum of exponentials
    and gold logit over its vocab shard; the vocab's axes reduce them (a
    max and two sums), the batch's average the loss. With the vocab whole
    on each rank, ``ce`` runs on the rank's rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dmesh = logits.device_mesh
    last = logits.ndim - 1
    vocab = [j for j, pl in enumerate(logits.placements) if pl.is_shard() and pl.dim == last]
    rows = [Replicate() if j in vocab else pl for j, pl in enumerate(_rows_layout(dmesh, logits))]
    ll = _to_local(logits, dmesh, [Shard(last) if j in vocab else pl
                                   for j, pl in enumerate(rows)])
    tl = _to_local(targets, dmesh, rows)

    def reduce(x, op):
        part = [Partial(op) if j in vocab else pl for j, pl in enumerate(rows)]
        return DTensor.from_local(x, dmesh, part, run_check=False).redistribute(
            dmesh, rows).to_local()

    if vocab:
        m = reduce(ll.detach().amax(-1), "max")
        logz = m + torch.log(reduce(torch.exp(ll - m[..., None]).sum(-1), "sum"))
        chunk, coord = 0, dmesh.get_coordinate()
        for j in vocab:
            chunk = chunk * dmesh.shape[j] + coord[j]
        local = tl.to(torch.long) - chunk * ll.shape[-1]
        inside = (local >= 0) & (local < ll.shape[-1])
        gold = torch.gather(ll, -1, local.clamp(0, ll.shape[-1] - 1)[..., None])[..., 0]
        loss = torch.mean(logz - reduce(gold * inside, "sum"))
    else:
        loss = ce(ll, tl)
    avg = [Partial("avg") if pl.is_shard() else Replicate() for pl in rows]
    return DTensor.from_local(loss, dmesh, avg, run_check=False).redistribute(
        dmesh, [Replicate()] * dmesh.ndim)


def rows_local(fn, *args):
    """``fn(*args)`` where every tensor in the argument trees that leads
    with the rows (the P cells of a stacked GP state) is worked row by
    row: plain trees go straight in. With DTensors each rank runs ``fn``
    on its own rows (the rest of each tree whole), and the output tree's
    row tensors come back sharded as the rows."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(args)
    ref = next((a for a in leaves if is_dtensor(a) and a.ndim), None)
    if ref is None:
        return fn(*args)
    dmesh = ref.device_mesh
    rows, rep = _rows_layout(dmesh, ref), [Replicate()] * dmesh.ndim

    def is_rows(t) -> bool:
        return isinstance(t, torch.Tensor) and t.ndim > 0 and t.shape[0] == ref.shape[0]

    local = [_to_local(a, dmesh, rows if is_rows(a) else rep) if isinstance(a, torch.Tensor)
             else a for a in leaves]
    n_local = next(a.shape[0] for a, g in zip(local, leaves) if is_rows(g))
    out, ospec = tree_flatten(fn(*tree_unflatten(local, spec)))
    return tree_unflatten([DTensor.from_local(o, dmesh, rows if o.ndim and o.shape[0] == n_local
                                              else rep, run_check=False)
                           if isinstance(o, torch.Tensor) else o for o in out], ospec)
