"""What the models need from DTensor when the dry-run traces them sharded.

The single-device paths never reach past the first line of each helper:
a plain tensor is returned as it is (the same object).

GSPMD reshards a tensor whenever a reshape splits a sharded dim unevenly
(JAX's rules shard ``wk`` when KV x hd divides the model axis, though KV
alone may not). DTensor refuses such a view instead, so the models call
:func:`reshard_for_heads` before each head reshape: it makes GSPMD's
implicit all-gather explicit.

Where DTensor would choose a layout by its own cost model (a product's
strategy, which changes between torch versions), the models call a
helper that lays its operands out explicitly, as Megatron writes a
tensor-parallel layer: :func:`linear` (column- and row-parallel
products), :func:`vocab_logits` (the LM head), :func:`embed_lookup`,
:func:`vocab_parallel_ce`, :func:`heads_local` (attention's core) and
:func:`batch_local` (the recurrent loops). Each runs local products on
local shards and issues its collectives itself, so a trace's record
depends on the port's code alone. A replicated operand's gradient is a
sum over the mesh axes its partners are split on (``grad_placements``),
as a tensor-parallel backward sums it. These paths are traced on fake
tensors (``launch.dryrun``); none runs sharded on real data.
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

    def over_tokens(pl):  # a weight's gradient sums over the axes that split the tokens
        return _summed(dmesh, pl, lambda j: x_pl[j].is_shard())

    local = {"router": _to_local(p["router"], dmesh, rep, over_tokens(rep))}
    for w in ("w_gate", "w_up", "w_down"):
        local[w] = _to_local(p[w], dmesh, w_pl, over_tokens(w_pl))
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
    local = (torch.as_tensor(slot, device=bl.device).reshape(1).to(torch.long)
             - _chunk(dmesh, seq_dims) * L)
    idx = local.clamp(0, L - 1)
    if seq_dims:
        inside = ((local >= 0) & (local < L)).reshape((1,) * bl.ndim)
        nl = torch.where(inside, nl, bl.index_select(1, idx))
    bl.index_copy_(1, idx, nl)


def batch_local(fn, batched, replicated=(), split=None, out_split=None):
    """``fn(*batched, *replicated)`` where every tensor in ``batched`` leads
    with the batch dim and ``fn`` works row by row (the xLSTM's time
    loops): plain tensors go straight in. With DTensors each rank runs
    ``fn`` on its own batch rows and the replicated rest, and the outputs
    (each leading with the batch dim) come back as DTensors sharded as the
    batch: the same local work, without DTensor's dispatch at every step
    of the loop. A None passes as it is, in and out.

    ``split`` (an entry an argument, ``batched`` then ``replicated``: a dim,
    or None) names dims along which ``fn`` is independent too (the mLSTM's
    value dim, the channels of a conv or a gate): where the model axis
    divides each of them, each rank takes its slice of those dims and the
    rest whole, and the outputs' dims ``out_split`` come back split over
    the model axis (the others, which every rank computes whole,
    replicated; since the whole arguments' gradients then sum over the
    model axis, each rank backpropagates 1/n of such an output's
    gradient, so that the sum counts it once)."""
    args = (*batched, *replicated)
    ref = next((a for a in batched if is_dtensor(a)), None)
    if ref is None and not any(is_dtensor(a) for a in replicated):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dmesh = (ref if ref is not None else next(a for a in replicated if is_dtensor(a))).device_mesh
    rep = [Replicate()] * dmesh.ndim
    rows = _rows_layout(dmesh, ref) if ref is not None else rep
    jm = _model_dim(dmesh)
    n = dmesh.shape[jm] if jm is not None else 1
    split = split or (None,) * len(args)
    if n == 1 or all(d is None for d in split) or any(
            d is not None and a is not None and a.shape[d] % n
            for a, d in zip(args, split, strict=True)):
        split, out_split = (None,) * len(args), None
    on_model = any(d is not None for d in split)

    def lay(base, d):  # ``base`` with dim d over "model"
        return [Shard(d) if j == jm and d is not None else pl for j, pl in enumerate(base)]

    def local(i, a, d):
        base = rows if i < len(batched) else rep
        # a whole argument's gradient sums over the model axis when the
        # others are split, and a replicated one's over the batch axes too
        return _to_local(a, dmesh, lay(base, d), _summed(
            dmesh, lay(base, d), lambda j: (j == jm and on_model and d is None)
            or (i >= len(batched) and rows[j].is_shard())))

    outs = fn(*(a if a is None else local(i, a, d)
                for i, (a, d) in enumerate(zip(args, split, strict=True))))
    out_split = out_split or (None,) * len(outs)
    return tuple(o if o is None else DTensor.from_local(
        _SharedGrad.apply(o, n) if on_model and d is None else o, dmesh, lay(rows, d),
        run_check=False) for o, d in zip(outs, out_split, strict=True))


class _SharedGrad(torch.autograd.Function):
    """Forward: the tensor as it is. Backward: its gradient over ``n``, the
    share of one of the n ranks that each compute the tensor whole from
    operands whose gradients sum over those ranks (DTensor's partition of
    a replicated value into a pending sum)."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def like(t, ref):
    """``t`` laid out as ``ref`` (a DTensor of the same shape): a plain
    ``t`` as it is. Where two operands of an elementwise op, or a
    gradient and its parameter, meet in different layouts, DTensor would
    choose which to move by its own cost model; this moves ``t``."""
    if not is_dtensor(t) or not is_dtensor(ref) or tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def whole(t):
    """``t`` (a parameter) whole on every rank: a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _rows_layout(dmesh, ref) -> list:
    """Placements for a tensor that leads with the batch dim: Shard(0)
    where ``ref`` shards its batch over a mesh dim other than "model",
    Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(dmesh.mesh_dim_names)
    return [Shard(0) if pl.is_shard() and pl.dim == 0 and names[j] != "model" else Replicate()
            for j, pl in enumerate(ref.placements)]


def linear(x, w):
    """``x @ w``, x (..., K) leading with its batch rows, w (K, N): a plain
    tensor is multiplied and nothing else. Sharded, it is Megatron's
    layer, chosen by how the rules lay ``w`` out over the model axis: N
    split (column-parallel): each rank multiplies x whole by its columns,
    and the output is split as N; K split (row-parallel): each rank
    multiplies its slice of x's K by its rows, and one all-reduce sums
    them; neither: each rank forms the whole product. x keeps its batch
    rows on their data axes; the weight is gathered on any other axis
    (FSDP's gather), and its gradient sums over the batch axes."""
    if not is_dtensor(x) and not is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dmesh = (x if is_dtensor(x) else w).device_mesh
    jm = _model_dim(dmesh)
    rows = _rows_layout(dmesh, x) if is_dtensor(x) else [Replicate()] * dmesh.ndim
    last, wk = x.ndim - 1, w.ndim - 2
    wm = w.placements[jm] if is_dtensor(w) and jm is not None else Replicate()
    col = wm.is_shard() and wm.dim % w.ndim == w.ndim - 1 and dmesh.shape[jm] > 1
    row = wm.is_shard() and wm.dim % w.ndim == wk and dmesh.shape[jm] > 1
    w_pl = [(Shard(w.ndim - 1) if col else Shard(wk) if row else Replicate())
            if j == jm else Replicate() for j in range(dmesh.ndim)]
    wl = _to_local(w, dmesh, w_pl, _summed(dmesh, w_pl, lambda j: rows[j].is_shard()))

    def with_model(pl):
        return [pl if j == jm else r for j, r in enumerate(rows)]

    if col:
        xl = _to_local(x, dmesh, rows, with_model(Partial()))
        return DTensor.from_local(xl @ wl, dmesh, with_model(Shard(last)), run_check=False)
    if row:
        xl = _to_local(x, dmesh, with_model(Shard(last)))
        out = DTensor.from_local(xl @ wl, dmesh, with_model(Partial()), run_check=False)
        return out.redistribute(dmesh, rows)
    return DTensor.from_local(_to_local(x, dmesh, rows) @ wl, dmesh, rows, run_check=False)


def vocab_logits(x, head, fn):
    """The LM head: ``fn(x, head, 0)``, where ``fn(h, w, v0)`` forms the
    logits of ``h`` (B, S, D) against the columns of ``w`` that start at
    vocab id ``v0``, for ``head`` (D, V). Sharded, as :func:`embed_lookup`
    on the input side, each rank multiplies its batch rows by its vocab
    shard of ``head``, and the logits come back (B, S, V) split as the
    vocab: the loss (:func:`vocab_parallel_ce`) and a prefill's last
    position read them shard by shard, and nothing gathers them."""
    if not is_dtensor(x) and not is_dtensor(head):
        return fn(x, head, 0)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dmesh = (x if is_dtensor(x) else head).device_mesh
    vocab = [j for j, pl in enumerate(head.placements) if pl.is_shard() and pl.dim % 2 == 1] \
        if is_dtensor(head) else []
    rows = _rows_layout(dmesh, x) if is_dtensor(x) else [Replicate()] * dmesh.ndim
    rows = [Replicate() if j in vocab else pl for j, pl in enumerate(rows)]
    w_pl = [Shard(1) if j in vocab else Replicate() for j in range(dmesh.ndim)]
    xl = _to_local(x, dmesh, rows, _summed(dmesh, rows, lambda j: j in vocab))
    wl = _to_local(head, dmesh, w_pl, _summed(dmesh, w_pl, lambda j: rows[j].is_shard()))
    out = fn(xl, wl, _chunk(dmesh, vocab) * wl.shape[1])
    return DTensor.from_local(out, dmesh, [Shard(x.ndim - 1) if j in vocab else pl
                                           for j, pl in enumerate(rows)], run_check=False)


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


def _to_local(a, dmesh, placements, grad=None):
    """``a`` laid out as ``placements`` on ``dmesh``, this rank's shard; its
    gradient comes back laid out as ``grad`` (default ``placements``)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(a):
        a = DTensor.from_local(a, dmesh, [Replicate()] * dmesh.ndim, run_check=False)
    local = a.redistribute(dmesh, placements).to_local(grad_placements=grad)
    return _ContiguousGrad.apply(local)


def _summed(dmesh, placements, over) -> list:
    """``placements`` with a pending sum (``Partial``) on each mesh dim of
    size > 1 for which ``over(j)`` holds: the gradient layout of an operand
    every rank of those dims holds whole while its partner is split."""
    from torch.distributed.tensor import Partial

    return [Partial() if dmesh.shape[j] > 1 and over(j) else pl
            for j, pl in enumerate(placements)]


def _model_dim(dmesh):
    """The index of the mesh's "model" dim, or None."""
    names = tuple(dmesh.mesh_dim_names)
    return names.index("model") if "model" in names else None


def _chunk(dmesh, dims) -> int:
    """This rank's chunk index of a dim split over the mesh dims ``dims``
    (row-major)."""
    chunk, coord = 0, dmesh.get_coordinate()
    for j in dims:
        chunk = chunk * dmesh.shape[j] + coord[j]
    return chunk


def heads_local(fn, args, head_dims, n_query: int = 1):
    """``fn(*args, 0)``, attention's core: the first ``n_query`` tensors of
    ``args`` are the query side (B, S, ...), the rest the key side (B, T,
    ...); each holds its heads at ``head_dims[i]`` (None: no head dim, as
    MLA's shared rope key); the output leads with the batch and holds its
    heads at ``head_dims[0]``. ``fn(*args, q0)`` attends the query
    positions from ``q0`` on. Plain tensors go straight in. With DTensors
    each rank runs ``fn`` on its batch rows (as the first argument shards
    them), splitting the model axis (n ranks) the first of three ways that
    applies:

      (a) over heads, where n divides every head count;
      (b) over query heads with the key head their group reads, where n
          divides the H query heads and the KV key heads divide n: a
          rank's H/n query heads fall in one group, so it slices that key
          head from the whole keys (local KV 1, local G = H/n);
      (c) over query positions, where n divides S > 1: each rank attends
          its S/n query rows (``q0`` its offset) against the whole keys,
          and the output is gathered over the model axis.

    Otherwise (decode's one position) every rank attends every head of its
    rows. Each rank's work is exactly rows or heads of the plain
    attention. A sequence-sharded key (the ``long_500k`` cache) needs a
    softmax across ranks: DTensor runs ``fn`` then."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args, 0)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if any(is_dtensor(a) and any(pl.is_shard() and pl.dim % a.ndim not in (0, hd)
                                 for pl in a.placements)
           for a, hd in zip(args, head_dims, strict=True) if hd is not None):
        return fn(*args, 0)
    ref = next(a for a in args if is_dtensor(a))
    dmesh = ref.device_mesh
    jm = _model_dim(dmesh)
    n = dmesh.shape[jm] if jm is not None else 1
    rows = _rows_layout(dmesh, args[0] if is_dtensor(args[0]) else ref)
    queries = [a.shape[hd] for a, hd in zip(args[:n_query], head_dims) if hd is not None]
    keys = [a.shape[hd] for a, hd in zip(args[n_query:], head_dims[n_query:]) if hd is not None]
    S = args[0].shape[1]
    if n == 1 or all(h % n == 0 for h in queries + keys):
        how = "heads"
    elif all(h % n == 0 for h in queries) and all(n % kv == 0 for kv in keys):
        how = "group"
    elif S > 1 and S % n == 0:
        how = "rows"
    else:
        how = "whole"

    def lay(i, hd):  # argument i's layout
        query = i < n_query
        if how == "heads" and hd is not None or how == "group" and query:
            split = Shard(hd)
        elif how == "rows" and query:
            split = Shard(1)
        else:
            split = Replicate()
        return [split if j == jm else pl for j, pl in enumerate(rows)]

    def grad(i, hd, pl):  # a whole key whose queries are split: its gradient is a sum
        return _summed(dmesh, pl, lambda j: j == jm and i >= n_query and how != "whole"
                       and pl[j] == Replicate())

    r = dmesh.get_coordinate()[jm] if jm is not None else 0
    local = []
    for i, (a, hd) in enumerate(zip(args, head_dims, strict=True)):
        pl = lay(i, hd)
        al = _to_local(a, dmesh, pl, grad(i, hd, pl))
        if how == "group" and i >= n_query and hd is not None:
            al = al.narrow(hd, r * a.shape[hd] // n, 1)  # the key head of this rank's group
        local.append(al)
    q0 = r * (S // n) if how == "rows" else 0
    out = DTensor.from_local(fn(*local, q0), dmesh, lay(0, head_dims[0]), run_check=False)
    return out.redistribute(dmesh, rows) if how == "rows" else out


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
    t_pl = [Shard(0) if j in vocab else Replicate() for j in range(dmesh.ndim)]
    tl = _to_local(table, dmesh, t_pl, _summed(dmesh, t_pl, lambda j: ids_pl[j].is_shard()))
    il = _to_local(ids, dmesh, ids_pl).to(torch.long)
    if not vocab:
        return DTensor.from_local(tl[il], dmesh, ids_pl, run_check=False)
    rows = tl.shape[0]
    local = il - _chunk(dmesh, vocab) * rows
    inside = ((local >= 0) & (local < rows)).to(tl.dtype)[..., None]
    out = tl[local.clamp(0, rows - 1)] * inside
    part = [Partial() if j in vocab else pl for j, pl in enumerate(ids_pl)]
    return DTensor.from_local(out, dmesh, part, run_check=False).redistribute(dmesh, ids_pl)


def vocab_parallel_ce(logits, targets, ce):
    """``ce(logits, targets)`` (the mean token cross-entropy) on DTensor
    logits (B, S, V): batch rows over the data axes, the vocab over the
    axes that shard it (:func:`vocab_logits` splits it over "model"). Each
    rank takes its rows' max, sum of exponentials and gold logit over its
    vocab shard; the vocab's axes reduce them (a max and two sums), the
    batch's average the loss. With the vocab whole on each rank, ``ce``
    runs on the rank's rows."""
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
        local = tl.to(torch.long) - _chunk(dmesh, vocab) * ll.shape[-1]
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
