"""Halo serving — the port's counterpart of ``repro.launch.serve_sharded``.

The JAX package shards the ``PosteriorCache`` one partition per device
and resolves the 4-corner blend with a 1-hop ``ppermute`` halo exchange.
The port has two lanes of that program, chosen by ``api.Server``'s
``group=`` argument:

THE ONE-PROCESS PROGRAM (no group; every cell is local to one device):

  HOST (the route stage; pure numpy, overlapped with the device
  evaluating the previous request in the pipelined loop):
  1. route the batch (``routing.build_routing_table`` under the streaming
     ``StreamingQMax`` or two-level ``TwoLevelQMax`` policy, or a fixed
     q_max) and stack every cell's 9-slot halo of query blocks
     (``routing.make_halo_stacker``);

  DEVICE (``make_halo_blend``; ``submit`` copies the blocks over first):
  2. ONE launch of the slots kernel over all (P, 9, q_max) rows —
     ``posterior.predict_cached_slots_stacked``;
  3. the reverse halo as a gather: res[p, k] = ev[halo_ids[p, k], 8 - k],
     zero where the neighbor is off-grid (the ``ppermute`` edge rule of
     ``_make_shift`` in the JAX package);
  4. the 4-corner blend (``routing.blend_slots``);

  HOST (``collect``, the only sync point):
  5. copy back and scatter to request order (``routing.scatter_results``).

THE MESH LANE (a ``torch.distributed`` group of gx * gy ranks, one cell
per rank — ``HaloMesh``; rank r owns cell (r mod gx, r div gx), the JAX
mesh's (data = iy, model = ix)). Every rank runs the same request stream
(SPMD): the routing is deterministic numpy, so every rank builds the same
table and the same q_max. Per request and rank:

  1. route as above, stacking only the rank's own 9-slot halo;
  2. ONE launch of the slots kernel at P = 1 on the rank's own cache
     leaves (``shard_cache``); the evaluations are copied to host memory;
  3. the composed reverse halo of the JAX program (``make_sharded_blend``):
     a slot flip, a row exchange (x-, x+), a column exchange (y-, y+) —
     4 shifts, each one ``batch_isend_irecv`` with the rank's neighbors
     over gloo, zeros where the neighbor is off-grid. The hop is
     ``psvgp_spmd.make_shift``, the one the SPMD training step makes once
     a step, so serving and training share one exchange;
  4. the 4-corner blend of the rank's own rows on its device;
  5. an all-gather of every rank's rows (gloo, host memory) and the
     scatter to request order: every rank returns the whole answer.

The payloads travel through host memory explicitly: gloo moves CPU
tensors, and NCCL needs one GPU a rank.

The CLI at the bottom is a thin shim over ``repro_torch.api`` (``--device
cpu`` runs the plain PyTorch lanes; ``cuda`` when absent):

  PYTHONPATH=src python -m repro_torch.launch.serve_sharded --gp-grid 4 --gp-m 5

and on the mesh lane, one rank per cell:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 16 -m repro_torch.launch.serve_sharded --gp-grid 4 --gp-m 5
"""
from __future__ import annotations

import argparse
import os
import time
from collections.abc import Callable, Sequence
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core import posterior, routing
from repro_torch.core.blend import corner_ids_weights, predict_blended
from repro_torch.core.partition import PartitionGrid
from repro_torch.core.psvgp_spmd import grid_matches_mesh, make_shift
from repro_torch.kernels import ops as kops


def make_halo_blend(
    grid: PartitionGrid,
    cov_fn: Callable,
    backend: str,
    device: torch.device,
) -> Callable:
    """Build the one-GPU halo serving program.

      blend_fn(cache, hx, corner_slot, corner_w) -> (mean, var)

    with cache a P-stacked ``PosteriorCache`` on ``device``, hx
    (P, 9, q_max, 2) the host-stacked halo query blocks (hx[p, k] = cell
    p+OFFSETS[k]'s block, zeros off-grid), corner_slot (P, q_max, 4)
    int64, corner_w (P, q_max, 4), all on ``device``; outputs (P, q_max)
    each — padded rows carry weight-0 blends and are dropped by
    ``routing.scatter_results``. Math identical to
    ``routing.predict_routed``. ``backend`` is the kernel lane ("ref" |
    "pallas" | "fused"); the kernel lanes are RBF-only, checked here.
    """
    if grid.wrap_x:
        raise NotImplementedError("wrapped grids need a ring halo")
    backend = posterior.resolve_slot_backend(False, backend)
    if backend != "ref":
        kops.require_rbf(cov_fn)
    hids = torch.as_tensor(routing.halo_ids(grid), dtype=torch.long, device=device)
    on_grid = torch.as_tensor(routing.halo_slot_on_grid(grid) > 0, device=device)[..., None]
    rev = torch.arange(routing.NUM_HALO_SLOTS - 1, -1, -1, device=device)  # slot 8 - k

    def blend_fn(cache, hx, corner_slot, corner_w):
        # 1. every cell's model on its 9 stacked blocks, one kernel launch
        ev_mean, ev_var = posterior.predict_cached_slots_stacked(
            cache, cov_fn, hx, backend=backend
        )
        # 2. reverse halo: the model at offset k from p evaluated p's
        # queries in ITS slot 8-k; off-grid slots are zeros
        res_mean = torch.where(on_grid, ev_mean[hids, rev], 0.0)
        res_var = torch.where(on_grid, ev_var[hids, rev], 0.0)
        # 3. 4-corner bilinear blend per row
        return routing.blend_slots(res_mean, res_var, corner_slot, corner_w)

    return blend_fn


def make_router(
    grid: PartitionGrid,
    *,
    policy: routing.StreamingQMax | None = None,
    q_max: int | None = None,
    pad_multiple: int | None = None,
) -> Callable[[np.ndarray], routing.RoutingTable]:
    """The host half of a request, pure numpy: bin the batch once, fit
    q_max (streaming policy or the fixed value), build the table reusing
    the binning. Exactly one of ``policy`` (live stream) / ``q_max``
    (fixed) must be given. ``pad_multiple`` defaults to the policy's own
    alignment, or 8 in the fixed lane. A :class:`routing.TwoLevelQMax`
    policy routes TWO-LEVEL. Deterministic: the same batches give the same
    tables and q_max trajectory, which the mesh lane's ranks rely on."""
    if (policy is None) == (q_max is None):
        raise ValueError("pass exactly one of policy= (streaming) or q_max= (fixed)")
    if pad_multiple is None:
        pad_multiple = policy.pad_multiple if policy is not None else 8
    two_level = isinstance(policy, routing.TwoLevelQMax)

    def route_table(q) -> routing.RoutingTable:
        pts = np.asarray(q, np.float32)
        cells = routing.owning_cells(grid, pts)
        if two_level:
            own = cells[1] * grid.gx + cells[0]
            corners = corner_ids_weights(grid, pts)
            qm, hosts = policy.fit_spill(grid, own, corners[0])
            return routing.build_routing_table(
                grid, pts, q_max=qm, cells=cells, corners=corners,
                spill=True, hosts=hosts, pad_multiple=pad_multiple,
            )
        if policy is not None:
            counts = np.bincount(
                cells[1] * grid.gx + cells[0], minlength=grid.num_partitions
            )
            qm = policy.fit(counts)
            return routing.build_routing_table(
                grid, pts, q_max=qm, cells=cells, pad_multiple=pad_multiple
            )
        return routing.build_routing_table(
            grid, pts, q_max=q_max, cells=cells, pad_multiple=pad_multiple
        )

    return route_table


@contract(
    route={
        "xq": "(P, Q, D)",
        "stacked": "(P, 9, Q, D)",
        "corner_slot": "(P, Q, 4)",
        "corner_w": "(P, Q, 4)",
    },
    invariants=("q_max-matches-policy", "q_max-aligned"),
)
def make_request_stages(
    grid: PartitionGrid,
    blend_fn: Callable,
    cache: posterior.PosteriorCache,
    *,
    device: torch.device,
    policy: routing.StreamingQMax | None = None,
    q_max: int | None = None,
    pad_multiple: int | None = None,
):
    """Split a request of the one-process program into the three stages
    the pipelined driver schedules (and the serial driver runs
    back-to-back):

      route(q)         HOST, pure numpy (:func:`make_router`), then the
                       halo stack of every cell's blocks. Returns
                       (table, blocks). No device copy here.
      submit(routed)   DEVICE: copy the blocks to ``device`` and enqueue
                       the halo program — returns without waiting.
      collect(pending) HOST: copy the results back (the only sync point)
                       and scatter them to request order.
    """
    route_table = make_router(grid, policy=policy, q_max=q_max, pad_multiple=pad_multiple)
    stacker = routing.make_halo_stacker(grid)

    def route(q):
        table = route_table(q)
        blocks = (stacker(table.xq), table.corner_slot.astype(np.int64), table.corner_w)
        return table, blocks

    def submit(routed):
        table, blocks = routed
        hx, cs, cw = (torch.from_numpy(b).to(device) for b in blocks)
        mean, var = blend_fn(cache, hx, cs, cw)  # enqueued; no sync
        return table, mean, var

    def collect(pending):
        table, mean, var = pending
        return (
            routing.scatter_results(table, mean.cpu().numpy()),
            routing.scatter_results(table, var.cpu().numpy()),
        )

    return route, submit, collect


# --------------------------------------------------------------------------
# The mesh lane: one cell per rank of a torch.distributed process group
# --------------------------------------------------------------------------


class HaloMesh:
    """The port's device mesh: a ``torch.distributed`` process group of
    gx * gy ranks, one grid cell per rank. Rank r owns cell (ix, iy) =
    (r mod gx, r div gx) — JAX's mesh axes (data = iy, model = ix), so
    ``shape`` and ``axis_names`` read as a JAX mesh's do
    (``psvgp_spmd.grid_matches_mesh``).

    Counters of the exchange (``stats``), serving and training alike:
    ``shifts`` (one ``batch_isend_irecv`` each), ``gathers`` (the serving
    lane's all-gathers of result rows, one a request), the seconds spent
    in the shifts (``exchange_s``), in the all-gathers (``gather_s``) and
    waiting for the rank's own evaluation to reach host memory
    (``wait_s``). A collective's seconds include the wait for the slowest
    peer.

    ``shift(a, dx, dy)`` is the mesh's one hop primitive
    (``psvgp_spmd.make_shift``), built at first use.
    """

    axis_names = ("data", "model")

    def __init__(self, group, gx: int, gy: int):
        import torch.distributed as dist

        size = dist.get_world_size(group)
        if size != gx * gy:
            raise ValueError(
                f"the mesh lane needs one rank per partition: the grid is "
                f"{gx}x{gy} = {gx * gy} partitions, the process group has "
                f"{size} ranks (launch {gx * gy} ranks, e.g. torchrun "
                f"--nproc-per-node {gx * gy}, or serve without a group)"
            )
        self.group = group
        self.gx, self.gy = gx, gy
        self.size = size
        self.rank = dist.get_rank(group)
        self.shape = {"data": gy, "model": gx}
        self.cell = (self.rank % gx, self.rank // gx)
        self.shifts = 0
        self.gathers = 0
        self.exchange_s = 0.0
        self.gather_s = 0.0
        self.wait_s = 0.0
        self._shift = None

    def peer(self, ix: int, iy: int) -> int:
        """The global rank that owns cell (ix, iy)."""
        import torch.distributed as dist

        return dist.get_global_rank(self.group, iy * self.gx + ix)

    def shift(self, a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
        """Every rank receives the payload of the rank at grid offset
        (dx, dy), zeros off-grid; every rank must call it."""
        if self._shift is None:
            self._shift = make_shift(self)
        return self._shift(a, dx, dy)

    def stats(self) -> dict:
        return {"ranks": self.size, "rank": self.rank, "shifts": self.shifts,
                "gathers": self.gathers, "exchange_s": self.exchange_s,
                "gather_s": self.gather_s, "wait_s": self.wait_s}

    def reset_stats(self) -> None:
        self.shifts, self.gathers = 0, 0
        self.exchange_s, self.gather_s, self.wait_s = 0.0, 0.0, 0.0


def mesh_for_grid(grid: PartitionGrid, group) -> HaloMesh:
    """The (gy, gx) mesh of ``group`` matching the partition grid, axes
    (data, model); raises, naming both numbers, when the group's world
    size is not gx * gy."""
    return HaloMesh(group, grid.gx, grid.gy)


def shard_cache(cache: posterior.PosteriorCache, mesh: HaloMesh) -> posterior.PosteriorCache:
    """This rank's cell of the P-stacked cache: every leaf's row
    ``mesh.rank``, leading axis 1, copied so that it holds no view of the
    other cells' factors."""
    p = mesh.rank
    return posterior.map_cache(lambda a: a[p:p + 1].clone(), cache)


def make_halo_gather(mesh: HaloMesh, axes: Sequence[str], grid: PartitionGrid) -> Callable:
    """(1, ...) -> (1, 9, ...) halo gather on host tensors: output slot k on
    rank p is rank p+OFFSETS[k]'s block (zeros off-grid). The standalone
    probe of the ``shift`` semantics the serving program's reverse halo
    composes — tests hold it to ``routing.halo_ids``. Every rank must
    call it."""
    if not grid_matches_mesh(grid, mesh, axes):
        raise ValueError(f"grid {grid.gx}x{grid.gy} must match mesh axes {tuple(axes)}")
    shift = mesh.shift

    def gather(x: torch.Tensor) -> torch.Tensor:
        x = x[0]
        out = [
            x if k == routing.SELF_SLOT else shift(x, dx, dy)
            for k, (dx, dy) in enumerate(routing.OFFSETS)
        ]
        return torch.stack(out)[None]

    return gather


class MeshProgram(NamedTuple):
    """The mesh lane's per-rank serving program, in the two halves the
    pipelined loop schedules around the host's routing of the next batch:

      evaluate(cache, hx) -> ev    DEVICE: the rank's model on its 9
          stacked blocks, hx (1, 9, q, d) -> ev (9, 2, q) (mean, var per
          slot): one launch of the slots kernel at P = 1 on the kernel
          lanes. Enqueued, no sync.
      resolve(ev, corner_slot, corner_w) -> (mean, var)   the composed
          reverse halo over host memory (ev a host tensor; 4 shifts),
          then the 4-corner blend on the device of ``corner_slot``
          (1, q, 4) and ``corner_w`` (1, q, 4): (1, q) each.
    """

    evaluate: Callable
    resolve: Callable


@contract(
    args={
        "hx": "(P, 9, Q, 2)",
        "corner_slot": "(P, Q, 4)",
        "corner_w": "(P, Q, 4)",
    },
    returns=("(P, Q)", "(P, Q)"),
    invariants=("outputs-f32",),
)
def make_sharded_blend(
    mesh: HaloMesh,
    axes: Sequence[str],
    grid: PartitionGrid,
    cov_fn: Callable,
    *,
    backend: str,
) -> MeshProgram:
    """Build one rank's halo serving program (:class:`MeshProgram`). Math
    identical to ``routing.predict_routed`` and to :func:`make_halo_blend`:
    the same rows through the same kernel and the same blend, so the two
    lanes agree bitwise.

    The reverse halo is the JAX program's composition: slot k's evaluation
    must travel to the owner at offset OFFSETS[k], and because a diagonal
    hop is an x-hop then a y-hop, the whole 3x3 neighborhood moves in 4
    shifts — one row exchange (x-, x+) of the slot-flipped results, one
    column exchange (y-, y+) of the row-exchanged triples. The JAX
    program's ``cache_in_specs`` has no counterpart: a rank holds its own
    cell's leaves (``shard_cache``) and no shard_map spec tree exists.
    """
    if not grid_matches_mesh(grid, mesh, axes):
        raise ValueError(
            f"grid {grid.gx}x{grid.gy} must match mesh axes {tuple(axes)} "
            f"{[mesh.shape[a] for a in axes]} (one partition per rank)"
        )
    if grid.wrap_x:
        raise NotImplementedError("wrapped grids need ring perms for the halo")
    backend = posterior.resolve_slot_backend(False, backend)
    if backend != "ref":
        kops.require_rbf(cov_fn)
    shift = mesh.shift
    S = routing.NUM_HALO_SLOTS

    def evaluate(cache, hx):
        mean, var = posterior.predict_cached_slots_stacked(cache, cov_fn, hx, backend=backend)
        return torch.stack([mean[0], var[0]], dim=1)  # (9, 2, q): one halo payload

    def resolve(ev, corner_slot, corner_w):
        q = ev.shape[-1]
        # the owner at offset OFFSETS[k] needs MY evaluation of its queries,
        # which sits in my slot 8-k; flipping the slot axis puts "what must
        # travel along offset (dx, dy)" at halo position (dy+1, dx+1)
        f = ev.flip(0).reshape(3, 3, 2, q)
        # row exchange: every column of the flipped stack moves its x-hop
        g = torch.stack([shift(f[:, 0], -1, 0), f[:, 1], shift(f[:, 2], 1, 0)], dim=1)
        # column exchange: row-exchanged triples move their y-hop
        res = torch.stack([shift(g[0], 0, -1), g[1], shift(g[2], 0, 1)]).reshape(S, 2, q)
        res = res.to(corner_slot.device)  # res[k]: the model at offset k on MY queries
        return routing.blend_slots(res[None, :, 0], res[None, :, 1], corner_slot, corner_w)

    return MeshProgram(evaluate, resolve)


def make_replicated_stages(
    cache: posterior.PosteriorCache, cov_fn: Callable, grid: PartitionGrid
):
    """The replicated lane's (route, submit, collect): route is the host's
    float32 copy of the batch, submit enqueues the 4-corner blend of every
    query (``blend.predict_blended`` over the whole cache, on its device),
    collect copies both results back."""

    def route(q):
        return np.asarray(q, np.float32)

    def submit(pts):
        return predict_blended(cache, cov_fn, grid, pts)

    def collect(pending):
        return pending[0].cpu().numpy(), pending[1].cpu().numpy()

    return route, submit, collect


def make_mesh_request_stages(
    grid: PartitionGrid,
    program: MeshProgram,
    cache: posterior.PosteriorCache,
    mesh: HaloMesh,
    *,
    device: torch.device,
    policy: routing.StreamingQMax | None = None,
    q_max: int | None = None,
    pad_multiple: int | None = None,
):
    """The mesh lane's (route, submit, collect) on one rank; every rank
    must call them with the same batches in the same order.

      route(q)         HOST: the full routing table (:func:`make_router`),
                       then this rank's own 9-slot halo stack and corner
                       rows. Returns (table, blocks).
      submit(routed)   DEVICE: copy the blocks over, launch the evaluation,
                       enqueue its copy to pinned host memory — no sync.
      collect(pending) wait for that copy, the reverse halo and the blend
                       (``MeshProgram.resolve``), all-gather every rank's
                       rows and scatter them to request order: the whole
                       answer on every rank.

    ``cache`` is this rank's :func:`shard_cache`.
    """
    import torch.distributed as dist

    route_table = make_router(grid, policy=policy, q_max=q_max, pad_multiple=pad_multiple)
    p = mesh.rank
    hids = routing.halo_ids(grid)[p]
    on = routing.halo_slot_on_grid(grid)[p]
    pinned = device.type == "cuda"

    def route(q):
        table = route_table(q)
        xq = table.xq
        hx = xq[hids] * on[:, None, None].astype(xq.dtype)  # make_halo_stacker's row p
        return table, (hx[None], table.corner_slot[p:p + 1].astype(np.int64),
                       table.corner_w[p:p + 1])

    def submit(routed):
        table, blocks = routed
        hx, cs, cw = (torch.from_numpy(b).to(device) for b in blocks)
        ev = program.evaluate(cache, hx)
        done = None
        if pinned:
            host = torch.empty(ev.shape, dtype=ev.dtype, pin_memory=True)
            host.copy_(ev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            ev = host
        return table, ev, done, cs, cw

    def collect(pending):
        table, ev, done, cs, cw = pending
        if done is not None:
            t0 = time.perf_counter()
            done.synchronize()
            mesh.wait_s += time.perf_counter() - t0
        mean, var = program.resolve(ev, cs, cw)
        local = torch.stack([mean[0], var[0]]).cpu()  # (2, q)
        parts = [torch.empty_like(local) for _ in range(mesh.size)]
        t0 = time.perf_counter()
        dist.all_gather(parts, local, group=mesh.group)
        mesh.gather_s += time.perf_counter() - t0
        mesh.gathers += 1
        rows = torch.stack(parts).numpy()  # (P, 2, q) in rank = cell order
        return (
            routing.scatter_results(table, rows[:, 0]),
            routing.scatter_results(table, rows[:, 1]),
        )

    return route, submit, collect


def as_batch_source(batches):
    """Normalize a batch SOURCE into an iterator of query batches: a
    sequence (replayed as-is), an iterator (consumed once) or a zero-arg
    callable (polled per batch; returning None ends the stream)."""
    if callable(batches):
        def pull():
            while (b := batches()) is not None:
                yield b

        return pull()
    return iter(batches)


def _percentiles(lat: list) -> dict:
    ms = np.sort(np.asarray(lat)) * 1e3
    return {
        "p50_ms": float(np.percentile(ms, 50)),
        "p95_ms": float(np.percentile(ms, 95)),
        "p99_ms": float(np.percentile(ms, 99)),
    }


def pipelined_request_loop(
    route: Callable,
    submit: Callable,
    collect: Callable,
    batches,
    *,
    warm: bool = True,
    on_result: Callable | None = None,
) -> tuple[dict, float]:
    """The overlapped serving loop (double-buffered): batch t is submitted
    to the device, then batch t+1 is ROUTED ON THE HOST while the device
    runs — ``submit`` only enqueues, the block happens in ``collect``.
    Results are bitwise identical to the serial loop.

    Per-request latency is the completion-to-completion service interval.
    ``warm=True`` runs the first batch once before timing and then serves
    it again as batch 0. ``on_result(i, (mean, var))`` receives each
    result. Returns ({p50_ms, p95_ms, p99_ms}, points_per_s).
    """
    src = as_batch_source(batches)
    try:
        first = next(src)
    except StopIteration:
        raise ValueError("pipelined_request_loop needs a non-empty batch source") from None
    if warm:
        collect(submit(route(first)))
    lat = []
    points = 0
    t_all = time.perf_counter()
    nxt, nxt_points = route(first), len(first)
    mark = time.perf_counter()  # pipeline idle: batch 0's service starts here
    i = 0
    while nxt is not None:
        pending = submit(nxt)  # copy + enqueue: the device starts batch i
        points += nxt_points
        b = next(src, None)
        if b is not None:
            nxt, nxt_points = route(b), len(b)  # host routes i+1 under batch i
        else:
            nxt = None
        out = collect(pending)  # sync point: batch i consumed
        if on_result is not None:
            on_result(i, out)
        now = time.perf_counter()
        lat.append(now - mark)
        mark = now
        i += 1
    wall = time.perf_counter() - t_all
    return _percentiles(lat), points / wall


def timed_request_loop(answer: Callable, batches, *, warm: bool = True) -> tuple[dict, float]:
    """The SERIAL serving loop: warm up on batches[0], then time each
    request end to end (``answer`` must return host results, so the time
    includes the device). Returns ({p50_ms, p95_ms, p99_ms}, points_per_s).
    """
    if warm:
        answer(batches[0])
    lat = []
    t_all = time.perf_counter()
    for q in batches:
        t0 = time.perf_counter()
        answer(q)
        lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    return _percentiles(lat), sum(len(q) for q in batches) / wall


def cache_memory_bytes(
    cache: posterior.PosteriorCache, shard: posterior.PosteriorCache | None = None
) -> tuple[int, int]:
    """(total, per-device) bytes of the cache factor leaves. On one GPU
    every cell is resident and the two are equal; on the mesh lane
    ``shard`` is the rank's own cell (``shard_cache``), total / P."""

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in posterior.cache_leaves(c))

    total = nbytes(cache)
    return total, total if shard is None else nbytes(shard)


# --------------------------------------------------------------------------
# The serving CLI (``python -m repro_torch.launch.serve_sharded``; shared
# with ``repro_torch.launch.serve`` and ``repro_torch.net.server``)
# --------------------------------------------------------------------------


def train_demo_surface(
    *, seed: int, n: int, grid_side: int, m: int, train_iters: int,
    fit_cfg=None, device=None,
):
    """The ONE training recipe the serving drivers demo against (``serve
    --gp``, ``serve --gp --sharded``, this CLI): a PSVGP with the
    ``FitConfig`` defaults (delta 0.25) on the synthetic E3SM-like field,
    trained through ``repro_torch.api.fit`` on ``device`` (``"cuda"`` when
    None). Returns (ds, fitted). An explicit ``fit_cfg`` (the ``--config
    session.json`` lane) replaces the flag-derived FitConfig wholesale; the
    dataset size ``n`` stays a CLI concern either way."""
    from repro_torch import api
    from repro_torch.data.spatial import e3sm_like_field

    if fit_cfg is None:
        fit_cfg = api.FitConfig(grid=grid_side, m=m, train_iters=train_iters, seed=seed)
    ds = e3sm_like_field(n=n, seed=fit_cfg.seed)
    fitted = api.fit(fit_cfg, ds, device=device, verbose=True)
    return ds, fitted


def load_or_train(args, *, fit_cfg=None):
    """The fit-or-load front of the GP serving CLIs: returns (ds, fitted),
    ds None when serving a persisted artifact (``--gp-artifact``; no
    retraining on that path), else :func:`train_demo_surface` on
    ``--gp-n`` points. ``--gp-save`` persists a freshly trained artifact;
    ``fit_cfg`` (a session file's fit section) replaces the flag-derived
    training config. Runs on ``--device`` (``"cuda"`` when absent: a
    machine without a GPU raises)."""
    from repro_torch import api

    device = getattr(args, "device", None)
    if getattr(args, "gp_artifact", None):
        fitted = api.FittedPSVGP.load(args.gp_artifact, device=device)
        print(f"loaded artifact {args.gp_artifact}: grid="
              f"{fitted.grid.gx}x{fitted.grid.gy}, m={fitted.config.m} on "
              f"{fitted.device} (serving without retraining)")
        ds = None
    else:
        ds, fitted = train_demo_surface(
            seed=args.seed, n=args.gp_n, grid_side=args.gp_grid, m=args.gp_m,
            train_iters=args.gp_train_iters, fit_cfg=fit_cfg, device=device,
        )
    if getattr(args, "gp_save", None):
        fitted.save(args.gp_save)
        print(f"artifact saved to {args.gp_save}")
    return ds, fitted


def query_batches(
    grid: PartitionGrid, ds=None, *, batch: int, requests: int,
    seed: int = 0, skew: float = 0.0,
) -> list:
    """The demo query stream the GP serving CLIs draw: zipf-skewed over
    cells when ``skew`` > 0 (the ``--gp-skew`` exponent), else uniform
    over the data domain (``ds``) or the grid bounds (``ds=None`` — the
    artifact-serving case). The JAX package's stream bitwise for the same
    seed, skew and grid."""
    if skew > 0:
        from repro_torch.data.spatial import zipf_query_stream

        return zipf_query_stream(grid, batch, requests, alpha=skew, seed=seed + 1)
    rng = np.random.default_rng(seed + 1)
    if ds is not None:
        lo, hi = ds.x.min(axis=0), ds.x.max(axis=0)
    else:
        lo = np.array([grid.x_edges[0], grid.y_edges[0]], np.float32)
        hi = np.array([grid.x_edges[-1], grid.y_edges[-1]], np.float32)
    return [
        rng.uniform(lo, hi, (batch, 2)).astype(np.float32)
        for _ in range(requests)
    ]


def prepass_routing(
    grid: PartitionGrid, batches, *, headroom: float = 1.25, pad_multiple: int = 8
) -> tuple[int, list]:
    """Whole-stream q_max prepass, for streams known up front: one q_max
    covering every batch, the observed max bucket count with headroom,
    rounded with the alignment rule ``routing.build_routing_table``
    applies (pass the same ``pad_multiple`` to both). Returns (q_max,
    cells) with ``cells[i]`` = ``owning_cells`` of ``batches[i]``, for
    ``build_routing_table(..., cells=...)``. Live streams use
    ``routing.StreamingQMax`` instead."""
    need, cells = 1, []
    for q in batches:
        ix, iy = routing.owning_cells(grid, np.asarray(q, np.float32))
        cells.append((ix, iy))
        c = np.bincount(iy * grid.gx + ix, minlength=grid.num_partitions)
        need = max(need, int(c.max()))
    return routing.ceil_to(int(np.ceil(need * headroom)), pad_multiple), cells


def fixed_q_max(
    grid: PartitionGrid, batches, *, headroom: float = 1.25, pad_multiple: int = 8
) -> int:
    """``prepass_routing`` when only the q_max is wanted."""
    return prepass_routing(grid, batches, headroom=headroom, pad_multiple=pad_multiple)[0]


def launched_as_rank() -> bool:
    """True under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def mesh_group_from_env():
    """The gloo process group ``torchrun`` describes (with ``MASTER_ADDR``/
    ``MASTER_PORT``), or None when this process was not launched as one of
    several ranks."""
    if not launched_as_rank():
        return None
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="env://")
    return dist.group.WORLD


def serve_sharded(args) -> dict:
    """Fit (or load) through ``repro_torch.api`` and serve the routed query
    loop in sharded mode — a thin shim: flags parse into a ``ServeConfig``
    and ``api.Server`` does the wiring.

    Launched under ``torchrun --nproc-per-node gx*gy`` it serves on the
    MESH lane (one cell per rank, gloo; every rank serves the same stream
    and rank 0 prints); otherwise on the one-process halo program. It
    prints which lane it used. Prints and returns the latency/throughput
    record, with the first batch checked against the replicated path
    (``ref.tolerance_ratio`` of the blend's summed terms, <= 1 agrees).
    """
    fit_cfg, serve_cfg, _ = session_configs(args, expect_mode="sharded")
    group = mesh_group_from_env()
    try:
        return _serve_sharded(args, fit_cfg, serve_cfg, group)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve_sharded(args, fit_cfg, serve_cfg, group) -> dict:
    from repro_torch import api
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.kernels import ref

    say = print
    if group is not None:
        import torch.distributed as dist

        if dist.get_rank(group) != 0:
            say = _quiet
        if getattr(args, "device", None) in (None, "cuda") and torch.cuda.device_count() > 1:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    ds, fitted = load_or_train(args, fit_cfg=fit_cfg)
    grid = fitted.grid
    if serve_cfg is None:
        serve_cfg = api.ServeConfig(
            mode="sharded",
            pipeline="serial" if getattr(args, "gp_serial", False) else "pipelined",
            router=getattr(args, "gp_router", "single"),
            backend="auto",
        )
    server = api.Server(fitted, serve_cfg, group=group)
    total_b, device_b = server.cache_bytes
    if server.mesh is not None:
        lane = f"mesh over {server.mesh.size} ranks (gloo)"
        say(f"lane: {lane}, one cell per rank on {server.device}; cache "
            f"{total_b / 1e6:.4f} MB total, {device_b / 1e3:.3f} kB/rank "
            f"(1/{total_b // max(device_b, 1)} of replicated)")
    else:
        lane = "one-process halo program"
        say(f"lane: {lane}, all {grid.num_partitions} cells on {server.device}; "
            f"cache {total_b / 1e6:.4f} MB")

    skew = getattr(args, "gp_skew", 0.0)
    batches = query_batches(
        grid, ds, batch=args.gp_batch, requests=args.gp_requests,
        seed=args.seed, skew=skew,
    )

    # warmup + equivalence check against the replicated path
    m0, v0 = server.submit(batches[0])
    m_rep, v_rep = (a.cpu() for a in fitted.predict(batches[0]))
    mean_err = float(np.abs(m0 - m_rep.numpy()).max())
    var_err = float(np.abs(v0 - v_rep.numpy()).max())
    mean_s, var_s = (a.cpu() for a in blend_error_scales(fitted.cache, grid, batches[0]))
    ratio = (ref.tolerance_ratio(torch.as_tensor(m0), m_rep, mean_s),
             ref.tolerance_ratio(torch.as_tensor(v0), v_rep, var_s))
    say(f"sharded vs replicated on warmup batch: max|dmean|={mean_err:.2e} "
        f"max|dvar|={var_err:.2e} (tolerance ratio mean {ratio[0]:.4f} "
        f"var {ratio[1]:.4f}; <= 1 agrees)")

    # already warmed: the equivalence check above ran batch 0
    report = server.stream(batches, warm=False)
    pct, qps = report["latency_ms"], report["points_per_s"]
    policy = server.policy
    rec = {
        "lane": lane,
        "mesh": f"{grid.gy}x{grid.gx}",
        "ranks": server.mesh.size if server.mesh is not None else 1,
        "device": str(server.device),
        "mode": serve_cfg.pipeline,
        "router": serve_cfg.router,
        "backend": server.backend,
        "serve_config": serve_cfg.to_dict(),
        "skew_alpha": skew,
        "qmax_policy": report["qmax_policy"],
        "latency_ms": pct,
        "points_per_s": qps,
        "mean_err_vs_replicated": mean_err,
        "var_err_vs_replicated": var_err,
        "tolerance_ratio_vs_replicated": list(ratio),
        "cache_bytes_total": total_b,
        "cache_bytes_per_device": device_b,
    }
    if policy is not None:
        say(f"served {args.gp_requests} requests x {args.gp_batch} points "
            f"({rec['mode']}; q_max={policy.q_max}, "
            f"{policy.compiles} compiles, {policy.overflows} overflows)")
    else:
        say(f"served {args.gp_requests} requests x {args.gp_batch} points "
            f"({rec['mode']}; fixed q_max={serve_cfg.q_max})")
    if server.mesh is not None:
        st = server.mesh.stats()
        say(f"rank 0 exchange: {st['shifts']} shifts, {st['exchange_s'] * 1e3:.3f} ms in "
            f"shifts, {st['gather_s'] * 1e3:.3f} ms in all-gathers")
    say(f"latency/request ms: p50={pct['p50_ms']:.2f} "
        f"p95={pct['p95_ms']:.2f} p99={pct['p99_ms']:.2f}")
    say(f"throughput: {qps:,.0f} points/s")
    return rec


def _quiet(*_args, **_kwargs) -> None:
    """The print of a rank other than 0."""


def session_configs(args, *, expect_mode: str):
    """The ``--config session.json`` lane: returns (fit_cfg, serve_cfg,
    net_cfg) — (None, None, None) without the flag. A serve section whose
    mode contradicts the running entry point is an error, and so is
    ``--http`` against a session file with no ``net`` section: a recorded
    session must say where it binds."""
    if not getattr(args, "config", None):
        return None, None, None
    from repro_torch.api.config import load_session

    fit_cfg, serve_cfg, net_cfg = load_session(args.config)
    if serve_cfg is not None and serve_cfg.mode != expect_mode:
        raise SystemExit(
            f"--config {args.config}: serve section has mode="
            f"{serve_cfg.mode!r} but this entry point serves "
            f"{expect_mode!r} (pick the matching CLI or fix the session)"
        )
    if getattr(args, "http", False) and net_cfg is None:
        raise SystemExit(
            f"--http with --config {args.config}: the session file has no "
            "'net' section (host/port/max_body_bytes/read_timeout_s/"
            "keepalive — api.NetConfig); add one."
        )
    return fit_cfg, serve_cfg, net_cfg


HTTP_UNDER_TORCHRUN = ("--http serves from one process (the one-process halo "
                       "program); launch it without torchrun")


def add_gp_args(ap: argparse.ArgumentParser) -> None:
    """The --gp-* serving flags of the JAX package's CLIs, shared with
    ``repro_torch.launch.serve`` and ``repro_torch.net.server`` (which
    define --seed themselves), plus ``--device``."""
    ap.add_argument("--gp-n", type=int, default=20_000, help="training observations")
    ap.add_argument("--gp-grid", type=int, default=8, help="partition grid is gp-grid^2")
    ap.add_argument("--gp-m", type=int, default=10, help="inducing points per partition")
    ap.add_argument("--gp-train-iters", type=int, default=200)
    ap.add_argument("--gp-batch", type=int, default=2048, help="query points per request")
    ap.add_argument("--gp-requests", type=int, default=50)
    ap.add_argument("--gp-serial", action="store_true",
                    help="sharded mode: run the synchronous request loop "
                         "instead of the overlapped (double-buffered) pipeline")
    ap.add_argument("--gp-skew", type=float, default=0.0, metavar="ALPHA",
                    help="query stream skew: zipf exponent over cells "
                         "(0 = uniform over the domain, the default)")
    ap.add_argument("--gp-router", choices=("single", "two-level"),
                    default="single",
                    help="q_max routing policy: 'single' pads every cell's "
                         "block to the hottest cell; 'two-level' spills "
                         "hot-cell overflow onto corner-cell neighbors "
                         "(routing.TwoLevelQMax)")
    ap.add_argument("--gp-save", metavar="DIR", default=None,
                    help="persist the trained artifact (FitConfig + grid + "
                         "params + cached factors) to DIR after training")
    ap.add_argument("--gp-artifact", metavar="DIR", default=None,
                    help="serve from a persisted artifact (either package's; "
                         "a format-2 store serves its latest step) instead "
                         "of training")
    ap.add_argument("--config", metavar="SESSION_JSON", default=None,
                    help="session file with optional 'fit', 'serve' and "
                         "'net' sections (api.load_session). The fit section "
                         "replaces the training flags; the serve section "
                         "replaces --gp-serial/--gp-router (its mode must "
                         "match the entry point); the net section is "
                         "required with --http")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP (repro_torch.net.server: POST "
                         "/predict, GET /healthz, GET /slo) instead of "
                         "running the in-process demo query stream")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to fit and serve; cuda when absent (raises "
                         "on a machine without a GPU)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    add_gp_args(ap)
    args = ap.parse_args()
    if args.gp_requests < 1 or args.gp_batch < 1:
        ap.error("--gp-requests and --gp-batch must be >= 1")
    if args.http:
        if launched_as_rank():
            ap.error(HTTP_UNDER_TORCHRUN)
        from repro_torch.net.server import serve_http

        serve_http(args, expect_mode="sharded")
        return
    serve_sharded(args)


if __name__ == "__main__":
    main()
