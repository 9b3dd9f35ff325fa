"""Halo serving on one GPU — the port's counterpart of
``repro.launch.serve_sharded``.

The JAX package shards the ``PosteriorCache`` one partition per device
and resolves the 4-corner blend with a 1-hop ``ppermute`` halo exchange.
On one H100 every cell is local, so the same program becomes:

  HOST (``make_request_stages`` route; pure numpy, overlapped with the
  device evaluating the previous request in the pipelined loop):
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
"""
from __future__ import annotations

import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core import posterior, routing
from repro_torch.core.blend import corner_ids_weights
from repro_torch.core.partition import PartitionGrid
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
        # 1. every cell's model on its 9 stacked blocks, one slots launch
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
    """Split a request into the three stages the pipelined driver schedules
    (and the serial driver runs back-to-back):

      route(q)         HOST, pure numpy: bin the batch once, fit q_max
                       (streaming policy or the fixed value), build the
                       table reusing the binning, halo-stack the blocks.
                       Returns (table, blocks). No device copy here.
      submit(routed)   DEVICE: copy the blocks to ``device`` and enqueue
                       the halo program — returns without waiting.
      collect(pending) HOST: copy the results back (the only sync point)
                       and scatter them to request order.

    Exactly one of ``policy`` (live stream) / ``q_max`` (fixed) must be
    given. ``pad_multiple`` defaults to the policy's own alignment, or 8
    in the fixed lane. A :class:`routing.TwoLevelQMax` policy routes
    TWO-LEVEL; the device program is the same either way.
    """
    if (policy is None) == (q_max is None):
        raise ValueError("pass exactly one of policy= (streaming) or q_max= (fixed)")
    if pad_multiple is None:
        pad_multiple = policy.pad_multiple if policy is not None else 8
    stacker = routing.make_halo_stacker(grid)
    two_level = isinstance(policy, routing.TwoLevelQMax)

    def route(q):
        pts = np.asarray(q, np.float32)
        cells = routing.owning_cells(grid, pts)
        if two_level:
            own = cells[1] * grid.gx + cells[0]
            corners = corner_ids_weights(grid, pts)
            qm, hosts = policy.fit_spill(grid, own, corners[0])
            table = routing.build_routing_table(
                grid, pts, q_max=qm, cells=cells, corners=corners,
                spill=True, hosts=hosts, pad_multiple=pad_multiple,
            )
        elif policy is not None:
            counts = np.bincount(
                cells[1] * grid.gx + cells[0], minlength=grid.num_partitions
            )
            qm = policy.fit(counts)
            table = routing.build_routing_table(
                grid, pts, q_max=qm, cells=cells, pad_multiple=pad_multiple
            )
        else:
            table = routing.build_routing_table(
                grid, pts, q_max=q_max, cells=cells, pad_multiple=pad_multiple
            )
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


def cache_memory_bytes(cache: posterior.PosteriorCache) -> tuple[int, int]:
    """(total, per-device) bytes of the cache factor leaves — equal on one
    GPU, where every cell is resident."""
    total = sum(t.numel() * t.element_size() for t in posterior.cache_leaves(cache))
    return total, total
