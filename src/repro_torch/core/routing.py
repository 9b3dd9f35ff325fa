"""Query routing for PSVGP serving on one GPU (the halo path).

Port of ``repro.core.routing``. The HOST-SIDE half — the router that
buckets a raw query batch into per-partition padded/masked blocks whose
corner models are encoded as 3x3-halo SLOTS relative to the hosting
cell, the single- and two-level q_max policies, the halo stacker, the
request coalescer and the scatter back to request order — is a verbatim
numpy copy of the JAX package's (lines 60-659 there): the port imports
nothing of ``repro``, and the routing tables must agree bitwise (tier-1
holds them to it).

The device half is PyTorch: :func:`blend_slots` resolves the per-slot
evaluations into the 4-corner blend, and :func:`predict_routed` is the
single-host reference of the halo program in
``repro_torch.launch.serve_sharded`` (same math, per-slot cache gathers
instead of one slots-kernel launch).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core import posterior
from repro_torch.core.blend import blend_corners, corner_ids_weights
from repro_torch.core.partition import PartitionGrid, cell_indices

# 3x3 halo slot layout, row-major over (dy, dx) in {-1, 0, +1}^2:
# slot k <-> offset (dx, dy) = (k % 3 - 1, k // 3 - 1); slot 4 is self.
# The reverse slot (offset negated) is 8 - k.
OFFSETS: tuple[tuple[int, int], ...] = tuple(
    (dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
)
SELF_SLOT = 4
NUM_HALO_SLOTS = 9


class RoutingTable(NamedTuple):
    """Per-partition routed query blocks (host numpy; leading axis = P).

    All arrays are padded to a common ``q_max`` so the device program is
    jit-stable across request batches of varying size/skew (q_max itself
    recompiles only when a batch overflows the previous high-water mark).

    A row of partition p's block is either PRIMARY (the query's owning
    cell is p) or, in a two-level table (``spill=True``), a SPILL row: a
    query from an overflowing neighbor cell re-hosted on p. Spill rows are
    indistinguishable to the device program — corner slots are always
    encoded relative to the HOSTING partition, and a spilled query's 4
    corners stay inside the host's 3x3 halo by construction (the host is
    one of the query's corner cells; see :func:`spill_assign`).

    Fields:
      xq          (P, q_max, 2) float32: queries hosted by each partition.
        Padded rows hold the cell CENTER (an in-domain point, so the
        covariance stays well-conditioned); the mask keeps them out of
        every result.
      qmask       (P, q_max) float32 {0,1}: row validity.
      corner_slot (P, q_max, 4) int32 in [0, 9): each query's 4 corner
        models as 3x3-halo slots relative to the hosting partition
        (see OFFSETS). Padded rows point at SELF_SLOT.
      corner_w    (P, q_max, 4) float32: bilinear blend weights (sum to 1
        on valid rows, all-zero on padded rows).
      src_idx     (P, q_max) int32: original index of each routed query in
        the request batch (0 on padded rows) — the scatter map back.
      counts      (P,) int32: occupied rows per partition block (primary +
        spilled-in; equals the owning-cell bucket counts when no spill).
      owner       (P, q_max) int32: flat OWNING cell id of each row's
        query (== the host id on primary and padded rows) — what makes
        spill rows auditable: ``spill_mask`` is owner != host & valid.
    """

    xq: np.ndarray
    qmask: np.ndarray
    corner_slot: np.ndarray
    corner_w: np.ndarray
    src_idx: np.ndarray
    counts: np.ndarray
    owner: np.ndarray

    @property
    def num_partitions(self) -> int:
        return self.xq.shape[0]

    @property
    def q_max(self) -> int:
        return self.xq.shape[1]

    @property
    def num_queries(self) -> int:
        return int(self.counts.sum())

    def spill_mask(self) -> np.ndarray:
        """(P, q_max) bool: valid rows hosted for a foreign owning cell."""
        host = np.arange(self.num_partitions, dtype=self.owner.dtype)[:, None]
        return (self.owner != host) & (self.qmask > 0)

    def num_spilled(self) -> int:
        """Queries re-hosted off their owning cell (0 for single-level)."""
        return int(self.spill_mask().sum())

    def waste_rows(self) -> int:
        """Padded (allocated-but-unused) device rows: P * q_max - N — the
        quantity two-level routing exists to cap under skew."""
        return self.num_partitions * self.q_max - self.num_queries


def owning_cells(grid: PartitionGrid, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ix, iy) grid cell owning each point — delegates to the SAME binning
    ``partition.partition_data`` uses (``partition.cell_indices``), so a
    routed query always lands on the device that trained on its region."""
    return cell_indices(grid, pts)


def ceil_to(n: int, k: int) -> int:
    """n rounded up to a multiple of k (shared q_max/pad alignment rule)."""
    return ((n + k - 1) // k) * k


def halo_ids(grid: PartitionGrid) -> np.ndarray:
    """(P, 9) int32: partition id at each 3x3-halo slot of every partition
    (own id where the neighbor is off-grid — those slots are never selected
    by a corner, since clipped corners stay inside the grid)."""
    P = grid.num_partitions
    ids = np.empty((P, NUM_HALO_SLOTS), np.int32)
    for p in range(P):
        ix, iy = grid.cell_of(p)
        for k, (dx, dy) in enumerate(OFFSETS):
            jx, jy = ix + dx, iy + dy
            inside = 0 <= jx < grid.gx and 0 <= jy < grid.gy
            ids[p, k] = grid.index_of(jx, jy) if inside else p
    return ids


def spill_assign(
    own: np.ndarray, ids: np.ndarray, q_max: int, num_partitions: int
) -> np.ndarray | None:
    """Two-level host assignment: every query of a cell whose bucket fits
    ``q_max`` stays PRIMARY; hot-cell overflow SPILLS to one of the query's
    other corner cells with free slot capacity.

    Why corner cells are the only legal spill targets: the 4 blend corners
    of a query span a 2x2 window of cells, so any cell of that window sees
    all 4 corners inside its own 3x3 halo — re-hosting the query there
    keeps the device program's slot encoding valid. An arbitrary halo
    neighbor does NOT have that property (a corner can end up 2 steps
    away), which is why the spill candidates are ``set(ids[i]) - {own[i]}``
    and nothing else.

    Deterministic greedy with per-slot occupancy:
      * per hot cell, queries with NO spill candidates (domain-corner
        degenerate windows) are kept primary first, then stable order;
      * overflow is grouped by (owner, corner window) — all queries of a
        group share the same candidate set — groups are processed most
        constrained first (fewest candidates, then largest), and each
        group fills its candidates in descending remaining capacity.

    Args:
      own: (N,) flat owning cell per query.
      ids: (N, 4) corner cell ids (``blend.corner_ids_weights`` order).
      q_max: per-partition slot budget (occupancy hard cap).
      num_partitions: P.

    Returns host (N,) int64 (bincount(host) <= q_max everywhere), or None
    when the overflow does not fit the neighborhood's free capacity at
    this q_max — the caller (policy) must raise q_max.
    """
    host = own.astype(np.int64).copy()
    counts = np.bincount(own, minlength=num_partitions)
    hot = np.flatnonzero(counts > q_max)
    if hot.size == 0:
        return host
    occupancy = np.minimum(counts, q_max)
    has_alt = (ids != own[:, None]).any(axis=1)  # (N,) any candidate != owner

    # collect every hot cell's overflow (candidate-less queries kept
    # primary first — they cannot move, so they must hold a primary slot)
    overflow: list = []
    for p in hot:
        idx = np.flatnonzero(own == p)  # ascending == stable order
        if (~has_alt[idx]).sum() > q_max:
            return None  # immovable queries alone overflow the block
        # candidate-less first (has_alt False sorts before True), stable
        keep_order = idx[np.argsort(has_alt[idx], kind="stable")]
        overflow.append(keep_order[q_max:])
    ovf = np.sort(np.concatenate(overflow))
    if ovf.size == 0:
        return host

    # group by (owner, corner window): one candidate set per group
    keys = np.concatenate([own[ovf, None], ids[ovf]], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    groups = []
    for g in range(uniq.shape[0]):
        members = ovf[inv == g]  # ascending original order
        cands = np.unique(uniq[g, 1:])
        cands = cands[cands != uniq[g, 0]]
        groups.append((len(cands), -members.size, g, members, cands))
    groups.sort(key=lambda t: t[:3])  # most constrained first, deterministic

    for _, _, _, members, cands in groups:
        left = members.size
        filled = 0
        # two passes over candidates in descending remaining capacity (id
        # tiebreak): first an even capacity-capped split — leveling the
        # occupancies keeps shared neighbors open for later groups — then
        # a greedy pass that dumps any remainder wherever slots are free.
        order = np.lexsort((cands, occupancy[cands] - q_max))
        for npass in (len(order), 1):
            for t, j in enumerate(order):
                h = cands[j]
                share = -(-left // max(npass - t, 1))  # ceil even split
                take = min(left, share, q_max - int(occupancy[h]))
                if take <= 0:
                    continue
                host[members[filled:filled + take]] = h
                occupancy[h] += take
                filled += take
                left -= take
            if left == 0:
                break
        if left > 0:
            return None  # neighborhood capacity exhausted at this q_max
    return host


def min_spill_q_max(
    own: np.ndarray, ids: np.ndarray, num_partitions: int
) -> int:
    """Smallest q_max the greedy :func:`spill_assign` can route this batch
    at (binary search; the single-level answer, max bucket count, is always
    feasible and bounds the search)."""
    counts = np.bincount(own, minlength=num_partitions)
    hi = max(int(counts.max()) if own.size else 0, 1)
    lo = max(-(-own.size // num_partitions), 1)  # total rows must cover N
    while lo < hi:
        mid = (lo + hi) // 2
        if spill_assign(own, ids, mid, num_partitions) is not None:
            hi = mid
        else:
            lo = mid + 1
    return lo


def build_routing_table(
    grid: PartitionGrid,
    points: np.ndarray,
    *,
    q_max: int | None = None,
    pad_multiple: int = 8,
    cells: tuple[np.ndarray, np.ndarray] | None = None,
    corners: tuple[np.ndarray, np.ndarray] | None = None,
    spill: bool = False,
    hosts: np.ndarray | None = None,
) -> RoutingTable:
    """Bucket a query batch into padded device blocks (single- or two-level).

    Args:
      grid: the partition grid (must match the sharded cache's grid).
      points: (N, 2) query coordinates.
      q_max: fixed per-partition block size; default = the batch's max
        bucket count rounded up to ``pad_multiple``. When a bucket
        overflows an explicit q_max: with ``spill=False`` raises ValueError
        (routing must never silently drop queries); with ``spill=True``
        the overflow is re-hosted on corner-cell neighbors instead.
      pad_multiple: round q_max up to this (TPU sublane alignment).
      cells: precomputed ``owning_cells(grid, points)`` for this batch.
        Callers that already binned the batch (the q_max policies — both
        :class:`StreamingQMax` and the whole-stream prepass — must count
        buckets before the table is built) pass it through so the binning
        runs ONCE per request, not once per policy decision plus once per
        table; omitted, it is computed here.
      corners: precomputed ``corner_ids_weights(grid, points)`` — same
        reuse contract as ``cells`` (the two-level policy needs the corner
        windows for its spill plan; don't recompute them here).
      spill: build a TWO-LEVEL table — hot-cell overflow beyond q_max is
        hosted on the queries' other corner cells (see :func:`spill_assign`
        and the module docstring). Requires an explicit ``q_max`` (the
        whole point is capping the block below the hot-cell peak; a policy
        such as :class:`TwoLevelQMax` owns that choice).
      hosts: precomputed ``spill_assign`` result for exactly this
        (batch, q_max) — the two-level policy already ran the assignment
        for its feasibility decision; pass it through so it runs once.

    Returns a :class:`RoutingTable` (see its docstring for shapes).
    """
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points must be (N, 2), got {pts.shape}")
    n = pts.shape[0]
    P = grid.num_partitions

    ix, iy = owning_cells(grid, pts) if cells is None else cells
    if ix.shape != (n,) or iy.shape != (n,):
        raise ValueError(
            f"cells must be owning_cells output for the batch: expected two "
            f"({n},) arrays, got {ix.shape} and {iy.shape}"
        )
    own = iy * grid.gx + ix  # (N,) flat owning partition
    ids, w = corner_ids_weights(grid, pts) if corners is None else corners
    if ids.shape != (n, 4) or w.shape != (n, 4):
        raise ValueError(
            f"corners must be corner_ids_weights output for the batch: "
            f"expected two (n, 4) arrays, got {ids.shape} and {w.shape}"
        )

    counts = np.bincount(own, minlength=P).astype(np.int32)
    need = int(counts.max()) if n else 0
    if spill and q_max is None:
        raise ValueError(
            "spill=True needs an explicit q_max budget (use TwoLevelQMax "
            "or min_spill_q_max to choose one)"
        )
    if q_max is None:
        qm = max(need, 1)
    elif need > q_max and not spill:
        raise ValueError(
            f"partition bucket of {need} queries overflows q_max={q_max}; "
            "routing never drops queries — raise q_max, split the batch, "
            "or route two-level (spill=True)"
        )
    else:
        qm = q_max
    qm = ceil_to(qm, pad_multiple)

    if spill:
        host = spill_assign(own, ids, qm, P) if hosts is None else np.asarray(hosts)
        if host is None and qm != q_max:
            # greedy feasibility is not strictly monotone in q_max, so the
            # pad-rounded budget can in principle fail where the caller's
            # exact q_max succeeded — any assignment within the smaller
            # budget also fits the padded block (occupancy <= q_max <= qm)
            host = spill_assign(own, ids, int(q_max), P)
        if host is None:
            raise ValueError(
                f"two-level routing infeasible at q_max={qm}: hot-cell "
                "overflow exceeds the corner neighborhoods' free capacity "
                "— raise q_max (min_spill_q_max gives the feasible floor)"
            )
        if host.shape != (n,):
            raise ValueError(f"hosts must be ({n},), got {host.shape}")
    else:
        host = own
    counts = np.bincount(host, minlength=P).astype(np.int32)
    if n and int(counts.max()) > qm:
        raise ValueError("spill assignment overflows q_max — invalid hosts=")

    # corner slots RELATIVE TO THE HOST cell; a spill host is one of the
    # query's corner cells, so every slot stays inside the 3x3 halo
    hx_, hy_ = host % grid.gx, host // grid.gx
    dx = ids % grid.gx - hx_[:, None]  # (N, 4) in {-1, 0, 1}
    dy = ids // grid.gx - hy_[:, None]
    slot = ((dy + 1) * 3 + (dx + 1)).astype(np.int32)
    if n and (np.abs(dx).max() > 1 or np.abs(dy).max() > 1):
        raise AssertionError("spill host outside a query's corner window")

    # stable bucket fill, vectorized: position of each query within its
    # hosting partition's block = rank among same-host queries.
    order = np.argsort(host, kind="stable")
    sorted_host = host[order]
    pos = np.arange(n) - np.searchsorted(sorted_host, sorted_host)

    # padded rows: cell centers (valid covariance inputs, masked on output)
    cx = 0.5 * (grid.x_edges[:-1] + grid.x_edges[1:])
    cy = 0.5 * (grid.y_edges[:-1] + grid.y_edges[1:])
    centers = np.stack(np.meshgrid(cx, cy), axis=-1).reshape(P, 2).astype(np.float32)

    xq = np.broadcast_to(centers[:, None, :], (P, qm, 2)).copy()
    qmask = np.zeros((P, qm), np.float32)
    corner_slot = np.full((P, qm, 4), SELF_SLOT, np.int32)
    corner_w = np.zeros((P, qm, 4), np.float32)
    src_idx = np.zeros((P, qm), np.int32)
    owner = np.broadcast_to(
        np.arange(P, dtype=np.int32)[:, None], (P, qm)
    ).copy()

    xq[sorted_host, pos] = pts[order]
    qmask[sorted_host, pos] = 1.0
    corner_slot[sorted_host, pos] = slot[order]
    corner_w[sorted_host, pos] = w[order]
    src_idx[sorted_host, pos] = order.astype(np.int32)
    owner[sorted_host, pos] = own[order].astype(np.int32)

    return RoutingTable(
        xq=xq, qmask=qmask, corner_slot=corner_slot, corner_w=corner_w,
        src_idx=src_idx, counts=counts, owner=owner,
    )


class StreamingQMax:
    """Streaming high-water-mark q_max policy for a LIVE request stream.

    The whole-stream prepass (``serve_sharded.fixed_q_max``) needs every
    batch up front — impossible for a real stream. This policy instead
    grows q_max only when a batch's max bucket count overflows the current
    high-water mark, jumping to ``need * headroom`` rounded up with the
    SAME :func:`ceil_to` alignment the table applies. Multiplicative
    headroom bounds the total number of shape changes (device-program
    recompiles) at O(log_headroom(peak_need / first_need)) however long
    the stream runs; both overflows and compiles are counted so the
    serving report can show them.

    Usage per batch::

        cells = routing.owning_cells(grid, q)
        q_max = policy.fit(np.bincount(cells_flat, minlength=P))
        table = routing.build_routing_table(grid, q, q_max=q_max, cells=cells)
    """

    def __init__(self, *, headroom: float = 1.25, pad_multiple: int = 8):
        if headroom < 1.0:
            raise ValueError(f"headroom must be >= 1, got {headroom}")
        self.headroom = float(headroom)
        self.pad_multiple = int(pad_multiple)
        self.q_max = 0  # current high-water mark (0 = nothing seen yet)
        self.compiles = 0  # shape changes, INCLUDING the first batch
        self.overflows = 0  # batches that burst the previous high-water mark

    def fit(self, counts: np.ndarray) -> int:
        """Observe a batch's per-partition bucket counts; return the q_max
        to route it with (always >= the batch's max bucket)."""
        need = max(int(np.max(counts)) if np.size(counts) else 0, 1)
        if need > self.q_max:
            if self.q_max:
                self.overflows += 1
            self.q_max = ceil_to(
                int(np.ceil(need * self.headroom)), self.pad_multiple
            )
            self.compiles += 1
        return self.q_max

    def stats(self) -> dict:
        """The SLO-report record: current mark + recompile/overflow counts."""
        return {
            "q_max": self.q_max,
            "compiles": self.compiles,
            "overflows": self.overflows,
        }


class TwoLevelQMax(StreamingQMax):
    """Streaming q_max policy for TWO-LEVEL (spill) routing.

    :class:`StreamingQMax` tracks the high-water mark of the raw max
    bucket count — under skew that is the hot cell's peak, and every other
    device pads to it. This policy instead tracks the POST-SPILL per-slot
    occupancy: a batch only forces a recompile when the greedy spill plan
    (:func:`spill_assign`) cannot place it inside the current mark, and
    growth jumps to the batch's minimal FEASIBLE q_max
    (:func:`min_spill_q_max`) times the same multiplicative headroom — so
    spill capacity feeds back into the recompile decision, and a zipf
    stream settles near the neighborhood-balanced budget (~peak/9 for an
    isolated hot cell) instead of the peak itself.

    Usage per batch (``serve_sharded.make_request_stages`` does this)::

        own = iy * grid.gx + ix                    # owning_cells, flat
        ids, w = corner_ids_weights(grid, q)
        q_max, hosts = policy.fit_spill(grid, own, ids)
        table = routing.build_routing_table(
            grid, q, q_max=q_max, cells=(ix, iy), corners=(ids, w),
            spill=True, hosts=hosts)

    Stats extend the base record with ``spilled`` — total queries
    re-hosted off their owning cell so far.
    """

    def __init__(self, *, headroom: float = 1.25, pad_multiple: int = 8):
        super().__init__(headroom=headroom, pad_multiple=pad_multiple)
        self.spilled = 0  # total queries re-hosted so far

    def fit_spill(
        self, grid: PartitionGrid, own: np.ndarray, ids: np.ndarray
    ) -> tuple[int, np.ndarray]:
        """Observe a batch (flat owning cells + corner ids); return the
        (q_max, hosts) to route it with. ``hosts`` is the exact
        ``spill_assign`` result at the returned q_max — pass BOTH into
        ``build_routing_table`` so the plan is never recomputed."""
        P = grid.num_partitions
        if self.q_max:
            host = spill_assign(own, ids, self.q_max, P)
            if host is not None:  # fits the current mark: no shape change
                self.spilled += int(np.sum(host != own))
                return self.q_max, host
            self.overflows += 1
        need = min_spill_q_max(own, ids, P)
        qm = max(
            ceil_to(int(np.ceil(need * self.headroom)), self.pad_multiple),
            self.q_max,
        )
        host = spill_assign(own, ids, qm, P)
        while host is None:  # greedy can be non-monotone near the floor
            qm = ceil_to(qm + self.pad_multiple, self.pad_multiple)
            host = spill_assign(own, ids, qm, P)
        self.q_max = qm
        self.compiles += 1
        self.spilled += int(np.sum(host != own))
        return qm, host

    def fit(self, counts: np.ndarray) -> int:
        raise TypeError(
            "TwoLevelQMax routes on corner windows, not bucket counts — "
            "call fit_spill(grid, own, ids) (see the class docstring)"
        )

    def stats(self) -> dict:
        return {**super().stats(), "spilled": self.spilled}


def halo_slot_on_grid(grid: PartitionGrid) -> np.ndarray:
    """(P, 9) float32 {0,1}: 1 where the slot's neighbor exists on the grid
    (complement of the off-grid slots ``halo_ids`` clamps to self)."""
    P = grid.num_partitions
    on = np.zeros((P, NUM_HALO_SLOTS), np.float32)
    for p in range(P):
        ix, iy = grid.cell_of(p)
        for k, (dx, dy) in enumerate(OFFSETS):
            if 0 <= ix + dx < grid.gx and 0 <= iy + dy < grid.gy:
                on[p, k] = 1.0
    return on


def make_halo_stacker(grid: PartitionGrid) -> Callable[[np.ndarray], np.ndarray]:
    """Build ``stack(xq) -> hx``: the host-side halo ingest of the sharded
    serving program.

    hx (P, 9, q_max, d) with hx[p, k] = xq[p + OFFSETS[k]] (zeros where the
    neighbor is off-grid — matching ppermute's edge semantics, so the device
    program computes exactly what a mesh-side query exchange would). The
    queries are HOST data: the router already holds every partition's
    block, so shipping each device its full 9-slot stack directly through
    ingest costs one device_put and ZERO mesh collectives — the 1-hop
    reverse halo is reserved for the results, which really do live on
    devices. The (halo_ids, on-grid-mask) tables are precomputed here, once
    per grid, off the per-request path.
    """
    hids = halo_ids(grid)  # (P, 9)
    on = halo_slot_on_grid(grid)  # (P, 9)

    def stack(xq: np.ndarray) -> np.ndarray:
        xq = np.asarray(xq)
        return xq[hids] * on[..., None, None].astype(xq.dtype)

    return stack


def coalesce_requests(requests) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate many small independent query arrays into ONE batch.

    The continuous-batching ingest of the async front door
    (``repro.api.frontdoor``): each request is an (n_i, 2) point array;
    the coalesced (N, 2) batch routes through the device program exactly
    like a single large request, and :func:`demux_results` splits the
    answers back per request. Because every per-row quantity of the
    padded serving program depends only on that row's query point and
    the cached factors (the slots kernel's row-independence contract,
    ``kernels.ref.posterior_predict_slots_masked``), the coalesced-then-
    demuxed results over the sharded path are BITWISE equal to serving
    each request alone — the golden property tests/test_frontdoor.py
    gates. (The replicated path agrees to float32 ULP: XLA specializes
    ``predict`` per batch shape there, so tiny requests can round a last
    bit differently inside a larger batch.)

    Returns (points (N, 2) float32, sizes (R,) int64) with
    N = sizes.sum(). Raises on an empty request list, an empty request,
    or a non-(n, 2) shape — admission control must reject malformed
    requests before they reach a device batch.
    """
    if len(requests) == 0:
        raise ValueError("coalesce_requests needs at least one request")
    arrs = []
    for i, r in enumerate(requests):
        a = np.asarray(r, np.float32)
        if a.ndim != 2 or a.shape[1] != 2 or a.shape[0] < 1:
            raise ValueError(
                f"request {i} must be a non-empty (n, 2) point array, "
                f"got shape {a.shape}"
            )
        arrs.append(a)
    sizes = np.asarray([a.shape[0] for a in arrs], np.int64)
    return np.concatenate(arrs, axis=0), sizes


def demux_results(sizes: np.ndarray, *arrays: np.ndarray) -> list[tuple]:
    """Split coalesced per-point results back into per-request tuples.

    Exact inverse of the concatenation order of
    :func:`coalesce_requests`: ``arrays`` are (N, ...) results for the
    coalesced batch (typically mean and var, each (N,)), and the return
    value is a list of R tuples, tuple i holding each array's
    ``sizes[i]``-row slice for request i. Slices are copies — a demuxed
    result must stay valid after the batch buffer is reused.
    """
    sizes = np.asarray(sizes)
    offsets = np.cumsum(sizes)[:-1]
    per_array = []
    for a in arrays:
        a = np.asarray(a)
        if a.shape[0] != int(sizes.sum()):
            raise ValueError(
                f"result rows {a.shape[0]} != coalesced rows {int(sizes.sum())}"
            )
        per_array.append([s.copy() for s in np.split(a, offsets)])
    return list(zip(*per_array, strict=True))


@contract(
    args={"values": "(P, Q)"},
    returns="(N,)",
    invariants=("scatter-is-gather-inverse",),
)
def scatter_results(table: RoutingTable, values: np.ndarray) -> np.ndarray:
    """Reassemble per-partition padded results into request order.

    ``values`` is (P, q_max) (or (P, q_max, ...)); returns (N, ...) with N =
    ``table.num_queries``, inverting the routing permutation. This is also
    the inverse for TWO-LEVEL tables: ``src_idx`` maps every valid row —
    primary or spilled — straight back to its request position, so spilled
    rows need no extra bookkeeping on the way home (the composed reverse
    halo already delivered their corner evaluations to the hosting device,
    same as primary rows).
    """
    values = np.asarray(values)
    out = np.empty((table.num_queries,) + values.shape[2:], values.dtype)
    valid = table.qmask > 0
    out[table.src_idx[valid]] = values[valid]
    return out


def blend_slots(
    res_mean: torch.Tensor,
    res_var: torch.Tensor,
    corner_slot: torch.Tensor,
    corner_w: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve per-slot evaluations into the 4-corner bilinear blend.

    Args:
      res_mean / res_var: (..., 9, q) — the halo-resolved evaluations of a
        partition's q queries: slot k holds the prediction of the model at
        grid offset OFFSETS[k] from the host.
      corner_slot: (..., q, 4) int64 slot index of each query's 4 corners.
      corner_w: (..., q, 4) bilinear weights.

    Returns (mean (..., q), var (..., q)) — the mixture formula of
    ``blend.predict_blended``, var clamped to >= 1e-12. The blend is
    written as explicit per-row sums of the four weighted terms
    (``blend.blend_corners``), so a row's result does not depend on the
    batch around it: ``submit_many`` equals solo ``submit`` bitwise.
    """
    slots = corner_slot.mT  # (..., 4, q)
    m_c = torch.gather(res_mean, -2, slots)
    v_c = torch.gather(res_var, -2, slots)
    w = corner_w.mT
    return blend_corners(
        [m_c[..., c, :] for c in range(4)],
        [v_c[..., c, :] for c in range(4)],
        [w[..., c, :] for c in range(4)],
    )


def predict_routed(
    cache: posterior.PosteriorCache,
    cov_fn: Callable,
    grid: PartitionGrid,
    table: RoutingTable,
    *,
    use_pallas: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Single-host reference of the halo serving program (same math).

    For every partition p and halo slot k, evaluates the model at
    ``halo_ids(grid)[p, k]`` on p's routed queries, then blends via
    :func:`blend_slots`. ``cache`` is P-stacked on the device to evaluate
    on; ``use_pallas`` evaluates each slot with one launch of the
    cell-axis CUDA kernel (its plain version on CPU tensors). Returns
    (mean (N,), var (N,)) numpy arrays in request order; works unchanged
    on TWO-LEVEL tables.
    """
    dev = cache.z.device
    hids = torch.as_tensor(halo_ids(grid), dtype=torch.long, device=dev)  # (P, 9)
    xq = torch.as_tensor(table.xq, device=dev)
    res = [
        posterior.predict_cached_stacked(
            posterior.take_cache(cache, hids[:, k]), cov_fn, xq, use_pallas=use_pallas
        )
        for k in range(NUM_HALO_SLOTS)
    ]
    res_mean = torch.stack([m for m, _ in res], dim=1)  # (P, 9, q)
    res_var = torch.stack([v for _, v in res], dim=1)
    mean, var = blend_slots(
        res_mean, res_var,
        torch.as_tensor(table.corner_slot.astype(np.int64), device=dev),
        torch.as_tensor(table.corner_w, device=dev),
    )
    return (
        scatter_results(table, mean.cpu().numpy()),
        scatter_results(table, var.cpu().numpy()),
    )
