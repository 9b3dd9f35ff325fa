"""Neighborhood topology N_j (paper eq. 5) and boundary probe points.

Numpy copy of ``repro.core.neighbors`` (the port must not import the JAX
package); ``BoundaryProbes`` holds numpy arrays, which the metrics move to
the model's device. Neighbors share an edge (4-neighborhood on the grid).

Slot convention used across the sampler and both comm modes:
    slot 0 = self, 1 = +x (east), 2 = -x (west), 3 = +y (north), 4 = -y (south)
Missing neighbors (domain edges, when wrap is off) are -1.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.partition import PartitionGrid

NUM_SLOTS = 5  # self + 4 directions
DIR_NAMES = ("self", "east", "west", "north", "south")


def neighbor_table(grid: PartitionGrid) -> np.ndarray:
    """(P, 5) int32: [self, east, west, north, south], -1 where absent."""
    P = grid.num_partitions
    tbl = np.full((P, NUM_SLOTS), -1, np.int32)
    for p in range(P):
        ix, iy = grid.cell_of(p)
        tbl[p, 0] = p
        # east / west with optional longitude wrap
        if ix + 1 < grid.gx:
            tbl[p, 1] = grid.index_of(ix + 1, iy)
        elif grid.wrap_x:
            tbl[p, 1] = grid.index_of(0, iy)
        if ix - 1 >= 0:
            tbl[p, 2] = grid.index_of(ix - 1, iy)
        elif grid.wrap_x:
            tbl[p, 2] = grid.index_of(grid.gx - 1, iy)
        # north / south never wrap (poles)
        if iy + 1 < grid.gy:
            tbl[p, 3] = grid.index_of(ix, iy + 1)
        if iy - 1 >= 0:
            tbl[p, 4] = grid.index_of(ix, iy - 1)
    return tbl


def direction_permutations(grid: PartitionGrid) -> np.ndarray:
    """(5, P) int32 permutation tables for the ppermute comm mode.

    perm[d][j] = source partition whose mini-batch partition j receives when
    the globally-sampled direction is d; j itself where the neighbor is
    absent (those steps contribute weight 0 for j via the importance weight,
    so receiving own data is merely a no-op placeholder).
    """
    tbl = neighbor_table(grid)
    P = grid.num_partitions
    perm = np.tile(np.arange(P, dtype=np.int32), (NUM_SLOTS, 1))
    for d in range(1, NUM_SLOTS):
        src = tbl[:, d]
        perm[d] = np.where(src >= 0, src, np.arange(P, dtype=np.int32))
    return perm


class BoundaryProbes(NamedTuple):
    """Probe locations along interior partition boundaries (for the RMSD
    smoothness metric of §5: "17,556 locations equally spaced along the
    boundaries between partitions")."""

    points: np.ndarray  # (E, ppe, 2) float32 probe coordinates
    left: np.ndarray  # (E,) int32 partition on one side
    right: np.ndarray  # (E,) int32 partition on the other side


def boundary_probes(grid: PartitionGrid, probes_per_edge: int = 23) -> BoundaryProbes:
    """Equally spaced probes on every interior (and wrapped) shared edge."""
    pts, lefts, rights = [], [], []
    xe, ye = grid.x_edges, grid.y_edges

    def edge_points_vertical(x0, ylo, yhi):
        t = (np.arange(probes_per_edge) + 0.5) / probes_per_edge
        return np.stack([np.full(probes_per_edge, x0), ylo + t * (yhi - ylo)], -1)

    def edge_points_horizontal(y0, xlo, xhi):
        t = (np.arange(probes_per_edge) + 0.5) / probes_per_edge
        return np.stack([xlo + t * (xhi - xlo), np.full(probes_per_edge, y0)], -1)

    for iy in range(grid.gy):
        for ix in range(grid.gx):
            p = grid.index_of(ix, iy)
            # vertical boundary with the east neighbor
            if ix + 1 < grid.gx:
                pts.append(edge_points_vertical(xe[ix + 1], ye[iy], ye[iy + 1]))
                lefts.append(p)
                rights.append(grid.index_of(ix + 1, iy))
            elif grid.wrap_x:
                pts.append(edge_points_vertical(xe[-1], ye[iy], ye[iy + 1]))
                lefts.append(p)
                rights.append(grid.index_of(0, iy))
            # horizontal boundary with the north neighbor
            if iy + 1 < grid.gy:
                pts.append(edge_points_horizontal(ye[iy + 1], xe[ix], xe[ix + 1]))
                lefts.append(p)
                rights.append(grid.index_of(ix, iy + 1))
    return BoundaryProbes(
        points=np.stack(pts).astype(np.float32),
        left=np.asarray(lefts, np.int32),
        right=np.asarray(rights, np.int32),
    )
