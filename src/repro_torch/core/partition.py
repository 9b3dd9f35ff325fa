"""Spatial grid partitioner — the paper's N_part contiguous data partitions.

Numpy copy of the grid half of ``repro.core.partition`` (the port must
not import the JAX package). ``partition_data`` comes with the training
slice. Everything here is host-side.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PartitionGrid(NamedTuple):
    """Static description of the partition grid topology."""

    gx: int  # number of cells in x (longitude)
    gy: int  # number of cells in y (latitude)
    x_edges: np.ndarray  # (gx+1,)
    y_edges: np.ndarray  # (gy+1,)
    wrap_x: bool  # longitude wrap-around (global climate grids)

    @property
    def num_partitions(self) -> int:
        return self.gx * self.gy

    def cell_of(self, i: int) -> tuple[int, int]:
        """Partition index -> (ix, iy), row-major with x fastest."""
        return i % self.gx, i // self.gx

    def index_of(self, ix: int, iy: int) -> int:
        return iy * self.gx + ix


def make_grid(
    x: np.ndarray,
    gx: int,
    gy: int,
    wrap_x: bool = False,
    bounds: tuple[float, float, float, float] | None = None,
) -> PartitionGrid:
    """Build a regular gx x gy grid covering the data (or explicit bounds).

    wrap_x defaults to False even for global (lon, lat) data: the models work
    in raw coordinates, which are NOT periodic across the 0/360 seam.
    """
    if bounds is None:
        x0, x1 = float(x[:, 0].min()), float(x[:, 0].max())
        y0, y1 = float(x[:, 1].min()), float(x[:, 1].max())
        # nudge the upper edges so max-coordinate points fall inside the last cell
        eps_x = 1e-6 * max(x1 - x0, 1.0)
        eps_y = 1e-6 * max(y1 - y0, 1.0)
        x1 += eps_x
        y1 += eps_y
    else:
        x0, x1, y0, y1 = bounds
    return PartitionGrid(
        gx=gx,
        gy=gy,
        x_edges=np.linspace(x0, x1, gx + 1),
        y_edges=np.linspace(y0, y1, gy + 1),
        wrap_x=wrap_x,
    )


def cell_indices(grid: PartitionGrid, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ix, iy) owning grid cell of each point in x (N, 2), int64.

    The ONE binning rule shared by training-time partitioning and
    serving-time query routing (``routing.owning_cells``) — they must
    agree, or routed queries land on cells that never trained on their
    region. Out-of-domain points clip to the edge cells.
    """
    ix = np.clip(np.searchsorted(grid.x_edges, x[:, 0], side="right") - 1, 0, grid.gx - 1)
    iy = np.clip(np.searchsorted(grid.y_edges, x[:, 1], side="right") - 1, 0, grid.gy - 1)
    return ix.astype(np.int64), iy.astype(np.int64)


def partition_centers(grid: PartitionGrid) -> np.ndarray:
    """(P, 2) cell centers, row-major (x fastest)."""
    cx = 0.5 * (grid.x_edges[:-1] + grid.x_edges[1:])
    cy = 0.5 * (grid.y_edges[:-1] + grid.y_edges[1:])
    xx, yy = np.meshgrid(cx, cy)
    return np.stack([xx.ravel(), yy.ravel()], axis=-1)
