"""Spatial grid partitioner — the paper's N_part contiguous data partitions.

Port of ``repro.core.partition`` (the port must not import the JAX
package). The grid is host-side numpy; ``partition_data`` bins on the host
and puts the padded storage on an explicit device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


class PartitionedData(NamedTuple):
    """Padded, rectangular per-partition storage (rows of one cell contiguous).

    x: (P, n_max, d) float32; y, mask: (P, n_max) float32 (mask 1 on true
    rows); counts: (P,) int32 true n_k; all on one device. grid: host-side.
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    counts: torch.Tensor
    grid: PartitionGrid

    @property
    def num_partitions(self) -> int:
        return self.x.shape[0]

    @property
    def n_max(self) -> int:
        return self.x.shape[1]


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


def partition_data(
    x: np.ndarray,
    y: np.ndarray,
    grid: PartitionGrid,
    n_max: int | None = None,
    pad_multiple: int = 8,
    *,
    device: torch.device | str = "cpu",
) -> PartitionedData:
    """Assign each observation to its grid cell and pad to rectangular storage.

    The JAX package's rule exactly: a cell keeps its points in data order,
    n_max rounds up to a multiple of ``pad_multiple`` (an explicit ``n_max``
    truncates), padded slots replicate the cell's first point with mask 0
    (so covariance matrices stay well-conditioned), and empty cells keep
    zeros.
    """
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    n, d = x.shape
    ix, iy = cell_indices(grid, x)
    part = iy * grid.gx + ix
    P = grid.num_partitions
    p_count = np.bincount(part, minlength=P)
    nm = int(p_count.max()) if n_max is None else n_max
    nm = ((nm + pad_multiple - 1) // pad_multiple) * pad_multiple

    order = np.argsort(part, kind="stable")
    starts = np.concatenate([[0], np.cumsum(p_count)[:-1]])
    rank = np.arange(n) - starts[part[order]]  # position of each point in its cell
    keep = rank < nm
    src, cell, slot = order[keep], part[order][keep], rank[keep]
    fill = np.minimum(p_count, nm)
    # padded slots replicate the cell's first point; empty cells stay zero
    first = np.zeros((P, d), np.float32)
    first[cell[slot == 0]] = x[src[slot == 0]]
    xp = np.broadcast_to(first[:, None, :], (P, nm, d)).copy()
    yp = np.zeros((P, nm), np.float32)
    mp = np.zeros((P, nm), np.float32)
    xp[cell, slot] = x[src]
    yp[cell, slot] = y[src]
    mp[cell, slot] = 1.0
    dev = torch.device(device)
    return PartitionedData(
        x=torch.as_tensor(xp, device=dev),
        y=torch.as_tensor(yp, device=dev),
        mask=torch.as_tensor(mp, device=dev),
        counts=torch.as_tensor(fill.astype(np.int32), device=dev),
        grid=grid,
    )


def partition_centers(grid: PartitionGrid) -> np.ndarray:
    """(P, 2) cell centers, row-major (x fastest)."""
    cx = 0.5 * (grid.x_edges[:-1] + grid.x_edges[1:])
    cy = 0.5 * (grid.y_edges[:-1] + grid.y_edges[1:])
    xx, yy = np.meshgrid(cx, cy)
    return np.stack([xx.ravel(), yy.ravel()], axis=-1)
