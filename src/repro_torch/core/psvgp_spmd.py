"""One partition per rank — the port's counterpart of ``repro.core.psvgp_spmd``.

The JAX module maps the partition grid (gx x gy) onto a device mesh with
axes (``data``, ``model``): partition (ix, iy) lives on the device at
(data = iy, model = ix), so a grid x-step is a shift along ``model`` and
a y-step a shift along ``data``. The port's mesh is a ``torch.distributed``
process group of world size gx * gy with the same mapping: rank r owns
cell (r mod gx, r div gx) (``launch.serve_sharded.HaloMesh``).

For now this module holds the two helpers the serving halo exchange
shares with training, copied from the JAX module: :func:`grid_matches_mesh`
and :func:`shift_perm`. The SPMD training step lands here next.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from repro_torch.core.partition import PartitionGrid


def _row_axes(axes: Sequence[str]) -> tuple[str, ...]:
    """Mesh axes carrying the grid's y coordinate (all but the last)."""
    return tuple(axes[:-1])


def grid_matches_mesh(grid: PartitionGrid, mesh, axes: Sequence[str]) -> bool:
    """True when the grid is one partition per mesh position: ``mesh.shape``
    maps each axis name to its size, the last axis carrying x."""
    gx = mesh.shape[axes[-1]]
    gy = int(np.prod([mesh.shape[a] for a in _row_axes(axes)]))
    return grid.gx == gx and grid.gy == gy


def shift_perm(n: int, up: bool) -> list[tuple[int, int]]:
    """(src, dst) pairs for 'receive from index+1' (up) or 'index-1'; edge
    positions receive nothing (the exchange zero-fills them).

    The serving halo exchange builds its 3x3 neighborhood from the same
    permutation tables the training exchange uses."""
    if up:
        return [(i + 1, i) for i in range(n - 1)]
    return [(i - 1, i) for i in range(1, n)]
