"""Post-hoc blended prediction — the replicated serving lane (PyTorch).

Port of ``repro.core.blend``: the stitched surface blends the (up to)
four models whose partition centers surround x, with bilinear weights in
cell-center coordinates; variances combine as the blend of second
moments, var = sum_i w_i (var_i + mean_i^2) - mean^2. Plain PyTorch and
no kernel, as in the JAX package: every query gathers its 4 corners'
cache rows and evaluates them as one batch.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core import posterior
from repro_torch.core.partition import PartitionGrid
from repro_torch.kernels import ref


def corner_ids_weights(grid: PartitionGrid, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 4 surrounding partition models of each point + bilinear weights.

    Args:
      grid: the partition grid topology.
      pts: (N, 2) query coordinates (host numpy; routing is host-side).

    Returns:
      ids (N, 4) int64: flat partition ids of the corner models, ordered
        [lower-left, lower-right, upper-left, upper-right] in cell-center
        coordinates; out-of-grid corners are CLIPPED onto the boundary
        cells, so ids may repeat within a row.
      w (N, 4) float32: bilinear weights, >= 0, summing to 1 per row.

    Every corner id is within one grid step (including diagonals) of the
    cell that OWNS the point — the invariant behind the 1-hop halo.
    """
    xe, ye = grid.x_edges, grid.y_edges
    cw = xe[1] - xe[0]
    ch = ye[1] - ye[0]
    # cell-center coordinates: center of cell (i) is at x0 + (i + .5) cw
    u = (pts[:, 0] - xe[0]) / cw - 0.5
    v = (pts[:, 1] - ye[0]) / ch - 0.5
    ix0 = np.clip(np.floor(u).astype(np.int64), 0, grid.gx - 1)
    iy0 = np.clip(np.floor(v).astype(np.int64), 0, grid.gy - 1)
    ix1 = np.clip(ix0 + 1, 0, grid.gx - 1)
    iy1 = np.clip(iy0 + 1, 0, grid.gy - 1)
    fx = np.clip(u - ix0, 0.0, 1.0)
    fy = np.clip(v - iy0, 0.0, 1.0)
    ids = np.stack(
        [
            iy0 * grid.gx + ix0,
            iy0 * grid.gx + ix1,
            iy1 * grid.gx + ix0,
            iy1 * grid.gx + ix1,
        ],
        axis=1,
    )  # (N, 4)
    w = np.stack(
        [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], axis=1
    ).astype(np.float32)
    return ids, w


def blend_corners(
    means: list[torch.Tensor], varis: list[torch.Tensor], w: list[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 4-corner mixture from per-corner (mean, var, weight) rows.

    Written as explicit sums of the four weighted terms, in corner order,
    so every row's result is the same whatever the batch shape around it.
    Returns (mean, var) with var clamped to >= 1e-12.
    """
    mean = w[0] * means[0] + w[1] * means[1] + w[2] * means[2] + w[3] * means[3]
    second = (
        w[0] * (varis[0] + means[0] * means[0])
        + w[1] * (varis[1] + means[1] * means[1])
        + w[2] * (varis[2] + means[2] * means[2])
        + w[3] * (varis[3] + means[3] * means[3])
    )
    return mean, torch.clamp_min(second - mean * mean, 1e-12)


def predict_blended(
    cache: posterior.PosteriorCache,
    cov_fn: Callable,
    grid: PartitionGrid,
    points,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Continuous stitched prediction at arbitrary points.

    Args:
      cache: the P-stacked ``PosteriorCache`` (on the device to serve from).
      cov_fn: its covariance function.
      grid: partition grid the model was trained on.
      points: (N, 2) query coordinates (array-like or tensor; the corner
        lookup runs on the host).

    Returns (mean (N,), var (N,)) tensors on the cache's device: the
    bilinear 4-corner blend of the local posteriors, var >= 1e-12,
    WITHOUT observation noise.
    """
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points, np.float32)
    ids, w = corner_ids_weights(grid, pts)
    dev = cache.z.device
    xq = torch.as_tensor(pts, device=dev)[:, None, :]  # (N, 1, d)
    ids_t = torch.as_tensor(ids, device=dev)
    w_t = torch.as_tensor(w, device=dev)
    means, varis = [], []
    for c in range(4):
        cache_c = posterior.take_cache(cache, ids_t[:, c])  # leaves (N, ...)
        m_c, v_c = posterior.predict_cached(cache_c, cov_fn, xq)  # (N, 1)
        means.append(m_c[:, 0])
        varis.append(v_c[:, 0])
    return blend_corners(means, varis, [w_t[:, c] for c in range(4)])


def blend_error_scales(
    cache: posterior.PosteriorCache, grid: PartitionGrid, points
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query float64 (mean_scale, var_scale) of the blended prediction
    (RBF models): the magnitudes float32 rounding in (mean, var) is
    proportional to, for ``ref.tolerance_ratio``.

      mean_scale = sum_c w_c sum_j |k_cj c_cj|
      var_scale  = sum_c w_c (||W_c k||^2 + ||U_c k||^2 + v_c + m_c^2
                              + 2 |m_c - mean| mean_scale_c)

    (the blend's var = sum_c w_c (v_c + m_c^2) - mean^2 cancels at the
    scale of its second moment, and moves with the corner means' errors
    times their spread).
    """
    pts = np.asarray(points, np.float32)
    ids, w = corner_ids_weights(grid, pts)
    dev = cache.z.device
    xq = torch.as_tensor(pts, device=dev)[:, None, :]
    # float64 by design: a tolerance scale must not round like the values it
    # bounds (hence the RR003 noqa marks)
    w_t = torch.as_tensor(w, device=dev).double()  # repro: noqa-RR003
    ids_t = torch.as_tensor(ids, device=dev)
    corners = []
    for c in range(4):
        cc = posterior.take_cache(cache, ids_t[:, c])
        args = (xq, cc.z, cc.cov.log_lengthscale, cc.cov.log_variance, cc.w, cc.u, cc.c)
        m_c, v_c = ref.posterior_predict(*(a.double() for a in args))  # repro: noqa-RR003
        ms_c, fs_c = ref.posterior_predict_scales(*args)
        corners.append((m_c[:, 0], torch.abs(v_c[:, 0]), ms_c[:, 0], fs_c[:, 0]))
    mean = sum(w_t[:, c] * corners[c][0] for c in range(4))
    mean_scale = sum(w_t[:, c] * corners[c][2] for c in range(4))
    var_scale = sum(
        w_t[:, c] * (fs + v_c + m_c * m_c + 2.0 * torch.abs(m_c - mean) * ms)
        for c, (m_c, v_c, ms, fs) in enumerate(corners)
    )
    return mean_scale, var_scale
