"""Evaluation metrics from the paper's §5 (PyTorch).

Port of ``repro.core.metrics``:

* RMSPE over all observations — each partition's model predicts its own
  data (in-sample, as the paper reports).
* Boundary RMSD — root mean square difference between the predictions of
  neighboring local models at probe locations equally spaced along shared
  boundaries (the paper uses 17,556 such locations for the 20x20 grid).

Every metric accepts a precomputed ``PosteriorCache``; pass one when
evaluating several metrics against the same trained state so the P
Cholesky factorizations run once. Results are 0-dim tensors on the model's
device.
"""
from __future__ import annotations

import torch

from repro_torch.core.neighbors import BoundaryProbes
from repro_torch.core.partition import PartitionedData
from repro_torch.core.posterior import PosteriorCache
from repro_torch.core.psvgp import (
    PSVGPState,
    PSVGPStatic,
    posterior_cache,
    predict_at_partitions,
    predict_local,
)


def rmspe(
    static: PSVGPStatic,
    state: PSVGPState,
    data: PartitionedData,
    cache: PosteriorCache | None = None,
) -> torch.Tensor:
    """Global in-sample root-mean-square prediction error."""
    mean, _ = predict_local(static, state, data.x, cache=cache)  # (P, n_max)
    se = (mean - data.y) ** 2 * data.mask
    return torch.sqrt(torch.sum(se) / torch.clamp_min(torch.sum(data.mask), 1.0))


def boundary_rmsd(
    static: PSVGPStatic,
    state: PSVGPState,
    probes: BoundaryProbes,
    cache: PosteriorCache | None = None,
) -> torch.Tensor:
    """RMS disagreement between the two models sharing each boundary."""
    if cache is None:
        cache = posterior_cache(static, state)
    dev = cache.z.device
    points = torch.as_tensor(probes.points, device=dev)
    left = torch.as_tensor(probes.left, device=dev).long()
    right = torch.as_tensor(probes.right, device=dev).long()
    mean_l, _ = predict_at_partitions(static, state, left, points, cache=cache)
    mean_r, _ = predict_at_partitions(static, state, right, points, cache=cache)
    return torch.sqrt(torch.mean((mean_l - mean_r) ** 2))


def per_partition_rmspe(
    static: PSVGPStatic,
    state: PSVGPState,
    data: PartitionedData,
    cache: PosteriorCache | None = None,
) -> torch.Tensor:
    """(P,) in-sample RMSPE per partition (pole partitions are the hard ones)."""
    mean, _ = predict_local(static, state, data.x, cache=cache)
    se = (mean - data.y) ** 2 * data.mask
    cnt = torch.clamp_min(torch.sum(data.mask, dim=1), 1.0)
    return torch.sqrt(torch.sum(se, dim=1) / cnt)


def holdout_rmspe(
    static: PSVGPStatic,
    state: PSVGPState,
    x_hold: torch.Tensor,
    y_hold: torch.Tensor,
    mask_hold: torch.Tensor,
    cache: PosteriorCache | None = None,
) -> torch.Tensor:
    """Out-of-sample RMSPE on held-out points already routed to partitions
    (x_hold (P, Q, d), y_hold and mask_hold (P, Q))."""
    mean, _ = predict_local(static, state, x_hold, cache=cache)
    se = (mean - y_hold) ** 2 * mask_hold
    return torch.sqrt(torch.sum(se) / torch.clamp_min(torch.sum(mask_hold), 1.0))
