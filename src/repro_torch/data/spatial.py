"""Synthetic E3SM-like spatial fields.

The paper's experiment uses one time slice of an E3SM climate simulation:
48,602 observations over the globe, partitioned 20x20 (400 unbalanced
partitions, 8..222 obs each, median ~150, pole partitions sparse). E3SM
output is not redistributable inside this container, so we synthesize a
surface-temperature-like field with the same geometry:

* observation locations ~ uniform on the sphere => density in (lon, lat)
  coordinates falls off as cos(lat), reproducing the paper's pole-sparse
  partition histogram;
* the field = latitudinal climate trend + smooth Gaussian random field
  (random Fourier features on the embedded sphere => stationary GRF with
  tunable correlation length) + small observation noise (eq. 1's epsilon).

Everything is deterministic given ``seed``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SpatialDataset(NamedTuple):
    x: np.ndarray  # (n, 2) scaled (lon, lat) coordinates used as GP inputs
    y: np.ndarray  # (n,) standardized observations
    lonlat: np.ndarray  # (n, 2) raw degrees, for plotting/partitioning
    y_raw: np.ndarray  # (n,) unstandardized field (deg C - like)


def _sphere_points(n: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform points on S^2 -> (lon deg in [0,360), lat deg in [-90,90])."""
    u = rng.uniform(size=n)
    v = rng.uniform(size=n)
    lon = 360.0 * u
    lat = np.degrees(np.arcsin(2.0 * v - 1.0))
    return np.stack([lon, lat], axis=-1)


def _unit_vectors(lonlat: np.ndarray) -> np.ndarray:
    lon = np.radians(lonlat[:, 0])
    lat = np.radians(lonlat[:, 1])
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], axis=-1
    )


def e3sm_like_field(
    n: int = 48602,
    seed: int = 0,
    num_features: int = 256,
    corr_length: float = 0.35,
    grf_amplitude: float = 6.0,
    noise_sd: float = 0.5,
) -> SpatialDataset:
    """Sample an E3SM-like global temperature field.

    corr_length: GRF correlation length in sphere chord units (R=1); 0.35
    gives continental-scale features similar to fig. 1's single time slice.
    """
    rng = np.random.default_rng(seed)
    lonlat = _sphere_points(n, rng)
    u = _unit_vectors(lonlat)  # (n, 3)

    # Random Fourier features: f(u) = sum a_k cos(w_k.u + phi_k) with
    # w ~ N(0, 1/corr_length^2 I) approximates a squared-exponential GRF.
    w = rng.normal(scale=1.0 / corr_length, size=(num_features, 3))
    phi = rng.uniform(0.0, 2.0 * np.pi, size=num_features)
    a = rng.normal(size=num_features) * np.sqrt(2.0 / num_features)
    grf = grf_amplitude * (np.cos(u @ w.T + phi) @ a)

    lat = lonlat[:, 1]
    trend = 32.0 * np.cos(np.radians(lat)) ** 2 - 12.0  # equator warm, poles cold
    y_raw = trend + grf + rng.normal(scale=noise_sd, size=n)

    # GP inputs: degrees scaled to O(1) so unit init lengthscales are sane.
    x = np.stack([lonlat[:, 0] / 36.0, lonlat[:, 1] / 18.0], axis=-1).astype(np.float32)
    y = ((y_raw - y_raw.mean()) / y_raw.std()).astype(np.float32)
    return SpatialDataset(x=x, y=y, lonlat=lonlat.astype(np.float32), y_raw=y_raw.astype(np.float32))


def zipf_query_stream(
    grid,
    batch: int,
    requests: int,
    *,
    alpha: float = 1.1,
    seed: int = 0,
) -> list:
    """Zipf-skewed serving query stream — the E3SM-style regional-analysis
    workload (most requests probe a few hot regions, a long tail covers
    the rest), used to exercise the two-level router.

    Cells of ``grid`` (a ``repro_torch.core.partition.PartitionGrid``) get
    popularity ~ 1/rank^alpha under a seeded random rank permutation;
    each query picks a cell from that law and a uniform location inside
    it. ``alpha=0`` degenerates to a uniform-over-cells stream (NOT
    uniform over area — cells are equal-area here, so it is both).

    Returns ``requests`` host batches of shape (batch, 2) float32.
    """
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    rng = np.random.default_rng(seed)
    P = grid.gx * grid.gy
    prob = 1.0 / (1.0 + np.arange(P)) ** alpha
    prob = rng.permutation(prob)  # hot cells land anywhere on the grid
    prob /= prob.sum()
    out = []
    for _ in range(requests):
        cell = rng.choice(P, size=batch, p=prob)
        cx, cy = cell % grid.gx, cell // grid.gx
        u = rng.uniform(size=(batch, 2)).astype(np.float64)
        x = grid.x_edges[cx] + u[:, 0] * (grid.x_edges[cx + 1] - grid.x_edges[cx])
        y = grid.y_edges[cy] + u[:, 1] * (grid.y_edges[cy + 1] - grid.y_edges[cy])
        out.append(np.stack([x, y], axis=-1).astype(np.float32))
    return out


def scale_lonlat(lonlat: np.ndarray) -> np.ndarray:
    """The same (lon, lat) -> GP-input scaling used by e3sm_like_field."""
    return np.stack([lonlat[..., 0] / 36.0, lonlat[..., 1] / 18.0], axis=-1).astype(np.float32)
