"""The traffic's field: an E3SM-like global temperature slice, made from the seed.

A frozen copy of the algorithm of ``repro_torch.data.spatial.e3sm_like_field``
(uniform points on the sphere, a latitudinal trend plus a random-Fourier-
feature Gaussian random field plus noise, inputs scaled to O(1), the output
standardized), with two changes that a benchmark needs:

* the points are the grid of the mix and do not depend on ``--seed``: they
  come from the mix's ``grid_seed``, as an E3SM grid's columns stay where
  they are from one time slice to the next. Every seed thus gives the same
  partition sizes, so the same work; the seed draws the field's values, and
  the program's draws and initial states;
* the feature sum is taken in blocks of rows, on the card when there is
  one, so a 777,602-point field costs no 1.6 GB host temporary.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.seeds import sub_seed

BLOCK_ROWS = 65536


def sphere_points(n: int, grid_seed: int) -> np.ndarray:
    """(n, 2) float64 (lon in [0, 360), lat in [-90, 90]) degrees, uniform on
    the sphere."""
    rng = np.random.default_rng(grid_seed)
    u = rng.uniform(size=n)
    v = rng.uniform(size=n)
    return np.stack([360.0 * u, np.degrees(np.arcsin(2.0 * v - 1.0))], axis=-1)


def make(mix: dict, seed: int, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """(x (n, 2) float32 scaled (lon, lat), y (n,) float32 standardized) of
    the mix's field under ``seed``."""
    n = int(mix["n_points"])
    lonlat = sphere_points(n, int(mix["grid_seed"]))
    lon, lat = np.radians(lonlat[:, 0]), np.radians(lonlat[:, 1])
    unit = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], axis=-1)

    rng = np.random.default_rng(sub_seed(seed, "field"))
    features = int(mix["num_features"])
    w = rng.normal(scale=1.0 / float(mix["corr_length"]), size=(features, 3))
    phi = rng.uniform(0.0, 2.0 * np.pi, size=features)
    a = rng.normal(size=features) * np.sqrt(2.0 / features)
    noise = rng.normal(scale=float(mix["noise_sd"]), size=n)

    grf = np.empty(n)
    tw, tphi, ta = (torch.as_tensor(v, dtype=torch.float64, device=device) for v in (w, phi, a))
    for lo in range(0, n, BLOCK_ROWS):
        block = torch.as_tensor(unit[lo:lo + BLOCK_ROWS], dtype=torch.float64, device=device)
        grf[lo:lo + BLOCK_ROWS] = (torch.cos(block @ tw.T + tphi) @ ta).cpu().numpy()
    y_raw = float(mix["grf_amplitude"]) * grf + 32.0 * np.cos(lat) ** 2 - 12.0 + noise
    x = np.stack([lonlat[:, 0] / 36.0, lonlat[:, 1] / 18.0], axis=-1).astype(np.float32)
    y = ((y_raw - y_raw.mean()) / y_raw.std()).astype(np.float32)
    return x, y
