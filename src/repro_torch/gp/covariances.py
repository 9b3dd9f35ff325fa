"""Stationary covariance functions with ARD lengthscales (PyTorch).

Port of ``repro.gp.covariances``. Parameters stay unconstrained
("log-space"), exactly as the JAX package stores them.

Shapes: X is (..., n, d), Z is (..., m, d), ``log_lengthscale`` (..., d),
``log_variance`` (...). Output K(X, Z) is (..., n, m). The leading axes
broadcast, so one call covers a single model, a P-stacked cache or one
cache row per query point — the batch axes the JAX package gets from
``vmap`` are written out here.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import NamedTuple

import torch

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979
# data/spatial.py scales lon by 1/36 => full circle = 10 scaled units
_LON_PERIOD = 10.0


class CovarianceParams(NamedTuple):
    """Unconstrained covariance hyperparameters.

    log_lengthscale: (..., d) ARD log-lengthscales.
    log_variance:    (...)    log process variance sigma^2.
    """

    log_lengthscale: torch.Tensor
    log_variance: torch.Tensor


def init_covariance_params(
    d: int, lengthscale: float = 1.0, variance: float = 1.0, dtype=torch.float32, device=None
) -> CovarianceParams:
    """``log_lengthscale`` (d,) filled with log(lengthscale) and a 0-d
    ``log_variance``. Each log is taken in float64 and rounded once to
    ``dtype``; XLA's float32 log, which JAX takes, is not correctly rounded
    and differs from this by one unit in the last place at some arguments
    (0.7 is one), and agrees at others (0.3, 0.5, 1, 2)."""
    return CovarianceParams(
        log_lengthscale=torch.full((d,), math.log(lengthscale), dtype=dtype, device=device),
        log_variance=torch.tensor(math.log(variance), dtype=dtype, device=device),
    )


def ard_distance2(x: torch.Tensor, z: torch.Tensor, log_lengthscale: torch.Tensor) -> torch.Tensor:
    """Squared scaled distance sum_k (x_k - z_k)^2 / l_k^2, shape (..., n, m).

    The explicit-difference form (not the |x|^2 + |z|^2 - 2xz expansion),
    for robustness at small distances, as in the JAX package and the
    CUDA kernel.
    """
    inv_l = torch.exp(-log_lengthscale)[..., None, :]  # (..., 1, d)
    xs = x * inv_l  # (..., n, d)
    zs = z * inv_l  # (..., m, d)
    diff = xs[..., :, None, :] - zs[..., None, :, :]  # (..., n, m, d)
    return torch.sum(diff * diff, dim=-1)


def _variance(params: CovarianceParams) -> torch.Tensor:
    return torch.exp(params.log_variance)[..., None, None]


def rbf(params: CovarianceParams, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    r2 = ard_distance2(x, z, params.log_lengthscale)
    return _variance(params) * torch.exp(-0.5 * r2)


def matern32(params: CovarianceParams, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    r = torch.sqrt(ard_distance2(x, z, params.log_lengthscale) + 1e-20)
    return _variance(params) * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)


def matern52(params: CovarianceParams, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    r2 = ard_distance2(x, z, params.log_lengthscale)
    r = torch.sqrt(r2 + 1e-20)
    return _variance(params) * (1.0 + _SQRT5 * r + (5.0 / 3.0) * r2) * torch.exp(-_SQRT5 * r)


def periodic_lon_rbf(params: CovarianceParams, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """RBF, periodic in the FIRST input dimension (longitude) with period
    ``_LON_PERIOD`` in scaled units, plain RBF in the remaining dims."""
    inv_l = torch.exp(-params.log_lengthscale)  # (..., d)
    d_lon = x[..., :, None, 0] - z[..., None, :, 0]  # (..., n, m)
    s = torch.sin(math.pi * d_lon / _LON_PERIOD)
    r2 = 4.0 * (s * inv_l[..., 0, None, None]) ** 2
    diff = (x[..., :, None, 1:] - z[..., None, :, 1:]) * inv_l[..., None, None, 1:]
    r2 = r2 + torch.sum(diff * diff, dim=-1)
    return _variance(params) * torch.exp(-0.5 * r2)


_REGISTRY: dict[str, Callable] = {
    "rbf": rbf,
    "matern32": matern32,
    "matern52": matern52,
    "periodic_lon_rbf": periodic_lon_rbf,
}


def make_covariance(name: str) -> Callable:
    """Look up a covariance function by name (config-file friendly)."""
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown covariance {name!r}; have {sorted(_REGISTRY)}") from e


def kdiag(params: CovarianceParams, x: torch.Tensor) -> torch.Tensor:
    """diag K(X, X) for any stationary kernel above: the variance, (..., n)."""
    return torch.exp(params.log_variance)[..., None].expand(x.shape[:-1])
