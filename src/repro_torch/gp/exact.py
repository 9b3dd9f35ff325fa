"""Exact (dense) GP — the O(n^3) reference the paper's eq. (2) describes
(PyTorch).

Port of ``repro.gp.exact``: the SVGP's test oracle. The SVGP ELBO must
lower-bound the exact log marginal likelihood, and SVGP predictions must
converge to the exact GP's as the inducing points approach the data.
One model: x (n, d), y (n,), xstar (n*, d).
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.gp.covariances import CovarianceParams

_LOG2PI = 1.8378770664093453


def _chol(params: CovarianceParams, cov_fn: Callable, x, log_beta, jitter):
    n = x.shape[0]
    knn = cov_fn(params, x, x)
    noise = torch.exp(-log_beta)  # beta is precision, noise variance = 1/beta
    eye = torch.eye(n, dtype=knn.dtype, device=knn.device)
    return torch.linalg.cholesky(knn + (noise + jitter) * eye)


def exact_gp_logml(
    params: CovarianceParams,
    log_beta: torch.Tensor,
    cov_fn: Callable,
    x: torch.Tensor,
    y: torch.Tensor,
    jitter: float = 1e-6,
) -> torch.Tensor:
    """log N(y | 0, K(X,X) + beta^{-1} I)."""
    n = x.shape[0]
    chol = _chol(params, cov_fn, x, log_beta, jitter)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return -0.5 * (y @ alpha + logdet + n * _LOG2PI)


def exact_gp_predict(
    params: CovarianceParams,
    log_beta: torch.Tensor,
    cov_fn: Callable,
    x: torch.Tensor,
    y: torch.Tensor,
    xstar: torch.Tensor,
    jitter: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at xstar — the paper's eq. (2)."""
    chol = _chol(params, cov_fn, x, log_beta, jitter)
    ks = cov_fn(params, x, xstar)  # (n, n*)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    mean = ks.mT @ alpha
    v = torch.linalg.solve_triangular(chol, ks, upper=False)  # (n, n*)
    var = torch.exp(params.log_variance) - torch.sum(v * v, dim=0)
    return mean, torch.clamp_min(var, 0.0)
