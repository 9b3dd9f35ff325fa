"""The SVGP containers of one local model (Hensman et al. 2013).

Only ``SVGPConfig`` and ``SVGPParams`` of ``repro.core.svgp``: the
serving slice reads trained parameters and builds caches from them. The
ELBO and its training loop come with the training slice.

Parameterization (all unconstrained, phi in the paper's notation):
  m_star     (m,)      variational mean of q(u)
  s_tril     (m, m)    unconstrained Cholesky of S_star: tril, diag via exp
  z          (m, d)    inducing point locations
  cov        CovarianceParams (ARD log-lengthscales, log-variance)
  log_beta   ()        log noise precision
Every leaf may carry leading batch axes (a P-stacked model).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.gp.covariances import CovarianceParams


class SVGPParams(NamedTuple):
    m_star: torch.Tensor  # (..., m)
    s_tril: torch.Tensor  # (..., m, m) unconstrained
    z: torch.Tensor  # (..., m, d)
    cov: CovarianceParams
    log_beta: torch.Tensor  # (...)


class SVGPConfig(NamedTuple):
    num_inducing: int
    input_dim: int
    covariance: str = "rbf"
    jitter: float = 1e-5
    whitened: bool = False
    init_lengthscale: float = 1.0
    init_variance: float = 1.0
    init_beta: float = 1.0
    use_pallas: bool = False  # route the hot path through the port's kernels
    likelihood: str = "gaussian"  # gaussian | poisson
