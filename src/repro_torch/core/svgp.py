"""Sparse Variational Gaussian Process (Hensman et al. 2013) — eq. (3), PyTorch.

Port of ``repro.core.svgp``. The JAX package writes every function for one
model and ``vmap``s it over the P cells; here every leaf may carry leading
batch axes (P for the partitioned model) and the functions broadcast over
them, so one call evaluates all P local ELBOs.

Parameterization (all unconstrained, phi in the paper's notation):
  m_star     (..., m)      variational mean of q(u)
  s_tril     (..., m, m)   unconstrained Cholesky of S_star: tril, diag via exp
  z          (..., m, d)   inducing point locations
  cov        CovarianceParams (ARD log-lengthscales, log-variance)
  log_beta   (...)         log noise precision

``whitened=True`` reparameterizes q(u) = N(L v_m, L V L^T) with L = chol(Kmm).
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.core.posterior import (
    build_cache,
    kmm_chol,
    predict_cached,
    projection,
    s_chol,
)
from repro_torch.gp.covariances import CovarianceParams
from repro_torch.gp.likelihoods import gaussian_expected_loglik, poisson_expected_loglik


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
    use_pallas: bool = False  # route the O(B m^2) hot path through the port's kernel
    likelihood: str = "gaussian"  # gaussian | poisson


def init_svgp_params(
    gen: torch.Generator,
    cfg: SVGPConfig,
    x_init: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> SVGPParams:
    """Initialize P models from their data: x_init (P, n, d), mask (P, n).

    Inducing points are a uniform draw WITHOUT replacement of each cell's
    valid rows (the top-m of uniform scores, padded rows pushed below every
    valid one — the JAX package's idiom): padded slots replicate the cell's
    first point, and drawing them would stack duplicate inducing points
    there. Cells with fewer valid points than m still get duplicates.
    m_star = 0, S_star = I (s_tril = 0), the covariance and noise at their
    configured initial values.
    """
    P, n, d = x_init.shape
    m, dev = cfg.num_inducing, x_init.device
    if mask is None:
        mask = torch.ones((P, n), dtype=x_init.dtype, device=dev)
    scores = torch.rand((P, n), generator=gen, device=dev) + (mask - 1.0) * 1e9
    idx = torch.topk(scores, m, dim=1).indices  # (P, m)
    z = torch.gather(x_init, 1, idx[:, :, None].expand(P, m, d)).clone()
    return SVGPParams(
        m_star=torch.zeros((P, m), device=dev),
        s_tril=torch.zeros((P, m, m), device=dev),
        z=z,
        cov=CovarianceParams(
            log_lengthscale=torch.full((P, d), math.log(cfg.init_lengthscale), device=dev),
            log_variance=torch.full((P,), math.log(cfg.init_variance), device=dev),
        ),
        log_beta=torch.full((P,), math.log(cfg.init_beta), device=dev),
    )


def q_f(
    params: SVGPParams,
    cov_fn: Callable,
    x: torch.Tensor,
    jitter: float = 1e-5,
    whitened: bool = False,
    use_pallas: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Marginal q(f_i) = N(fmean_i, fvar_i) at inputs x (..., B, d):

    fmean = k_i^T Kmm^{-1} m_star              (unwhitened)
    fvar  = k~_ii + a_i^T S a_i  with a_i = Kmm^{-1} k_i   (clamped >= 1e-12)
    """
    lk, kd, lmm = projection(params, cov_fn, x, jitter, use_pallas)
    sl = s_chol(params.s_tril)
    if whitened:
        a = lk  # u = L v, q(v) = N(m_star, S): fmean = lk^T m_star
    else:
        a = torch.linalg.solve_triangular(lmm.mT, lk, upper=True)  # Kmm^{-1} k_i
    fmean = (a.mT @ params.m_star[..., :, None])[..., 0]
    tmp = sl.mT @ a
    fvar = kd + torch.sum(tmp * tmp, dim=-2)
    return fmean, torch.clamp_min(fvar, 1e-12)


def kl_to_prior(
    params: SVGPParams, cov_fn: Callable, jitter: float, whitened: bool
) -> torch.Tensor:
    """KL( N(m_star, S_star) || p(u) ) per model — eq. (3)'s last term, (...)."""
    m = params.m_star.shape[-1]
    sl = s_chol(params.s_tril)
    logdet_s = 2.0 * torch.sum(torch.diagonal(params.s_tril, dim1=-2, dim2=-1), dim=-1)
    if whitened:
        trace = torch.sum(sl * sl, dim=(-2, -1))
        quad = torch.sum(params.m_star**2, dim=-1)
        return 0.5 * (trace + quad - m - logdet_s)
    lmm = kmm_chol(params, cov_fn, jitter, check=False)
    linv_sl = torch.linalg.solve_triangular(lmm, sl, upper=False)
    trace = torch.sum(linv_sl * linv_sl, dim=(-2, -1))  # tr(Kmm^{-1} S)
    linv_m = torch.linalg.solve_triangular(lmm, params.m_star[..., :, None], upper=False)
    quad = torch.sum(linv_m**2, dim=(-2, -1))  # m^T Kmm^{-1} m
    logdet_kmm = 2.0 * torch.sum(torch.log(torch.diagonal(lmm, dim1=-2, dim2=-1)), dim=-1)
    return 0.5 * (trace + quad - m + logdet_kmm - logdet_s)


def elbo(
    params: SVGPParams,
    cov_fn: Callable,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    n_total: torch.Tensor | float | None = None,
    jitter: float = 1e-5,
    whitened: bool = False,
    use_pallas: bool = False,
    ll_weight: torch.Tensor | float = 1.0,
    likelihood: str = "gaussian",
) -> torch.Tensor:
    """Minibatch estimate of eq. (3) per model: (n/B) * sum_batch l_i - KL.

    x (..., B, d), y (..., B). mask: optional (..., B) {0,1} — padded slots
    contribute nothing and the scaling uses sum(mask). n_total (...): the
    "n" of eq. (3) (n_eff,j of eq. 9 for PSVGP); defaults to the effective
    batch size. ll_weight (...): importance weight on the likelihood term
    only (the synchronized-direction estimator). Returns (...).
    """
    fmean, fvar = q_f(params, cov_fn, x, jitter, whitened, use_pallas)
    if likelihood == "gaussian":
        ll = gaussian_expected_loglik(y, fmean, fvar, params.log_beta[..., None])
    elif likelihood == "poisson":
        ll = poisson_expected_loglik(y, fmean, fvar)
    else:
        raise ValueError(likelihood)
    if mask is not None:
        ll = ll * mask
        batch_n = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    else:
        batch_n = torch.full(ll.shape[:-1], float(x.shape[-2]), dtype=ll.dtype, device=ll.device)
    n_tot = batch_n if n_total is None else torch.as_tensor(n_total, dtype=ll.dtype, device=ll.device)
    scale = n_tot / batch_n
    return ll_weight * scale * torch.sum(ll, dim=-1) - kl_to_prior(params, cov_fn, jitter, whitened)


def predict(
    params: SVGPParams,
    cov_fn: Callable,
    xstar: torch.Tensor,
    jitter: float = 1e-5,
    whitened: bool = False,
    include_noise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean/variance at xstar (..., Q, d) (latent f by default):
    one-shot factorize + ``predict_cached``, so the two agree."""
    cache = build_cache(params, cov_fn, jitter=jitter, whitened=whitened)
    return predict_cached(cache, cov_fn, xstar, include_noise=include_noise)
