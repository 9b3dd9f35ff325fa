"""Likelihoods for the SVGP expected log-likelihood term (PyTorch).

Port of ``repro.gp.likelihoods``: the paper's iid Gaussian observation
model (eq. 1), whose expectation under q(f_i) = N(mu_i, s_i) is the first
two terms of eq. (3), and the closed-form Poisson log-link expectation of
the paper's §6 count-data extension, with its Gauss-Hermite quadrature
(the check of the closed form). Elementwise; arguments broadcast.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_LOG2PI = 1.8378770664093453
_POISSON_CAP = 15.0

# 20-point Gauss-Hermite rule (physicists' convention), host arrays as in
# the JAX package; moved to the arguments' device and dtype at each call
_GH_X, _GH_W = np.polynomial.hermite.hermgauss(20)
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)


def gaussian_expected_loglik(y, fmean, fvar, log_beta):
    """E_{q(f)}[log N(y | f, beta^{-1})], elementwise:
    log N(y | fmean, beta^{-1}) - beta/2 * fvar."""
    beta = torch.exp(log_beta)
    return (
        0.5 * log_beta
        - 0.5 * _LOG2PI
        - 0.5 * beta * (y - fmean) ** 2
        - 0.5 * beta * fvar
    )


def poisson_expected_loglik(y, fmean, fvar, log_beta=None):
    """E_{q(f)}[log Poisson(y | exp(f))] = y fmean - E[exp f] - log y!, with
    E[exp f] = exp(fmean + fvar/2) linearised beyond an exponent of 15 (a
    hard clamp would zero the gradient and let an overshooting mean run
    away). ``log_beta`` is accepted and ignored, for a uniform interface."""
    x = fmean + 0.5 * fvar
    cap = _POISSON_CAP
    e_rate = torch.where(
        x <= cap, torch.exp(torch.clamp_max(x, cap)), math.exp(cap) * (1.0 + (x - cap))
    )
    return y * fmean - e_rate - torch.lgamma(y + 1.0)


def poisson_expected_loglik_quadrature(y, fmean, fvar):
    """E_{q(f)}[log Poisson(y | exp(f))] by 20-point Gauss-Hermite
    quadrature, without the closed form's cap: the check of
    :func:`poisson_expected_loglik` (tests only, as in the JAX package)."""
    nodes = torch.as_tensor(_GH_X, dtype=fmean.dtype, device=fmean.device)
    weights = torch.as_tensor(_GH_W, dtype=fmean.dtype, device=fmean.device)
    f = fmean[..., None] + torch.sqrt(2.0 * fvar)[..., None] * nodes  # (..., 20)
    logp = y[..., None] * f - torch.exp(f) - torch.lgamma(y + 1.0)[..., None]
    return _INV_SQRT_PI * torch.sum(weights * logp, dim=-1)
