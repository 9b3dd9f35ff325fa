"""Likelihoods for the SVGP expected log-likelihood term (PyTorch).

Port of ``repro.gp.likelihoods``: the paper's iid Gaussian observation
model (eq. 1), whose expectation under q(f_i) = N(mu_i, s_i) is the first
two terms of eq. (3), and the closed-form Poisson log-link expectation of
the paper's §6 count-data extension. Elementwise; arguments broadcast.
"""
from __future__ import annotations

import math

import torch

_LOG2PI = 1.8378770664093453
_POISSON_CAP = 15.0


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
