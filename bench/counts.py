"""Frozen counts of the work: the card's peaks, the projection kernel's
least time and the FLOPs of one SGD step. They follow from the shapes
alone, whatever implements the step. An entry reports its step's FLOPs and
the precision of the peak they are held to (``PEAK_FLOP_PER_S``) in its
``shape``; ``metrics/step_mfu.py`` reads them.

``projection_bound_s`` is a copy of ``chip_smoke.py:projection_bound``
(the projection branch) and ``_bound``; ``step_flops`` is the benchmark's
own count, written out term by term in ``PERF.md``.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores
PEAK_BF16_FLOP_PER_S = 989.4e12  # BF16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3

PEAK_FLOP_PER_S = {"fp32": PEAK_FP32_FLOP_PER_S, "bf16": PEAK_BF16_FLOP_PER_S}

ADAM_FLOPS_PER_ELEMENT = 12  # two moments (3 + 4), the bias-corrected update (5)


def bound_s(nbytes: int, flops: int) -> tuple[float, str]:
    """(seconds, what bounds it): bytes over the HBM rate against operations
    over the FP32 rate, the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def projection_bytes(P: int, B: int, m: int, d: int) -> int:
    """x and the P cells' z, log l, log sigma^2 and W's lower triangle read
    once; knm, lk_t and q_diag written once (float32)."""
    rows = P * B
    return 4 * (rows * d + P * (m * d + d + 1 + m * (m + 1) // 2) + 2 * rows * m + rows)


def projection_flops(P: int, B: int, m: int, d: int) -> int:
    """Per row: scale x (d); per inducing point the difference, square and
    sum (3d), -0.5 r2, exp, * sigma^2 (3); lk_t = knm W^T over W's triangle
    (m(m+1)) and q_diag (2m)."""
    return P * B * (d + m * (3 * d + 3) + m * (m + 1) + 2 * m)


def projection_bound_s(P: int, B: int, m: int, d: int) -> tuple[float, str]:
    """Least time of one launch of the ELBO projection kernel."""
    return bound_s(projection_bytes(P, B, m, d), projection_flops(P, B, m, d))


def elbo_forward_flops(B: int, m: int, d: int) -> int:
    """FLOPs of one cell's -ELBO on its mini-batch of B rows (eq. 3)."""
    return (
        m * m * (3 * d + 3) + m  # K_mm (+ jitter)
        + m**3 // 3  # its Cholesky L
        + B * m * (3 * d + 3)  # K_nm
        + B * m * m  # L^-1 K_mn (triangular solve, B columns)
        + 2 * B * m  # q_ii = ||L^-1 k_i||^2
        + B * m * m  # a = L^-T (L^-1 k_i)
        + 2 * B * m  # fmean = a^T m*
        + B * m * (m + 1)  # S^1/2 a (triangular)
        + 2 * B * m + 2 * B  # fvar = k_ii - q_ii + ||S^1/2 a||^2
        + 12 * B  # expected log-likelihood, mask and sum
        + m**3 // 3  # KL: L^-1 S^1/2 (triangular by triangular)
        + 2 * m * m  # its trace, and L^-1 m*
        + 4 * m + 8  # quadratic term, two log-determinants, the sum
    )


def params_per_cell(m: int, d: int) -> int:
    """m*, S^1/2's m x m, z, log l, log sigma^2, log beta."""
    return m + m * m + m * d + d + 2


def step_flops(P: int, B: int, m: int, d: int) -> int:
    """FLOPs of one SGD step over P cells: the forward, the backward at twice
    the forward, and Adam on every parameter."""
    per_cell = 3 * elbo_forward_flops(B, m, d) + ADAM_FLOPS_PER_ELEMENT * params_per_cell(m, d)
    return P * per_cell
