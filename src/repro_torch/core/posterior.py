"""Cached-posterior prediction — the serving-grade fast path (PyTorch).

Port of ``repro.core.posterior``. ``PosteriorCache`` stores, per local
model, everything S- and Kmm-dependent that predictions reuse:

    w    (m, m)  Lmm^{-1}, Lmm = chol(Kmm+jI)  q_diag_i = ||W k_i||^2
    u    (m, m)  Sl^T A                        s_diag_i = ||U k_i||^2
    c    (m,)    projected variational mean    fmean_i  = k_i^T c

with A = Kmm^{-1}, c = Kmm^{-1} m_star for the standard parameterization
and A = Lmm^{-1}, c = Lmm^{-T} m_star for the whitened one.

The JAX package writes each function for one model and ``vmap``s it over
the P cells. Here the batch axes are written out: every leaf may carry
leading axes (P for a stacked cache, N for one cache row per query), and
the functions broadcast over them — ``build_cache_stacked`` is one
batched ``torch.linalg.cholesky`` over (P, m, m), and ``projection`` (the
training ELBO's linear algebra) runs every cell's mini-batch at once.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.analysis.contracts import contract
from repro_torch.gp.covariances import CovarianceParams, kdiag
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


class PosteriorCache(NamedTuple):
    """Per-model cached prediction factors (leaves may lead with P)."""

    z: torch.Tensor  # (..., m, d) inducing locations
    w: torch.Tensor  # (..., m, m) Lmm^{-1}, Lmm = chol(Kmm + jitter I)
    u: torch.Tensor  # (..., m, m) S-dependent variance factor
    c: torch.Tensor  # (..., m)    projected variational mean
    cov: CovarianceParams
    log_beta: torch.Tensor  # (...)


def map_cache(fn: Callable, cache: PosteriorCache) -> PosteriorCache:
    """Apply ``fn`` to every leaf of ``cache``."""
    return PosteriorCache(
        z=fn(cache.z), w=fn(cache.w), u=fn(cache.u), c=fn(cache.c),
        cov=CovarianceParams(fn(cache.cov.log_lengthscale), fn(cache.cov.log_variance)),
        log_beta=fn(cache.log_beta),
    )


def cache_leaves(cache: PosteriorCache) -> list[torch.Tensor]:
    return [cache.z, cache.w, cache.u, cache.c,
            cache.cov.log_lengthscale, cache.cov.log_variance, cache.log_beta]


def s_chol(s_tril: torch.Tensor) -> torch.Tensor:
    """Constrained Cholesky factor of S_star: strictly-lower + exp(diag)."""
    diag = torch.exp(torch.diagonal(s_tril, dim1=-2, dim2=-1))
    return torch.tril(s_tril, -1) + torch.diag_embed(diag)


def kmm_chol(params: Any, cov_fn: Callable, jitter: float, *, check: bool = True) -> torch.Tensor:
    """chol(Kmm + jitter I) for an SVGPParams-like bundle, (..., m, m).

    ``check=True`` raises on a matrix that is not positive definite, which
    on CUDA costs a host synchronization per call (serving factorizes once).
    ``check=False`` is the training path's form: ``cholesky_ex`` without a
    host read, and a failed factor comes back as NaN, as the JAX package's
    Cholesky does (so a bad step yields NaN and does not stall the loop).
    """
    m = params.z.shape[-2]
    kmm = cov_fn(params.cov, params.z, params.z)
    eye = torch.eye(m, dtype=kmm.dtype, device=kmm.device)
    if check:
        return torch.linalg.cholesky(kmm + jitter * eye)
    lmm, info = torch.linalg.cholesky_ex(kmm + jitter * eye)
    return torch.where((info == 0)[..., None, None], lmm, torch.nan)


def projection(
    params: Any, cov_fn: Callable, x: torch.Tensor, jitter: float, use_pallas: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared O(B m^2) training hot path (the ELBO's eq. 3 projection),
    batched over the leading axes of ``params`` and ``x`` (..., B, d).

    Returns (lk, kdiag_res, lmm):
      lk        (..., m, B): Lmm^{-1} K_mz^T   (a_i = Lmm^{-T} lk_i)
      kdiag_res (..., B):    k~_ii = k_ii - ||lk_i||^2   (eq. 3's k~ term)
      lmm       (..., m, m): chol(Kmm), non-syncing (``kmm_chol(check=False)``)
    With ``use_pallas`` K(X, Z) and the projection run in the fused kernel
    (one launch over every cell on CUDA, its plain version on CPU; RBF
    only); otherwise plain PyTorch for every covariance.
    """
    lmm = kmm_chol(params, cov_fn, jitter, check=False)
    if use_pallas:
        kops.require_rbf(cov_fn)
        _knm, lk_t, q_diag = kops.svgp_projection(
            x, params.z, params.cov.log_lengthscale, params.cov.log_variance, lmm
        )
        lk = lk_t.mT
    else:
        knm = cov_fn(params.cov, x, params.z)  # (..., B, m)
        lk = torch.linalg.solve_triangular(lmm, knm.mT, upper=False)
        q_diag = torch.sum(lk * lk, dim=-2)
    return lk, kdiag(params.cov, x) - q_diag, lmm


def build_cache(
    params: Any,
    cov_fn: Callable,
    *,
    jitter: float = 1e-5,
    whitened: bool = False,
) -> PosteriorCache:
    """Precompute the prediction factors — O(m^3) per model, once. Leaves
    with leading axes are factorized as one batch."""
    lmm = kmm_chol(params, cov_fn, jitter)
    w = kops.lower_inverse(lmm)
    sl = s_chol(params.s_tril)
    m_star = params.m_star[..., :, None]
    if whitened:
        # u = L v, q(v)=N(m_star, S): fmean = k^T Lmm^{-T} m_star
        c = torch.linalg.solve_triangular(lmm.mT, m_star, upper=True)[..., 0]
        u = sl.mT @ w
    else:
        inner = torch.linalg.solve_triangular(lmm, m_star, upper=False)
        c = torch.linalg.solve_triangular(lmm.mT, inner, upper=True)[..., 0]
        u = sl.mT @ (w.mT @ w)  # Sl^T Kmm^{-1}
    # row-major factors: the linear-algebra results may come back column-major
    # (the CUDA kernels take contiguous leaves only)
    return PosteriorCache(z=params.z, w=w.contiguous(), u=u.contiguous(), c=c.contiguous(),
                          cov=params.cov, log_beta=params.log_beta)


def build_cache_stacked(
    params: Any,
    cov_fn: Callable,
    *,
    jitter: float = 1e-5,
    whitened: bool = False,
) -> PosteriorCache:
    """``build_cache`` over a leading partition axis: leaves z (P, m, d),
    w/u (P, m, m), c (P, m), cov (P, d)/(P,), log_beta (P,) — one batched
    O(P m^3) factorization for the whole partitioned model."""
    if params.z.dim() != 3:
        raise ValueError(f"stacked params need z of shape (P, m, d), got {tuple(params.z.shape)}")
    return build_cache(params, cov_fn, jitter=jitter, whitened=whitened)


def _finish(log_beta: torch.Tensor, fvar: torch.Tensor, include_noise: bool) -> torch.Tensor:
    """Clamp fvar (..., Q) to >= 1e-12 and add the noise exp(-log_beta)
    (...) when asked — outside the kernels, as the JAX package does."""
    fvar = torch.clamp_min(fvar, 1e-12)
    if include_noise:
        fvar = fvar + torch.exp(-log_beta)[..., None]
    return fvar


def predict_cached(
    cache: PosteriorCache,
    cov_fn: Callable,
    xstar: torch.Tensor,
    *,
    include_noise: bool = False,
    use_pallas: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean/variance at xstar (..., Q, d) from cached factors.

    fmean = K(x*, Z) c
    fvar  = k_** - ||W k_*||^2 + ||U k_*||^2     (clamped to >= 1e-12)

    Leading axes of the cache leaves and of ``xstar`` broadcast. With
    ``use_pallas`` one model (unbatched leaves) evaluates through the
    single-block CUDA kernel on a CUDA tensor (its plain version on a CPU
    one) — RBF only, validated.
    """
    if use_pallas:
        if cache.z.dim() != 2 or xstar.dim() != 2:
            raise ValueError("use_pallas evaluates one model on (Q, d) queries")
        fmean, fvar = kops.posterior_predict(
            xstar, cache.z, cache.cov.log_lengthscale, cache.cov.log_variance,
            cache.w, cache.u, cache.c, cov_fn=cov_fn,
        )
    else:
        # each row summed in one fixed order in float64 and rounded once
        # (``ref.row_products``): a row's answer does not depend on the
        # batch around it (float64 by design: the CPU lane's bitwise
        # contract, hence the RR003 noqa below)
        knm = cov_fn(cache.cov, xstar, cache.z)  # (..., Q, m)
        fmean = kref.row_products(knm, cache.c[..., None, :])[..., 0].to(knm.dtype)
        qd = kref.row_sumsq(kref.row_products(knm, cache.w))
        sd = kref.row_sumsq(kref.row_products(knm, cache.u))
        fvar = (kdiag(cache.cov, xstar).double() - qd + sd).to(knm.dtype)  # repro: noqa-RR003
    return fmean, _finish(cache.log_beta, fvar, include_noise)


def predict_cached_stacked(
    cache: PosteriorCache,
    cov_fn: Callable,
    xstar: torch.Tensor,
    *,
    include_noise: bool = False,
    use_pallas: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each stacked model predicts at its own rows: cache leaves lead with
    P, xstar (P, Q, d) -> (fmean (P, Q), fvar (P, Q)). ``use_pallas`` runs
    the cell-axis CUDA kernel once over all P cells (S = 1)."""
    if use_pallas:
        fmean, fvar = kops.posterior_predict_slots_stacked(
            xstar[:, None], cache.z, cache.cov.log_lengthscale, cache.cov.log_variance,
            cache.w, cache.u, cache.c, cov_fn=cov_fn,
        )
        return fmean[:, 0], _finish(cache.log_beta, fvar[:, 0], include_noise)
    return predict_cached(cache, cov_fn, xstar, include_noise=include_noise)


def resolve_slot_backend(use_pallas: bool, backend: str | None) -> str:
    """Normalize the (legacy ``use_pallas`` bool, ``backend`` name) pair to
    one kernel lane: "ref" | "pallas" | "fused"."""
    if backend is None:
        return "fused" if use_pallas else "ref"
    if use_pallas:
        raise ValueError("pass either use_pallas or backend=, not both")
    if backend not in ("ref", "pallas", "fused"):
        raise ValueError(f"backend must be 'ref'|'pallas'|'fused', got {backend!r}")
    return backend


@contract(
    args={"xslots": "(S, Q, D)"},
    returns=("(S, Q)", "(S, Q)"),
    invariants=("outputs-f32",),
)
def predict_cached_slots(
    cache: PosteriorCache,
    cov_fn: Callable,
    xslots: torch.Tensor,
    *,
    include_noise: bool = False,
    use_pallas: bool = False,
    backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE model evaluated on S stacked query blocks: xslots (S, Q, d).

    Lanes (``ServeConfig`` vocabulary):
      "ref"    plain PyTorch (every covariance);
      "pallas" the single-block CUDA kernel through a (S*Q, d) reshape;
      "fused"  one launch of the slots CUDA kernel over all S blocks.
    On CPU tensors the two kernel lanes run the kernels' plain versions.

    Returns (fmean (S, Q), fvar (S, Q)); fvar clamped to >= 1e-12.
    """
    backend = resolve_slot_backend(use_pallas, backend)
    if backend == "ref":
        return predict_cached(cache, cov_fn, xslots, include_noise=include_noise)
    if backend == "fused":
        fmean, fvar = kops.posterior_predict_slots(
            xslots, cache.z, cache.cov.log_lengthscale, cache.cov.log_variance,
            cache.w, cache.u, cache.c, cov_fn=cov_fn,
        )
    else:  # "pallas": flatten the stack through the single-block kernel
        S, Q, d = xslots.shape
        fmean, fvar = kops.posterior_predict(
            xslots.reshape(S * Q, d), cache.z,
            cache.cov.log_lengthscale, cache.cov.log_variance,
            cache.w, cache.u, cache.c, cov_fn=cov_fn,
        )
        fmean, fvar = fmean.reshape(S, Q), fvar.reshape(S, Q)
    return fmean, _finish(cache.log_beta, fvar, include_noise)


def predict_cached_slots_stacked(
    cache: PosteriorCache,
    cov_fn: Callable,
    hx: torch.Tensor,
    *,
    include_noise: bool = False,
    backend: str = "ref",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every cell's model on its own S stacked blocks: P-stacked cache,
    hx (P, S, Q, d) -> (fmean (P, S, Q), fvar (P, S, Q)), clamped.

    The one-GPU halo program's evaluation. "fused" is ONE launch of the
    slots kernel over (Q-blocks, S, P); "pallas" is ONE launch of the
    single-block kernel over every cell's (S*Q, d) rows (the JAX lane's
    reshape; the JAX package vmaps the kernel over the cells); "ref" is
    plain PyTorch batched over P.
    """
    backend = resolve_slot_backend(False, backend)
    if backend == "ref":
        per_slot = map_cache(lambda a: a[:, None], cache)  # leaves (P, 1, ...)
        return predict_cached(per_slot, cov_fn, hx, include_noise=include_noise)
    P, S, Q, d = hx.shape
    leaves = (cache.z, cache.cov.log_lengthscale, cache.cov.log_variance,
              cache.w, cache.u, cache.c)
    if backend == "fused":
        fmean, fvar = kops.posterior_predict_slots_stacked(hx, *leaves, cov_fn=cov_fn)
    else:  # "pallas"
        fmean, fvar = kops.posterior_predict(hx.reshape(P, S * Q, d), *leaves, cov_fn=cov_fn)
        fmean, fvar = fmean.reshape(P, S, Q), fvar.reshape(P, S, Q)
    return fmean, _finish(cache.log_beta[:, None], fvar, include_noise)


def take_cache(cache: PosteriorCache, ids) -> PosteriorCache:
    """Gather stacked cache rows along the leading axis: ``ids`` an int
    tensor (duplicates allowed — the blend gathers one row per query per
    corner) or a Python int (one model's unbatched leaves)."""
    return map_cache(lambda a: a[ids], cache)
