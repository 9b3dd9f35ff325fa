"""PSVGP — the paper's contribution (§4): N_part local SVGPs trained with
delta-weighted neighbor sampling (PyTorch).

Port of ``repro.core.psvgp``. Two communication modes, as in the JAX package:

* ``comm="gather"``  — paper-faithful: every partition samples its own
  source partition k' ~ eq. (9) and the mini-batch is one gather.
* ``comm="ppermute"`` — one globally shared direction per step; every
  partition's own mini-batch moves to the neighbor opposite it (a
  permutation of the cells), with importance weights pi_j(d)/p(d) on the
  likelihood term so the update stays unbiased.

Everything carries a leading partition axis P, written out where the JAX
package ``vmap``s: one step evaluates all P local ELBOs at once, and its
loss is the sum over cells of each cell's -ELBO — cells share no parameter,
so the gradient of the sum is each cell's own gradient, which is what the
JAX package's per-cell ``vmap(value_and_grad)`` computes. With
``SVGPConfig.use_pallas`` the ELBO's projection is ONE launch of the CUDA
kernel per step over all (P, B) rows (``kernels/ops.SVGPProjection``).

A step reads nothing back to the host: the draws are counter-based
uniforms of (seed, step) (``sampler.StepDraws``), Adam's bias corrections
are computed on the device from the step count, the Cholesky does not
check its result (``posterior.kmm_chol(check=False)``), and the loss is
returned as a device tensor that only ``fit(log_every=...)`` reads.
Inside :func:`fit` the two counters are int64 tensors on the device, so
the step is a fixed sequence of device work: ``fit(use_scan=True)``, the
counterpart of the JAX package's ``lax.scan`` option, captures it once as
a CUDA graph (:class:`CapturedStep`) and replays it, bitwise the eager
loop.
"""
from __future__ import annotations

import contextlib
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import posterior, svgp
from repro_torch.core.neighbors import direction_permutations, neighbor_table
from repro_torch.core.partition import PartitionedData
from repro_torch.core.sampler import (
    SlotDistribution,
    StepDraws,
    categorical,
    gather_minibatch,
    sample_minibatch_indices,
    sample_slots,
    slot_distribution,
    stream_seed,
)
from repro_torch.gp.covariances import CovarianceParams, make_covariance
from repro_torch.kernels import svgp_proj
from repro_torch.optim import AdamState, adam_init, adam_update, tree_leaves, tree_map
from repro_torch.sharding.dtensor import rows_local

# eager steps that open a captured fit: real steps, and the capture's
# warm-up on a side stream (lazy initialization stays out of the graph)
WARMUP_STEPS = 3


class PSVGPConfig(NamedTuple):
    svgp: svgp.SVGPConfig
    delta: float = 0.0  # eq. (9): 0 = ISVGP, 1 = full PSVGP
    batch_size: int = 32
    learning_rate: float = 0.02
    comm: str = "gather"  # "gather" | "ppermute"
    seed: int = 0


class PSVGPState(NamedTuple):
    params: svgp.SVGPParams  # every leaf has a leading (P, ...) axis
    opt: AdamState
    # SGD steps taken; with the seed it picks the step's draws. An int at
    # the API, an int64 tensor of shape () on the device inside ``fit``
    step: int | torch.Tensor


class PSVGPStatic(NamedTuple):
    """Companions of the step functions, built once from the partition grid
    (``dist``, ``perms`` and ``p_dir`` are None on a loaded artifact)."""

    cfg: PSVGPConfig
    cov_fn: Callable
    dist: SlotDistribution | None
    perms: torch.Tensor | None  # (5, P) int64 direction permutations (ppermute)
    p_dir: torch.Tensor | None  # (5,) global direction probabilities (ppermute)


def build(cfg: PSVGPConfig, data: PartitionedData) -> PSVGPStatic:
    """Precompute topology-dependent tables on the data's device."""
    dev = data.x.device
    tbl = torch.as_tensor(neighbor_table(data.grid), device=dev)
    dist = slot_distribution(data.counts, tbl, cfg.delta)
    perms = torch.as_tensor(direction_permutations(data.grid), device=dev).long()
    # the average of the per-partition slot distributions: minimizes the
    # spread of the importance weights pi_j(d)/p(d) around 1
    p_dir = torch.mean(dist.probs, dim=0)
    p_dir = p_dir / torch.sum(p_dir)
    return PSVGPStatic(cfg=cfg, cov_fn=make_covariance(cfg.svgp.covariance), dist=dist,
                       perms=perms, p_dir=p_dir)


def init(seed: int, cfg: PSVGPConfig, data: PartitionedData) -> PSVGPState:
    """Fresh params (inducing points drawn from each cell's valid rows) and
    zeroed Adam moments, from a generator seeded by ``seed`` alone."""
    gen = torch.Generator(device=data.x.device)
    gen.manual_seed(stream_seed(seed, "init"))
    params = svgp.init_svgp_params(gen, cfg.svgp, data.x, data.mask)
    return PSVGPState(params=params, opt=adam_init(params), step=0)


def _sgd_step(state, bx, by, bm, n_eff, cfg: PSVGPConfig, cov_fn, ll_weight=1.0):
    """-ELBO of every cell on its mini-batch, its gradient, one Adam update.
    Returns (new state, (P,) per-cell losses)."""
    scfg = cfg.svgp
    params = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
    with torch.enable_grad():
        losses = -svgp.elbo(
            params, cov_fn, bx, by, mask=bm, n_total=n_eff, jitter=scfg.jitter,
            whitened=scfg.whitened, use_pallas=scfg.use_pallas, ll_weight=ll_weight,
            likelihood=scfg.likelihood,
        )
        grads = iter(torch.autograd.grad(torch.sum(losses), tree_leaves(params)))
    grads = tree_map(lambda _: next(grads), params)
    with torch.no_grad():
        new_params, new_opt = adam_update(state.params, grads, state.opt, lr=cfg.learning_rate)
    return PSVGPState(new_params, new_opt, state.step + 1), losses.detach()


def train_step_gather(
    state: PSVGPState,
    seed: int,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    dist: SlotDistribution,
    cfg: PSVGPConfig,
    cov_fn: Callable,
    *,
    draws: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[PSVGPState, torch.Tensor]:
    """One SGD iteration of the paper's algorithm for all partitions at once:
    partition j pulls a B-point mini-batch from its sampled source k'_j.

    ``draws`` = (kprime (P,), idx (P, B)) replaces the step's own draws
    (tests feed the JAX package's). Returns (new state, mean -ELBO)."""
    if draws is None:
        rand = StepDraws(seed, state.step, x.device)
        kprime, _slot = sample_slots(rand, dist)
        idx, _ = sample_minibatch_indices(rand, mask[kprime], cfg.batch_size)
    else:
        kprime, idx = draws
    bx, by, bm = gather_minibatch(x, y, mask, kprime, idx)
    # cell by cell: a sharded trace (the dry-run's) updates each rank's cells
    new, losses = rows_local(lambda *a: _sgd_step(*a, cfg, cov_fn), state, bx, by, bm,
                             dist.n_eff)
    return new, torch.mean(losses)


def train_step_ppermute(
    state: PSVGPState,
    seed: int,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    dist: SlotDistribution,
    perms: torch.Tensor,
    p_dir: torch.Tensor,
    cfg: PSVGPConfig,
    cov_fn: Callable,
    *,
    draws: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[PSVGPState, torch.Tensor]:
    """One synchronized-direction step: d ~ p_dir, every partition draws B
    rows of its OWN data, receiver j takes the batch of perms[d][j], and the
    likelihood term is weighted by pi_j(d)/p(d) (0 where j has no neighbor
    in direction d; the KL keeps weight 1).

    ``draws`` = (d (), idx (P, B)) replaces the step's own draws."""
    d, bx, by, bm = ppermute_batch(seed, state.step, x, y, mask, perms, p_dir, cfg.batch_size,
                                   draws=draws)
    w = importance_weight(dist.probs, p_dir, d)
    new, losses = _sgd_step(state, bx, by, bm, dist.n_eff, cfg, cov_fn, ll_weight=w)
    return new, torch.mean(losses)


def importance_weight(probs: torch.Tensor, p_dir: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """pi_j(d) / p(d) of every row of ``probs`` (P, 5) for the direction d
    (1,): 0 where cell j has no neighbor in direction d."""
    pi_jd = torch.index_select(probs, 1, d)[:, 0]
    return pi_jd / torch.clamp_min(torch.index_select(p_dir, 0, d), 1e-30)


def ppermute_batch(
    seed: int,
    step,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    perms: torch.Tensor,
    p_dir: torch.Tensor,
    batch: int,
    *,
    draws: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, ...]:
    """The draws and the received mini-batches of :func:`train_step_ppermute`
    at counter ``step``: (d (1,), bx (P, B, dim), by (P, B), bm (P, B)),
    receiver j holding the batch of perms[d][j] (its own where it has no
    neighbor in direction d)."""
    if draws is None:
        rand = StepDraws(seed, step, x.device)
        d = categorical(torch.log(torch.clamp_min(p_dir, 1e-30)), rand)
        idx, _ = sample_minibatch_indices(rand, mask, batch)
    else:
        d, idx = draws
    d = d.reshape(1)
    perm_row = torch.index_select(perms, 0, d)[0]  # (P,) source of each receiver
    return (d, *gather_minibatch(x, y, mask, perm_row, idx[perm_row]))


def train_step(static: PSVGPStatic, state: PSVGPState, data: PartitionedData,
               seed: int | None = None):
    """Dispatch on the configured communication mode."""
    seed = static.cfg.seed if seed is None else seed
    if static.cfg.comm == "gather":
        return train_step_gather(
            state, seed, data.x, data.y, data.mask, static.dist, static.cfg, static.cov_fn
        )
    if static.cfg.comm == "ppermute":
        return train_step_ppermute(
            state, seed, data.x, data.y, data.mask, static.dist, static.perms, static.p_dir,
            static.cfg, static.cov_fn,
        )
    raise ValueError(f"unknown comm mode {static.cfg.comm!r}")


def fit(
    static: PSVGPStatic,
    state: PSVGPState,
    data: PartitionedData,
    num_iters: int,
    seed: int | None = None,
    log_every: int = 0,
    use_scan: bool = False,
) -> PSVGPState:
    """Run ``num_iters`` SGD iterations from a state whose counters are
    ints. Step t's draws depend on (seed, t) only, so a continued run never
    replays earlier batches. Nothing is read back to the host unless
    ``log_every`` asks for the loss.

    ``use_scan`` (with ``log_every`` 0, as in the JAX package) runs the
    steps after the first :data:`WARMUP_STEPS` as replays of ONE captured
    step (:class:`CapturedStep`): on CUDA a CUDA graph, so the host issues
    a step in one call instead of ~500 ops; on the CPU the same function
    eagerly. Identical math either way: the state is bitwise that of the
    plain loop. A capture or replay that fails raises."""
    seed = static.cfg.seed if seed is None else seed
    end = (state.step + num_iters, state.opt.step + num_iters)
    state = device_counters(state, data.x.device)
    if use_scan and not log_every:
        warm = min(num_iters, WARMUP_STEPS)
        state = _warm_up(static, state, data, seed, warm)
        if num_iters > warm:
            captured = CapturedStep(static, state, data, seed)
            captured.replay(num_iters - warm)
            state = captured.state()
    else:
        for i in range(num_iters):
            state, loss = train_step(static, state, data, seed)
            if log_every and (i + 1) % log_every == 0:
                print(f"  iter {i + 1:5d}  mean -ELBO/partition: {float(loss):.4f}")
    return PSVGPState(state.params, state.opt._replace(step=end[1]), end[0])


def _warm_up(static: PSVGPStatic, state: PSVGPState, data: PartitionedData, seed: int,
             n: int) -> PSVGPState:
    """``n`` eager steps before a capture: on CUDA on a side stream, as
    torch asks of a capture's warm-up, then joined to the current stream."""
    dev = data.x.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
        for _ in range(n):
            state, _loss = train_step(static, state, data, seed)
    if side is not None:
        torch.cuda.current_stream(dev).wait_stream(side)
    return state


def device_counters(state: PSVGPState, device) -> PSVGPState:
    """``state`` with its int counters as int64 tensors of shape () on
    ``device`` (each a fill kernel, not a host-to-device copy)."""

    def counter(n: int) -> torch.Tensor:
        return torch.full((), int(n), dtype=torch.int64, device=device)

    return PSVGPState(state.params, state.opt._replace(step=counter(state.opt.step)),
                      counter(state.step))


class CapturedStep:
    """One SGD step over static state buffers, replayed.

    The buffers are clones of ``state`` (counters as device tensors, see
    :func:`fit`). A step reads them, computes the new state out of place
    and copies it back into them, counters included, so replay t draws
    step t's numbers. On CUDA the step is captured once into a
    ``torch.cuda.CUDAGraph`` (on the capture's own stream; lazy
    initialization must have run, e.g. by eager steps on a side stream)
    and :meth:`replay` launches the graph; on the CPU :meth:`replay` runs
    the same step eagerly. The projection kernel's wrapper ran once, at
    capture, when nothing launched: ``svgp_proj.LAUNCHES`` counts the
    launches each replay makes instead."""

    def __init__(self, static: PSVGPStatic, state: PSVGPState, data: PartitionedData,
                 seed: int | None = None):
        self.static, self.data = static, data
        self.seed = static.cfg.seed if seed is None else seed
        self.buffers = tree_map(torch.clone, state)
        self.graph = None
        self.launches: dict = {}
        if data.x.device.type == "cuda":
            self.graph = torch.cuda.CUDAGraph()
            before = dict(svgp_proj.LAUNCHES)
            with torch.cuda.graph(self.graph):
                self._step()
            self.launches = svgp_proj.captured_launches(before)

    def _step(self) -> None:
        new, _loss = train_step(self.static, self.buffers, self.data, self.seed)
        for dst, src in zip(tree_leaves(self.buffers), tree_leaves(new), strict=True):
            dst.copy_(src)

    def replay(self, n: int = 1) -> None:
        """Run ``n`` more steps."""
        for _ in range(n):
            if self.graph is None:
                self._step()
            else:
                self.graph.replay()
        svgp_proj.count_replays(self.launches, n)

    def state(self) -> PSVGPState:
        """A fresh copy of the state (counters still device tensors)."""
        return tree_map(torch.clone, self.buffers)


def params_from_numpy(arrays: dict, prefix: str, device) -> svgp.SVGPParams:
    """SVGPParams from ``{pytree-path: ndarray}`` keys under ``prefix``
    (``params/m_star``, ``params/cov/log_variance``, ...), float32 on ``device``."""

    def t(key):
        return torch.as_tensor(np.asarray(arrays[f"{prefix}/{key}"], np.float32), device=device)

    return svgp.SVGPParams(
        m_star=t("m_star"), s_tril=t("s_tril"), z=t("z"),
        cov=CovarianceParams(t("cov/log_lengthscale"), t("cov/log_variance")),
        log_beta=t("log_beta"),
    )


def state_from_numpy(arrays: dict, device) -> PSVGPState:
    """Carry a JAX ``PSVGPState`` into the port: ``arrays`` holds its leaves
    as numpy by pytree path (``params/...``, ``opt/step``, ``opt/mu/...``,
    ``opt/nu/...``, ``step`` — the keys ``repro.checkpoint`` writes)."""
    opt = AdamState(
        step=int(arrays["opt/step"]),
        mu=params_from_numpy(arrays, "opt/mu", device),
        nu=params_from_numpy(arrays, "opt/nu", device),
    )
    return PSVGPState(params_from_numpy(arrays, "params", device), opt, int(arrays["step"]))


# --------------------------------------------------------------------------
# Prediction / evaluation through the PosteriorCache (core/posterior.py):
# factorize the P local posteriors once per trained state, then every
# prediction is O(Q m^2) against the cached factors.
# --------------------------------------------------------------------------


def posterior_cache(static: PSVGPStatic, state: PSVGPState) -> posterior.PosteriorCache:
    """P-stacked prediction cache for the current state — one batched
    O(P m^3) factorization."""
    scfg = static.cfg.svgp
    return posterior.build_cache_stacked(
        state.params, static.cov_fn, jitter=scfg.jitter, whitened=scfg.whitened
    )


def predict_local(
    static: PSVGPStatic,
    state: PSVGPState,
    xstar: torch.Tensor,
    cache: posterior.PosteriorCache | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each partition's model predicts at its OWN rows of xstar (P, Q, d)."""
    if cache is None:
        cache = posterior_cache(static, state)
    return posterior.predict_cached_stacked(cache, static.cov_fn, xstar)


def predict_at_partitions(
    static: PSVGPStatic,
    state: PSVGPState,
    part_ids: torch.Tensor,
    points: torch.Tensor,
    cache: posterior.PosteriorCache | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Predict ``points`` (E, Q, d) with the models of ``part_ids`` (E,)."""
    if cache is None:
        cache = posterior_cache(static, state)
    return posterior.predict_cached_stacked(
        posterior.take_cache(cache, part_ids), static.cov_fn, points
    )
