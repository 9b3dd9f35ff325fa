"""One partition per rank — the port's counterpart of ``repro.core.psvgp_spmd``.

The JAX module maps the partition grid (gx x gy) onto a device mesh with
axes (``data``, ``model``): partition (ix, iy) lives on the device at
(data = iy, model = ix), so a grid x-step is a shift along ``model`` and
a y-step a shift along ``data``. The port's mesh is a ``torch.distributed``
process group of world size gx * gy with the same mapping: rank r owns
cell (r mod gx, r div gx) (``launch.serve_sharded.HaloMesh``).

:func:`make_spmd_step` is the PSVGP training step on that mesh, one cell
per rank: every rank draws the step's global direction d and its own row
of the step's mini-batch draw (``sampler.sample_row_indices``), gathers
its own batch, and ships it ONE hop against d (:func:`make_shift`, zeros
where the neighbor is off-grid). The parameters and Adam moments never
move; only the B-point batch does — the paper's zero-memory-overhead
exchange. The update is ``psvgp._sgd_step`` at P = 1, the function the
one-process ``psvgp.train_step_ppermute`` calls, so a rank launches the
projection kernel once a step, and the state is bitwise row r of the
one-process step where the library ops round a cell the same at P = 1 as
at P: on the CPU (``tests/test_torch_spmd.py``). On the card cuSOLVER's
Cholesky (``torch.linalg.cholesky_ex``) rounds a lone cell differently
from the same cell in a batch (``chip_smoke.py`` phase 10 names the op),
so there the ranks agree with the one-process fit to float32 rounding,
not bit for bit; the received batches stay bitwise.

The exchange runs on the host: gloo moves CPU tensors, and NCCL needs one
GPU a rank. So a step reads d back to choose the peer — in the same
device-to-host copy as the payload — and cannot be captured in a CUDA
graph; it stays eager.

:func:`make_shift` is the one hop primitive of both communication
patterns: the serving halo (``launch.serve_sharded``) composes its 3x3
neighborhood from it, and training makes one hop a step, from the same
:func:`shift_perm` tables as the JAX package.
"""
from __future__ import annotations

import time
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.partition import PartitionGrid
from repro_torch.core.psvgp import PSVGPConfig, PSVGPState, _sgd_step, importance_weight
from repro_torch.core.sampler import StepDraws, categorical, sample_row_indices
from repro_torch.optim import tree_map

# grid offset (dx, dy) whose payload a receiver takes for each direction
# slot of ``core/neighbors.py``: 1 = east receives from ix + 1, 2 = west
# from ix - 1, 3 = north from iy + 1, 4 = south from iy - 1 (slot 0, self,
# moves nothing)
DIRECTION_OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


def _row_axes(axes: Sequence[str]) -> tuple[str, ...]:
    """Mesh axes carrying the grid's y coordinate (all but the last)."""
    return tuple(axes[:-1])


def grid_matches_mesh(grid: PartitionGrid, mesh, axes: Sequence[str]) -> bool:
    """True when the grid is one partition per mesh position: ``mesh.shape``
    maps each axis name to its size, the last axis carrying x."""
    gx = mesh.shape[axes[-1]]
    gy = int(np.prod([mesh.shape[a] for a in _row_axes(axes)]))
    return grid.gx == gx and grid.gy == gy


def shift_perm(n: int, up: bool) -> list[tuple[int, int]]:
    """(src, dst) pairs for 'receive from index+1' (up) or 'index-1'; edge
    positions receive nothing (the exchange zero-fills them).

    The serving halo exchange builds its 3x3 neighborhood from the same
    permutation tables the training exchange uses."""
    if up:
        return [(i + 1, i) for i in range(n - 1)]
    return [(i - 1, i) for i in range(1, n)]


def make_shift(mesh) -> Callable:
    """Build ``shift(a, dx, dy)`` over host tensors on ``mesh`` (a
    ``HaloMesh``): every rank receives the payload of the rank at grid
    offset (dx, dy), zeros where that neighbor is off-grid (``ppermute``'s
    edge rule). An x-hop and a y-hop are one ``batch_isend_irecv`` each,
    built from :func:`shift_perm`'s (src, dst) tables as in the JAX
    package; a diagonal composes both. Every hop adds one to
    ``mesh.shifts`` and its seconds to ``mesh.exchange_s``."""
    import torch.distributed as dist

    ix, iy = mesh.cell

    def hop(a: torch.Tensor, d: int, along_x: bool) -> torch.Tensor:
        n, me = (mesh.gx, ix) if along_x else (mesh.gy, iy)
        out = torch.zeros_like(a)
        ops = []
        for src, dst in shift_perm(n, up=d > 0):
            if dst == me:
                peer = mesh.peer(src, iy) if along_x else mesh.peer(ix, src)
                ops.append(dist.P2POp(dist.irecv, out, peer, mesh.group))
            if src == me:
                peer = mesh.peer(dst, iy) if along_x else mesh.peer(ix, dst)
                ops.append(dist.P2POp(dist.isend, a, peer, mesh.group))
        t0 = time.perf_counter()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        mesh.exchange_s += time.perf_counter() - t0
        mesh.shifts += 1
        return out

    def shift(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
        a = a.contiguous()
        if dx:
            a = hop(a, dx, along_x=True)
        if dy:
            a = hop(a, dy, along_x=False)
        return a

    return shift


def shard_data(arrays: Sequence[torch.Tensor], mesh) -> tuple[torch.Tensor, ...]:
    """This rank's row of each P-stacked array (x, y, mask, probs, n_eff,
    ...): row ``mesh.rank``, leading axis 1, copied so that it holds no
    view of the other cells' rows (as ``serve_sharded.shard_cache``)."""
    p = mesh.rank
    return tuple(a[p:p + 1].clone() for a in arrays)


def shard_state(state: PSVGPState, mesh) -> PSVGPState:
    """This rank's cell of a P-stacked state: every parameter and Adam
    moment leaf's row ``mesh.rank`` (leading axis 1, copied); the two
    counters are replicated."""
    p = mesh.rank
    params = tree_map(lambda a: a[p:p + 1].clone(), state.params)
    opt = state.opt._replace(mu=tree_map(lambda a: a[p:p + 1].clone(), state.opt.mu),
                             nu=tree_map(lambda a: a[p:p + 1].clone(), state.opt.nu))
    return PSVGPState(params, opt, state.step)


def gather_state(state: PSVGPState, mesh) -> PSVGPState:
    """The P-stacked state from every rank's cell: one all-gather per leaf
    through host memory (gloo), stacked in rank = cell order on the
    state's device. Every rank must call it; every rank gets the whole
    state. For checks and saving, not the training loop."""
    import torch.distributed as dist

    def gather(a: torch.Tensor) -> torch.Tensor:
        local = a.detach().cpu().contiguous()
        parts = [torch.empty_like(local) for _ in range(mesh.size)]
        dist.all_gather(parts, local, group=mesh.group)
        return torch.cat(parts).to(a.device)

    params = tree_map(gather, state.params)
    opt = state.opt._replace(mu=tree_map(gather, state.opt.mu), nu=tree_map(gather, state.opt.nu))
    return PSVGPState(params, opt, state.step)


class SPMDStep:
    """One rank's PSVGP training step on the mesh (:func:`make_spmd_step`),
    in its two halves:

      batch(state, seed, x, y, mask, draws=None) -> (d, bx, by, bm)
          the step's draws, the rank's own batch and the ONE exchange:
          d (1,) int64 on the device, the received batch (1, B, dim),
          (1, B), (1, B) on the device.
      update(state, d, bx, by, bm, probs, n_eff) -> (state, mean loss)
          the importance weight, ``psvgp._sgd_step`` at P = 1 and the
          loss averaged over the ranks (an all-reduce through host
          memory), a host float32 tensor of shape ().

    Calling the step runs both.
    """

    def __init__(self, mesh, cfg: PSVGPConfig, cov_fn: Callable, p_dir: torch.Tensor):
        self.mesh, self.cfg, self.cov_fn = mesh, cfg, cov_fn
        self.p_dir = p_dir
        self.log_p = torch.log(torch.clamp_min(p_dir, 1e-30))
        self.shift = make_shift(mesh)
        self.reduce_s = 0.0  # seconds in the loss all-reduce (incl. the wait for the slowest)

    def __call__(self, state: PSVGPState, seed: int, x, y, mask, probs, n_eff, *,
                 draws: tuple | None = None) -> tuple[PSVGPState, torch.Tensor]:
        return self.update(state, *self.batch(state, seed, x, y, mask, draws=draws), probs, n_eff)

    def batch(self, state: PSVGPState, seed: int, x, y, mask, *,
              draws: tuple | None = None) -> tuple[torch.Tensor, ...]:
        dev = x.device
        B, dim = self.cfg.batch_size, x.shape[-1]
        if draws is None:
            rand = StepDraws(seed, state.step, dev)
            d = categorical(self.log_p, rand)  # draw 0: the global direction
            idx, _ = sample_row_indices(rand, mask[0], B, row=self.mesh.rank)
        else:
            d, idx = (torch.as_tensor(a, device=dev).long() for a in draws)
        bx, by, bm = x[0, idx], y[0, idx], mask[0, idx]
        payload = torch.cat([bx, by[:, None], bm[:, None]], dim=1)  # B x (dim + 2)
        # ONE device-to-host copy: d, which picks the peer, with the payload
        host = torch.cat([d.reshape(1).to(torch.float32), payload.reshape(-1)]).cpu()
        direction = int(host[0])
        dx, dy = DIRECTION_OFFSETS[direction]
        if dx or dy:
            got = self.shift(host[1:].reshape(B, dim + 2), dx, dy).to(dev)
            bx, by, bm = (got[:, :dim].contiguous(), got[:, dim].contiguous(),
                          got[:, dim + 1].contiguous())
        return d.reshape(1), bx[None], by[None], bm[None]

    def update(self, state: PSVGPState, d, bx, by, bm, probs, n_eff
               ) -> tuple[PSVGPState, torch.Tensor]:
        import torch.distributed as dist

        # 0 where the rank has no neighbor in direction d (it received
        # zeros): the likelihood term is a no-op
        w = importance_weight(probs, self.p_dir, d)
        new, losses = _sgd_step(state, bx, by, bm, n_eff, self.cfg, self.cov_fn, ll_weight=w)
        loss = losses.cpu()
        t0 = time.perf_counter()
        dist.all_reduce(loss, group=self.mesh.group)
        self.reduce_s += time.perf_counter() - t0
        return new, loss[0] / self.mesh.size


def make_spmd_step(mesh, axes: Sequence[str], grid: PartitionGrid, cfg: PSVGPConfig,
                   cov_fn: Callable, p_dir: torch.Tensor) -> SPMDStep:
    """Build this rank's PSVGP train step on ``mesh`` (a ``HaloMesh``).

    Arguments at call time, each the rank's own block with leading axis 1
    (:func:`shard_data`, :func:`shard_state`): state (parameter and Adam
    moment leaves (1, ...), replicated counters), seed, x (1, n_max, dim)
    at the global n_max, y (1, n_max), mask (1, n_max), probs (1, 5),
    n_eff (1,). ``draws`` = (d (), idx (B,)) replaces the step's own draws
    (tests feed the JAX package's: d and this device's
    ``fold_in(kb, pid)`` row). Returns (state, mean loss over the ranks).
    Every rank must call it, with the same counters and seed.
    """
    if not grid_matches_mesh(grid, mesh, axes):
        raise ValueError(
            f"grid {grid.gx}x{grid.gy} must equal mesh axes {tuple(axes)} "
            f"{[mesh.shape[a] for a in axes]} (one partition per rank)"
        )
    if grid.wrap_x:
        raise NotImplementedError("wrapped grids need ring perms; default grids are unwrapped")
    return SPMDStep(mesh, cfg, cov_fn, p_dir)
