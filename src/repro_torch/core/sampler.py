"""The paper's modified SGD sampler — eq. (8) with the delta interpolation
of eq. (9) (PyTorch).

Port of ``repro.core.sampler``. Per iteration and per partition j:
  1. choose a source slot k' over {self, 4 neighbors} with probabilities
        P(k'=j)            = n_j / n_eff_j
        P(k'=k), k in N_j  = delta * n_k / n_eff_j
        n_eff_j            = n_j + delta * sum_{k in N_j, k != j} n_k
  2. draw B observations uniformly without replacement from partition k'.
  3. scale the mini-batch gradient by n_eff_j / B_eff.

The draws are the JAX package's: a Gumbel-max categorical for the slot and
the top-B of uniform scores (padded rows pushed below every valid row) for
the rows. The bits are not: threefry is replaced by counter-based uniforms
(:class:`StepDraws`), so the two packages agree in distribution, and tests
compare steps by feeding both the same draws. A step's uniforms are a
function of (seed, step, draw, element) alone, computed with torch integer
ops from a step counter that may live on the device — as
``fold_in(key, step)`` does, a warm refit never replays step 0's batches,
and a CUDA graph of the step draws step t's numbers at its t-th replay.
The uniforms are the same bits on the CPU and on the card, and so is the
gather step's ranking (``kernels.ops.minibatch_draws``: the kernel or its
plain twin); the ppermute and SPMD steps rank by ``torch.topk``.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from repro_torch.core.neighbors import NUM_SLOTS


class SlotDistribution(NamedTuple):
    probs: torch.Tensor  # (P, 5) slot probabilities, rows sum to 1
    n_eff: torch.Tensor  # (P,) effective data sizes n_eff_j (eq. 9)
    neighbor_tbl: torch.Tensor  # (P, 5) int64, -1 where absent


def stream_seed(seed: int, stream: str, step: int = 0) -> int:
    """A 63-bit generator seed that depends on (seed, stream, step) only."""
    digest = hashlib.blake2b(f"{stream}:{int(seed)}:{int(step)}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def _int64(c: int) -> int:
    """The two's-complement int64 of an unsigned 64-bit constant."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _int64(0x9E3779B97F4A7C15)  # SplitMix64's increment
_MIX1 = _int64(0xBF58476D1CE4E5B9)
_MIX2 = _int64(0x94D049BB133111EB)
_DRAW = _int64(0xD1B54A32D192ED03)  # spaces the draws of one step apart


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's output function on int64 tensors (multiplies wrap
    modulo 2^64 on the CPU and the card alike): a bijection of 64-bit words
    whose outputs on consecutive counters pass BigCrush."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


class StepDraws:
    """The uniforms of one SGD step: draw k of the step (the k-th call of
    :meth:`uniform`) is element i's SplitMix64 output at counter i + 1 from
    a start that mixes (seed, step, k). ``step`` is a Python int or an
    int64 tensor of shape () on ``device`` (read on the device, never on
    the host, so a captured step reads the counter of its replay)."""

    def __init__(self, seed: int, step, device: torch.device):
        if not isinstance(step, torch.Tensor):
            step = torch.full((), int(step), dtype=torch.int64, device=device)
        self.device = torch.device(device)
        self.start = mix64(step * _GOLDEN + stream_seed(seed, "step"))
        self.calls = 0

    def uniform(self, shape: tuple, offset: int = 0) -> torch.Tensor:
        """float32 uniforms in [0, 1) of ``shape``: the top 24 bits of each
        output times 2^-24, exact in float32. ``offset`` skips that many
        elements of the draw: ``uniform((1, n), offset=p * n)`` is row p of
        ``uniform((P, n))`` bit for bit (what one rank of the SPMD step
        draws, ``psvgp_spmd``)."""
        n = 1
        for s in shape:
            n *= s
        start = self.start + _int64(self.calls * _DRAW)
        self.calls += 1
        ctr = torch.arange(offset + 1, offset + n + 1, dtype=torch.int64,
                           device=self.device) * _GOLDEN
        bits = _shr(mix64(ctr + start), 40)
        return (bits.to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def slot_distribution(
    counts: torch.Tensor, neighbor_tbl: torch.Tensor, delta: float
) -> SlotDistribution:
    """Build eq. (9) slot probabilities for every partition.

    counts: (P,) true n_k. neighbor_tbl: (P, 5) with slot 0 = self.
    """
    neighbor_tbl = neighbor_tbl.long()
    valid = neighbor_tbl >= 0
    n_k = counts[neighbor_tbl.clamp_min(0)].float() * valid  # (P, 5)
    scale = torch.ones(NUM_SLOTS, dtype=torch.float32, device=n_k.device)
    scale[1:] = float(delta)  # self keeps n_j, neighbors get delta*n_k
    w = n_k * scale
    n_eff = torch.sum(w, dim=1)
    probs = w / torch.clamp_min(n_eff[:, None], 1e-12)
    return SlotDistribution(probs=probs, n_eff=n_eff, neighbor_tbl=neighbor_tbl)


def gumbel(shape: tuple, draws: StepDraws) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u), u uniform in [tiny, 1)."""
    u = draws.uniform(shape)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))


def categorical(logits: torch.Tensor, draws: StepDraws) -> torch.Tensor:
    """One Gumbel-max draw per row of ``logits`` (..., K) -> (...) int64."""
    return torch.argmax(logits + gumbel(tuple(logits.shape), draws), dim=-1)


def sample_slots(draws: StepDraws, dist: SlotDistribution) -> tuple[torch.Tensor, torch.Tensor]:
    """k' sampling for every partition -> ((P,) source partitions, (P,) slots)."""
    slot = categorical(torch.log(torch.clamp_min(dist.probs, 1e-30)), draws)
    return torch.gather(dist.neighbor_tbl, 1, slot[:, None])[:, 0], slot


def sample_row_indices(
    draws: StepDraws, mask_row: torch.Tensor, batch: int, row: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-row version: (n_max,) mask -> (B,) indices + validity, drawn
    as row ``row`` of :func:`sample_minibatch_indices` over (P, n_max) is:
    the SPMD step's rank p calls it with row p and gets bitwise the one-
    process step's row p (as the JAX package's ``sample_row_indices`` with
    the per-partition folded key)."""
    idx, valid = sample_minibatch_indices(draws, mask_row[None], batch, first_row=row)
    return idx[0], valid[0]


def sample_minibatch_indices(
    draws: StepDraws, mask_rows: torch.Tensor, batch: int, first_row: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform WITHOUT-replacement indices from masked rows.

    mask_rows: (R, n_max) validity of each stored point in the SOURCE row,
    rows ``first_row`` .. ``first_row + R - 1`` of the step's (P, n_max)
    draw. Returns (idx, bmask): (R, B) int64 indices into n_max and their
    validity — a source with fewer than B points fills the surplus with
    padded rows (bmask 0), i.e. the batch degrades to "all n_k points".
    """
    scores = draws.uniform(tuple(mask_rows.shape), offset=first_row * mask_rows.shape[1])
    scores = scores + (mask_rows - 1.0) * 1e9
    idx = torch.topk(scores, batch, dim=1).indices
    return idx, torch.gather(mask_rows, 1, idx)


def gather_minibatch(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    kprime: torch.Tensor,
    idx: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize the (P, B, ...) mini-batches from source partitions kprime:
    row b of partition p is row idx[p, b] of partition kprime[p]. One flat
    gather per array (the storage is (P, n_max, ...), rows contiguous)."""
    P, n_max, d = x.shape
    flat = (kprime[:, None] * n_max + idx).reshape(-1)
    bx = x.reshape(P * n_max, d)[flat].reshape(idx.shape + (d,))
    by = y.reshape(-1)[flat].reshape(idx.shape)
    bm = mask.reshape(-1)[flat].reshape(idx.shape)
    return bx, by, bm
