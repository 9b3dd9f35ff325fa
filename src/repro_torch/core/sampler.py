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
the rows. The bits are not: a ``torch.Generator`` on the tensors' device
replaces threefry, so the two packages agree in distribution, and tests
compare steps by feeding both the same draws. :func:`step_generator` makes
the stream a function of (seed, step) alone, as ``fold_in(key, step)``
does, so a warm refit never replays step 0's batches.
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


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of SGD step ``step`` of a run seeded ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "step", step))
    return gen


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


def gumbel(shape: tuple, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))


def categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One Gumbel-max draw per row of ``logits`` (..., K) -> (...) int64."""
    return torch.argmax(logits + gumbel(tuple(logits.shape), gen, logits.device), dim=-1)


def sample_slots(gen: torch.Generator, dist: SlotDistribution) -> tuple[torch.Tensor, torch.Tensor]:
    """k' sampling for every partition -> ((P,) source partitions, (P,) slots)."""
    slot = categorical(torch.log(torch.clamp_min(dist.probs, 1e-30)), gen)
    return torch.gather(dist.neighbor_tbl, 1, slot[:, None])[:, 0], slot


def sample_row_indices(
    gen: torch.Generator, mask_row: torch.Tensor, batch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-row version: (n_max,) mask -> (B,) indices + validity."""
    idx, valid = sample_minibatch_indices(gen, mask_row[None], batch)
    return idx[0], valid[0]


def sample_minibatch_indices(
    gen: torch.Generator, mask_rows: torch.Tensor, batch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform WITHOUT-replacement indices from masked rows.

    mask_rows: (P, n_max) validity of each stored point in the SOURCE row.
    Returns (idx, bmask): (P, B) int64 indices into n_max and their
    validity — a source with fewer than B points fills the surplus with
    padded rows (bmask 0), i.e. the batch degrades to "all n_k points".
    """
    scores = torch.rand(tuple(mask_rows.shape), generator=gen, device=mask_rows.device)
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
