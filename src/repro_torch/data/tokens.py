"""Synthetic token pipeline for the LM substrate.

Copy of ``repro.data.tokens`` (pure numpy): the same bytes for the same
arguments.

Deterministic, host-sharded: each data-parallel host slice generates only
its own rows from a counter-based PRNG, so no token ever crosses hosts
(the standard "infinite synthetic corpus" used for performance work).
A light Markov structure (token t+1 depends on t) gives the training loss
something learnable so example runs show a decreasing curve.
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np


def synthetic_token_batches(
    vocab_size: int,
    batch: int,
    seq_len: int,
    seed: int = 0,
    num_batches: int | None = None,
    start_row: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens, targets) of shape (batch, seq_len) int32.

    Markov chain: next = (a * cur + noise) mod V with a small noise alphabet,
    so cross-entropy has a learnable floor well below log(V).
    """
    i = 0
    while num_batches is None or i < num_batches:
        rng = np.random.default_rng((seed, start_row + i))
        cur = rng.integers(0, vocab_size, size=(batch, 1), dtype=np.int64)
        noise = rng.integers(0, 17, size=(batch, seq_len), dtype=np.int64)
        rows = [cur[:, 0]]
        for t in range(1, seq_len):
            rows.append((rows[-1] + noise[:, t]) % vocab_size)
        toks = np.stack(rows, axis=1).astype(np.int32)
        targets = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        yield toks, targets
        i += 1
