"""Seeds derived from a run's ``--seed``: each consumer gets its own stream."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed that depends on (``seed``, ``name``) only; any whole
    ``seed``, negative or past 64 bits, is accepted."""
    digest = hashlib.blake2b(f"{name}:{int(seed)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1
