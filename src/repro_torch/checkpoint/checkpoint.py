"""Read side of the JAX package's pytree checkpoints.

``repro.checkpoint.save_pytree`` writes ``arrays.npz`` keyed by pytree
path (``params/m_star``, ``cache/cov/log_variance``, ...) and a
``manifest.msgpack`` that repeats those keys with their shapes and
dtypes. numpy alone reads the npz, so the port reads that and nothing
else: the manifest is redundant, and msgpack need not be installed.
"""
from __future__ import annotations

import os

import numpy as np

ARRAYS_FILE = "arrays.npz"


def load_arrays(path: str) -> dict[str, np.ndarray]:
    """``{pytree-path: ndarray}`` of the checkpoint directory ``path``."""
    with np.load(os.path.join(path, ARRAYS_FILE)) as data:
        return {key: data[key] for key in data.files}
