"""Pytree checkpoints in the JAX package's format: ``arrays.npz`` keyed by
pytree path plus a ``manifest.msgpack`` of the keys, shapes and dtypes.

``repro.checkpoint.save_pytree`` writes both and its ``load_pytree``
requires the manifest. The machine with the card has no msgpack, so the
write side here encodes the manifest itself: it is a map of str to arrays
of str and of arrays of non-negative ints, and :func:`packb` covers
exactly that subset of msgpack, byte for byte as ``msgpack.packb`` writes
it. The read side needs numpy alone (the manifest repeats what the npz
holds).
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

ARRAYS_FILE = "arrays.npz"
MANIFEST_FILE = "manifest.msgpack"


def load_arrays(path: str) -> dict[str, np.ndarray]:
    """``{pytree-path: ndarray}`` of the checkpoint directory ``path``."""
    with np.load(os.path.join(path, ARRAYS_FILE)) as data:
        return {key: data[key] for key in data.files}


def _sized(out: bytearray, n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """A msgpack header: the fix form below ``fix_max``, else the smallest
    of ``codes`` (one code per 1/2/4-byte big-endian length)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out.extend(struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def packb(obj: Any) -> bytes:
    """msgpack encoding of dicts, lists/tuples, str and non-negative ints."""
    out = bytearray()

    def put(o):
        if isinstance(o, dict):
            _sized(out, len(o), 0x80, 16, (None, 0xDE, 0xDF))
            for k, v in o.items():
                put(k)
                put(v)
        elif isinstance(o, list | tuple):
            _sized(out, len(o), 0x90, 16, (None, 0xDC, 0xDD))
            for v in o:
                put(v)
        elif isinstance(o, str):
            b = o.encode("utf-8")
            _sized(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
            out.extend(b)
        elif isinstance(o, int) and not isinstance(o, bool) and o >= 0:
            if o < 128:
                out.append(o)
            else:
                for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                         (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                    if o < limit:
                        out.append(code)
                        out.extend(struct.pack(fmt, o))
                        break
                else:
                    raise ValueError(f"int {o} too large for msgpack")
        else:
            raise TypeError(f"packb encodes dict/list/str/non-negative int, got {type(o).__name__}")

    put(obj)
    return bytes(out)


def flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """``{pytree-path: ndarray}`` in JAX's flattening order: dict keys
    sorted, NamedTuple fields in declaration order, paths joined by "/"."""
    if isinstance(tree, torch.Tensor | np.ndarray):
        a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree
        return {prefix: np.asarray(a)}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree, strict=True))
    else:
        raise TypeError(f"cannot flatten {type(tree).__name__}")
    out: dict[str, np.ndarray] = {}
    for key, child in items:
        out.update(flatten(child, f"{prefix}/{key}" if prefix else str(key)))
    return out


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` as ``repro.checkpoint.save_pytree`` does, so the JAX
    package's ``load_pytree`` restores it."""
    os.makedirs(path, exist_ok=True)
    flat = flatten(tree)
    np.savez(os.path.join(path, ARRAYS_FILE), **flat)
    manifest = {
        "keys": list(flat.keys()),
        "shapes": [list(v.shape) for v in flat.values()],
        "dtypes": [str(v.dtype) for v in flat.values()],
    }
    with open(os.path.join(path, MANIFEST_FILE), "wb") as f:
        f.write(packb(manifest))
