"""Pytree checkpoints in the JAX package's format: ``arrays.npz`` keyed by
pytree path plus a ``manifest.msgpack`` of the keys, shapes and dtypes.

Port of ``repro.checkpoint.checkpoint``. The manifest is written and read
with the port's stdlib msgpack codec (``repro_torch.codec``), byte for
byte as ``msgpack`` writes it, so either package restores the other's
checkpoints. A pytree here is a nest of dicts (keys sorted, as JAX
flattens them), NamedTuples, lists and tuples over tensor, ndarray and
Python int leaves; ``None`` is an empty subtree. A Python int leaf stands
for the JAX package's ``()`` int32 counters (``PSVGPState.step``,
``AdamState.step``): it is written as an int32 ``()`` array and read back
as an int, so a port train state restores in ``repro.checkpoint`` and a
JAX one in the port.

Per-step directories ``step_XXXXXXXX`` and a ``latest`` pointer file give
training its resumable semantics (:func:`save_train_state`,
:func:`load_train_state`).
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.codec import packb, unpackb

ARRAYS_FILE = "arrays.npz"
MANIFEST_FILE = "manifest.msgpack"
LATEST_FILE = "latest"

_INT32 = np.iinfo(np.int32)


def load_arrays(path: str) -> dict[str, np.ndarray]:
    """``{pytree-path: ndarray}`` of the checkpoint directory ``path``."""
    with np.load(os.path.join(path, ARRAYS_FILE)) as data:
        return {key: data[key] for key in data.files}


def _children(tree: Any) -> list[tuple[str, Any]]:
    """(path key, child) of one interior node, in JAX's flattening order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree, strict=True))
    if isinstance(tree, list | tuple):
        return [(str(i), child) for i, child in enumerate(tree)]
    raise TypeError(f"cannot flatten {type(tree).__name__}")


def _is_leaf(tree: Any) -> bool:
    return isinstance(tree, torch.Tensor | np.ndarray | np.generic) or (
        isinstance(tree, int) and not isinstance(tree, bool)
    )


def _leaf_array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        if not _INT32.min <= leaf <= _INT32.max:
            raise ValueError(f"int leaf {leaf} does not fit the int32 counter it stands for")
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _walk(tree: Any, prefix: str = ""):
    """(path, leaf) of every leaf of ``tree``, in JAX's order."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield prefix, tree
        return
    for key, child in _children(tree):
        yield from _walk(child, f"{prefix}/{key}" if prefix else key)


def flatten(tree: Any) -> dict[str, np.ndarray]:
    """``{pytree-path: ndarray}`` in JAX's flattening order: dict keys
    sorted, NamedTuple fields in declaration order, sequence items by
    index, paths joined by "/"; int leaves as int32 ``()`` arrays."""
    return {path: _leaf_array(leaf) for path, leaf in _walk(tree)}


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


def _restore_leaf(key: str, arr: np.ndarray, leaf_t: Any) -> Any:
    if isinstance(leaf_t, torch.Tensor):
        want = tuple(leaf_t.shape)
    else:
        want = tuple(np.shape(leaf_t))
    if tuple(arr.shape) != want:
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != template {want}")
    if isinstance(leaf_t, torch.Tensor):
        out = torch.from_numpy(np.ascontiguousarray(arr))
        return out.to(device=leaf_t.device, dtype=leaf_t.dtype)
    if isinstance(leaf_t, int):
        return int(arr)
    return arr.astype(np.asarray(leaf_t).dtype)


def _rebuild(tree: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    if tree is None:
        return None
    if _is_leaf(tree):
        return leaves[prefix]
    rebuilt = {key: _rebuild(child, leaves, f"{prefix}/{key}" if prefix else key)
               for key, child in _children(tree)}
    if isinstance(tree, dict):
        return {k: rebuilt[str(k)] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(rebuilt[f] for f in tree._fields))
    return type(tree)(rebuilt[str(i)] for i in range(len(tree)))


def load_pytree(path: str, template: Any) -> Any:
    """Restore into the structure of ``template`` (shape-checked): tensor
    leaves come back as tensors of the template leaf's dtype on its
    device, ndarray leaves in its dtype, int leaves as ints."""
    with open(os.path.join(path, MANIFEST_FILE), "rb") as f:
        manifest = unpackb(f.read())
    data = load_arrays(path)
    flat_t = list(_walk(template))
    if len(flat_t) != len(manifest["keys"]):
        raise ValueError(
            f"checkpoint has {len(manifest['keys'])} leaves, template {len(flat_t)}"
        )
    leaves = {}
    for key, leaf_t in flat_t:
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        leaves[key] = _restore_leaf(key, data[key], leaf_t)
    return _rebuild(template, leaves)


def save_train_state(ckpt_dir: str, step: int, state: Any) -> str:
    """Write ``state`` to ``ckpt_dir/step_XXXXXXXX`` and point ``latest``
    at it. Returns the step directory."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    save_pytree(path, state)
    with open(os.path.join(ckpt_dir, LATEST_FILE), "w") as f:
        f.write(os.path.basename(path))
    return path


def latest_step(ckpt_dir: str) -> str | None:
    """The directory ``latest`` points at, or None before the first save."""
    p = os.path.join(ckpt_dir, LATEST_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return os.path.join(ckpt_dir, f.read().strip())


def load_train_state(ckpt_dir: str, template: Any) -> Any | None:
    """The latest saved state in the structure of ``template``, or None."""
    path = latest_step(ckpt_dir)
    return None if path is None else load_pytree(path, template)
