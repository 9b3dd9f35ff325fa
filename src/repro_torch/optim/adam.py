"""Adam on nested NamedTuples of tensors (PyTorch).

Port of the Adam half of ``repro.optim.adam`` (the paper optimizes the
variational parameters phi_j with Adam, Kingma & Ba 2014). The update is
the JAX package's formula written out,

    mu  = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2
    p  <- p - lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

with the bias corrections computed on the device in float32 from the step
count, as JAX computes them (``1 - b1**t``); it is not
``torch.optim.Adam``, whose rounding differs. The step counter is a host
integer or an int64 tensor of shape () on the params' device (what a CUDA
graph of the training step advances in place); either way the update
reads nothing back from the device, and the two give the same bits. The
state is a pytree shaped like the params, so it carries the P cell axis
with them.
AdamW and gradient clipping serve the LM substrate and are not ported yet.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leaf-wise over NamedTuples / tuples / lists of tensors
    with the same structure (``jax.tree.map`` for the port's param trees)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    children = [tree_map(fn, *leaves) for leaves in zip(tree, *rest, strict=True)]
    return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)


def tree_leaves(tree: PyTree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in :func:`tree_map`'s order."""
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


class AdamState(NamedTuple):
    step: int | torch.Tensor  # updates applied so far (int, or int64 () on the device)
    mu: PyTree  # first moment (None on an artifact loaded from disk)
    nu: PyTree  # second moment


def adam_init(params: PyTree) -> AdamState:
    return AdamState(step=0, mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params))


def adam_update(
    params: PyTree,
    grads: PyTree,
    state: AdamState,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[PyTree, AdamState]:
    """One Adam step minimizing the loss whose gradient is ``grads``."""
    step = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g), state.nu, grads)
    if isinstance(step, torch.Tensor):
        t = step.to(torch.float32)
    else:
        t = torch.full((), float(step), dtype=torch.float32, device=tree_leaves(params)[0].device)
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t

    def upd(p, m, v):
        return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)

    return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu, nu=nu)
