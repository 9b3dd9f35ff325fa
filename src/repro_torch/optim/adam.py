"""Adam / AdamW on nested dicts, NamedTuples and sequences of tensors.

Port of ``repro.optim.adam`` (the paper optimizes the variational
parameters phi_j with Adam, Kingma & Ba 2014; the LM substrate uses
AdamW). The Adam update is
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
with them. On CUDA :func:`adam_update` is ONE launch of the Adam kernel
(``kernels/adam.py``) over every leaf, bitwise the plain formula
(:func:`plain_adam_update`), which the CPU runs (``kernels.ops.on_cuda``).
:func:`adamw_update` adds JAX's decoupled decay on every leaf, and
:func:`clip_by_global_norm` scales by a device scalar (no host sync);
:func:`adamw_update_` and :func:`clip_by_global_norm_` are the two in
place, bitwise theirs (the LM step's in-place path, which keeps no second
copy of the parameters, gradients and moments).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.kernels import adam as adam_kernel
from repro_torch.kernels import ops

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leaf-wise over dicts / NamedTuples / tuples / lists of
    tensors with the same structure (``jax.tree.map`` for the port's param
    trees). Dicts are visited in sorted key order, as JAX flattens them."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        keys = sorted(tree)
        for other in rest:
            if sorted(other) != keys:
                raise ValueError(f"tree_map: dict keys {sorted(other)} != {keys}")
        return {k: tree_map(fn, tree[k], *(other[k] for other in rest)) for k in keys}
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
    *,
    out: tuple | None = None,
) -> tuple[PyTree, AdamState]:
    """One Adam step minimizing the loss whose gradient is ``grads``:
    (new params, new state). ``out``, a (params, AdamState) tree shaped
    like the return with an int64 () step counter, receives the update in
    place and is returned; it may be the input itself, but is written only
    once nothing reads the inputs any more. Without it the inputs are left
    as they are and the result is new tensors.

    A CUDA tree is ONE launch of the kernel (``kernels/adam.py``), bitwise
    the plain formula; a CPU tree runs the plain formula
    (:func:`plain_adam_update`); any other device raises. The tensors'
    device decides, by ``kernels.ops.on_cuda``."""
    if not ops.on_cuda(tree_leaves(params)[0]):
        return plain_adam_update(params, grads, state, lr, b1, b2, eps, out=out)
    new = out if out is not None else _uninitialized_result(params, state)
    step_out = new[1].step
    if out is None and not isinstance(step_out, torch.Tensor):
        step_out = None  # a host counter, advanced in ``new`` already: the kernel writes none
    adam_kernel.adam_update(
        *(tree_leaves(t) for t in (params, grads, state.mu, state.nu, new[0], new[1].mu,
                                   new[1].nu)),
        state.step, step_out, lr=lr, b1=b1, b2=b2, eps=eps)
    return new


def _uninitialized_result(params, state: AdamState) -> tuple:
    """Tensors shaped like :func:`adam_update`'s result for the kernel to
    fill; a host counter already advanced."""
    def like(t):
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)

    step = torch.empty_like(state.step) if isinstance(state.step, torch.Tensor) else state.step + 1
    return (tree_map(like, params),
            AdamState(step, tree_map(like, state.mu), tree_map(like, state.nu)))


def plain_adam_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, *,
                      out=None) -> tuple:
    """:func:`adam_update` as plain PyTorch on any device: the CPU lane,
    and the reference the kernel is held to bitwise on the card."""
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

    new = (tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu, nu=nu))
    if out is None:
        return new
    tree_map(lambda dst, src: dst.copy_(torch.as_tensor(src)), out, new)
    return out


def adamw_update(
    params: PyTree,
    grads: PyTree,
    state: AdamState,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[PyTree, AdamState]:
    """AdamW (decoupled weight decay on every leaf) for the LM substrate."""
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
        return p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p)

    return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu, nu=nu)


INPLACE_CHUNK = 1 << 26  # elements a piece of the in-place update (its temporaries' size)


def adamw_update_(
    params: PyTree,
    grads: PyTree,
    state: AdamState,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[PyTree, AdamState]:
    """:func:`adamw_update` in place: ``params``, ``state.mu`` and
    ``state.nu`` are written (and returned, the moments in a new
    ``AdamState`` with the step advanced); ``grads`` is read only. The
    formula is :func:`adamw_update`'s in its op order, element by element,
    so the result is its bits (on the CPU and on the card alike); the
    leaves go in pieces of ``INPLACE_CHUNK`` elements, so the temporaries
    stay that small whatever the leaf. Every leaf of ``params`` and the
    moments must be contiguous."""
    step = state.step + 1
    if isinstance(step, torch.Tensor):
        t = step.to(torch.float32)
    else:
        t = torch.full((), float(step), dtype=torch.float32, device=tree_leaves(params)[0].device)
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t
    for p, g, m, v in zip(*(tree_leaves(x) for x in (params, grads, state.mu, state.nu)),
                          strict=True):
        for pc, mc, vc, gc in zip(*(a.view(-1).split(INPLACE_CHUNK) for a in (p, m, v)),
                                  g.reshape(-1).split(INPLACE_CHUNK), strict=True):
            mc.mul_(b1).add_((1 - b1) * gc)
            vc.mul_(b2).add_((1 - b2) * (gc * gc))
            den = torch.sqrt(vc / bc2).add_(eps)
            upd = torch.div(mc, bc1).div_(den).add_(weight_decay * pc)
            pc.sub_(upd.mul_(lr))
    return params, AdamState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves
    added in :func:`tree_leaves`'s order from 0, as JAX's Python ``sum``."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Scale every leaf by min(1, max_norm / (norm + 1e-12)), a () tensor on
    the device: nothing is read back to the host."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def clip_by_global_norm_(grads: PyTree, max_norm: float) -> PyTree:
    """:func:`clip_by_global_norm` in place (the same bits): every leaf of
    ``grads`` scaled where it is, and ``grads`` returned."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads
