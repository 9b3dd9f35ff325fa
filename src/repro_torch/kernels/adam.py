"""Wrapper of the hand-written CUDA Adam kernel (``csrc/adam.cu``).

ONE launch applies ``optim.adam``'s Adam formula to every leaf of a
parameter tree, bitwise the plain formula on the card, and advances Adam's
step counter with it. It replaces no Pallas kernel (the JAX package leaves
Adam to XLA); on the port's CUDA step it takes the place of the plain
formula's ~90 elementwise launches, and, since it writes the destination
it is given, of the captured step's copy of the new state into its
buffers.

The wrapper takes flat lists of leaves and CUDA tensors only (the trees
and the CPU lane are ``optim/adam.py``'s). It checks device, dtype and
shapes, copies an input that is not contiguous and refuses a destination
that is not, launches on the current stream, raises if the launch failed,
and adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches

MAX_LEAVES = 32  # csrc/adam.cu's kMaxLeaves: the leaves go by value in the launch

LAUNCHES = launches.counter({"adam_update": 0})


def adam_update(p, g, m, v, p_out, m_out, v_out, step, step_out, *, lr: float, b1: float,
                b2: float, eps: float) -> None:
    """One launch: for every leaf i, from p[i] (params), g[i] (grads), m[i]
    and v[i] (moments), write the updated params, mu and nu into p_out[i],
    m_out[i], v_out[i] (float32 CUDA tensors of the leaf's shape; each may
    be its input, and otherwise overlaps no input), and step + 1 into
    ``step_out``. ``step`` is an int64 () tensor on the device or a host
    int (frozen into a captured graph); ``step_out`` an int64 () tensor on
    the device (``step`` itself allowed), or None (a host counter: the
    caller adds the one)."""
    n = len(p)
    if not 1 <= n <= MAX_LEAVES or not n == len(g) == len(m) == len(v) == len(p_out) == \
            len(m_out) == len(v_out):
        raise ValueError(f"need 1 to {MAX_LEAVES} leaves, as many of each; got "
                         f"{[len(x) for x in (p, g, m, v, p_out, m_out, v_out)]}")
    device = p[0].device if isinstance(p[0], torch.Tensor) else None
    if device is None or device.type != "cuda":
        raise ValueError(f"the CUDA Adam kernel takes CUDA tensors, got {device}; CPU trees go "
                         "to the plain formula in repro_torch.optim.adam")
    ptrs, sizes, keep = [], [], []
    for i in range(n):
        shape = p[i].shape if isinstance(p[i], torch.Tensor) else ()
        ins = [t.contiguous() if isinstance(t, torch.Tensor) else t  # a copy where not
               for t in (p[i], g[i], m[i], v[i])]
        leaf = (*ins, p_out[i], m_out[i], v_out[i])
        for name, t in zip(("p", "g", "m", "v", "p_out", "m_out", "v_out"), leaf, strict=True):
            build.check_tensor(f"{name}[{i}]", t, shape, device)
        keep += ins
        ptrs += [t.data_ptr() for t in leaf]
        sizes.append(p[i].numel())
    step_in, step_host = build.counter_arg("step", step, device, out=False)
    step_dst, _ = build.counter_arg("step_out", step_out, device, out=True)
    rc = build.library().psvgp_adam_update(
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * n)(*sizes), n,
        b1, 1 - b1, b2, 1 - b2, lr, eps, step_in, step_dst, step_host,
        build.device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    del keep  # held the copies until the launch was queued (their frees are stream-ordered)
    if rc != 0:
        raise RuntimeError(f"Adam kernel launch failed: cudaError {rc}")
    LAUNCHES["adam_update"] += 1
