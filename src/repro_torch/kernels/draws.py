"""Wrapper of the hand-written CUDA draws kernel (``csrc/draws.cu``).

ONE launch draws a training step's mini-batches for every cell: the source
cell k'_p of eq. (9) by Gumbel-max over the cell's slot probabilities, and
the B rows of that source with the highest masked uniform scores. It
replaces no Pallas kernel (the JAX package draws with ``jax.random`` in
plain jnp); on the port's CUDA step it takes the place of the plain
composition's 67 device ops (``ref.minibatch_draws``: ``StepDraws``,
``sample_slots``, ``mask[kprime]``, the masked uniform scores). Its numbers
are those uniforms, bit for bit, and its rows are ranked as the composition
ranks them (the higher score first, then the lower index where scores
tie). ``ops.minibatch_draws`` sends CUDA tensors here and CPU tensors to
``ref.minibatch_draws``, the plain twin.

The wrapper checks shapes, device, dtype and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if the
launch failed, and adds one to :data:`LAUNCHES`. It takes CUDA tensors
only.
"""
from __future__ import annotations

import torch

from repro_torch.core.neighbors import NUM_SLOTS
from repro_torch.core.sampler import stream_seed
from repro_torch.kernels import build, launches

# csrc/draws.cu's kFastMaxRow: a longer row takes the streaming body, which
# needs a (P, B) scratch
MAX_FAST_ROW = 512

LAUNCHES = launches.counter({"minibatch_draws": 0})


def minibatch_draws(probs, neighbor_tbl, mask, batch: int, seed: int,
                    step) -> tuple[torch.Tensor, torch.Tensor]:
    """Step ``step``'s draws of seed ``seed`` in one launch: probs (P, 5)
    float32 slot probabilities, neighbor_tbl (P, 5) int64 (-1 where a slot
    has no cell), mask (P, n_max) float32 -> (kprime (P,), idx (P, B)) int64,
    ``ref.minibatch_draws`` bit for bit. ``step`` is an int64 () tensor on
    the device, read there (a captured launch draws the step of its replay),
    or a host int. Needs 1 <= batch <= n_max, as ``torch.topk`` does."""
    if not isinstance(mask, torch.Tensor) or mask.dim() != 2:
        raise ValueError("mask must be a (P, n_max) tensor")
    P, n_max = mask.shape
    if P < 1 or not 1 <= batch <= n_max:
        raise ValueError(f"need P >= 1 and 1 <= batch <= n_max, got P {P}, batch {batch}, "
                         f"n_max {n_max}")
    device = mask.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA draws kernel takes CUDA tensors, got {device}; CPU tensors "
                         "go to the plain twin in repro_torch.kernels.ref")
    build.check_tensor("probs", probs, (P, NUM_SLOTS), device)
    build.check_tensor("neighbor_tbl", neighbor_tbl, (P, NUM_SLOTS), device, torch.int64)
    build.check_tensor("mask", mask, (P, n_max), device)
    step_in, step_host = build.counter_arg("step", step, device, out=False)
    kprime = torch.empty((P,), dtype=torch.int64, device=device)
    idx = torch.empty((P, batch), dtype=torch.int64, device=device)
    keys = (torch.empty((P, batch), dtype=torch.int64, device=device)
            if n_max > MAX_FAST_ROW else None)
    rc = build.library().psvgp_minibatch_draws(
        probs.data_ptr(), neighbor_tbl.data_ptr(), mask.data_ptr(), kprime.data_ptr(),
        idx.data_ptr(), 0 if keys is None else keys.data_ptr(), step_in, step_host,
        stream_seed(seed, "step"), P, n_max, batch, build.device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"draws kernel launch failed: cudaError {rc}")
    LAUNCHES["minibatch_draws"] += 1
    return kprime, idx
