"""Assigned input shapes and their descriptors for the dry-run.

Copy of ``repro.configs.shapes``: the four assigned (seq_len,
global_batch) shapes. ``train_*`` traces the train step, ``prefill_*`` the
prefill step, ``decode_*``/``long_*`` the decode step (ONE new token
against a seq_len cache). :func:`input_specs` gives each input's
:class:`InputSpec` (shape, torch dtype), as JAX's gives a
``ShapeDtypeStruct``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig


class InputShape(NamedTuple):
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


class InputSpec(NamedTuple):
    """An input's shape and dtype, without data."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape(4_096, 256, "train"),
    "prefill_32k": InputShape(32_768, 32, "prefill"),
    "decode_32k": InputShape(32_768, 128, "decode"),
    "long_500k": InputShape(524_288, 1, "decode"),
}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, InputSpec]:
    """Data-side inputs as descriptors (no allocation).

    For decode kinds this is the single-token input; the cache is built
    separately (``transformer.init_cache``) by the dry-run.
    """
    return input_specs_for(cfg, INPUT_SHAPES[shape_name])


def input_specs_for(cfg: ModelConfig, sh: InputShape) -> dict[str, InputSpec]:
    """:func:`input_specs` of an :class:`InputShape` (the dry-run's shorter
    sequences for extrapolation)."""
    B = sh.global_batch
    i32 = torch.int32
    f32 = torch.float32

    if sh.kind == "decode":
        return {"tokens": InputSpec((B, 1), i32)}

    S = sh.seq_len
    specs = {}
    if cfg.vision is not None:
        P = cfg.vision.num_patches
        specs["tokens"] = InputSpec((B, S - P), i32)
        specs["patches"] = InputSpec((B, P, cfg.vision.vit_dim), f32)
        tgt = S - P
    else:
        specs["tokens"] = InputSpec((B, S), i32)
        tgt = S
    if cfg.encoder is not None:
        e = cfg.encoder
        specs["frames"] = InputSpec((B, e.num_frames, e.frontend_dim), f32)
    if sh.kind == "train":
        specs["targets"] = InputSpec((B, tgt), i32)
    return specs
