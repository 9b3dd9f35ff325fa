"""Architecture registry: ``get(arch_id)`` -> (full config, smoke config).

Copy of ``repro.configs.registry`` over the port's copies of the ten
architecture files; the port builds, serves and trains all ten, and the
port-only ones of ``PORT_ARCH_IDS``.

Every assigned architecture is a module exposing ``FULL`` (the exact
published configuration, citation included) and ``smoke()`` (a reduced
same-family variant: <=2 pattern repeats, d_model<=512, <=4 experts, tiny
vocab — runnable on one CPU in a test).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS: list[str] = [
    "deepseek_moe_16b",
    "internvl2_76b",
    "qwen2_0_5b",
    "minicpm3_4b",
    "qwen3_0_6b",
    "whisper_base",
    "xlstm_350m",
    "recurrentgemma_2b",
    "qwen3_moe_30b_a3b",
    "h2o_danube_3_4b",
]

# Port-only architectures (the JAX package has none of them), which get()
# and get_smoke() resolve as they do ARCH_IDS.
PORT_ARCH_IDS: list[str] = [
    "deepseek_v2_lite",
    "deepseek_v2_lite_ep8",  # one chip of its 8-way expert-parallel deployment
]


# external (dashed) ids <-> module names
def canon(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch_id)}")
    return mod.FULL


def get_smoke(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch_id)}")
    return mod.smoke()


def swa_variant(cfg: ModelConfig, window: int = 4096) -> ModelConfig:
    """Sliding-window variant for long_500k decode of quadratic-attention
    archs (explicitly permitted by the assignment; recorded in DESIGN.md §5).
    MLA keeps its native compressed cache (that IS its long-context form)."""
    if cfg.is_subquadratic() or "mla" in cfg.block_pattern:
        return cfg
    pattern = tuple("local_attn" if b == "attn" else b for b in cfg.block_pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "+swa",
        block_pattern=pattern,
        sliding_window=cfg.sliding_window or window,
    )
