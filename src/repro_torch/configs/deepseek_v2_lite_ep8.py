"""deepseek-v2-lite-ep8 — DeepSeek-V2-Lite as ONE chip of an 8-way
expert-parallel deployment (port-only).

Eight chips share every layer: each holds 8 of the 64 routed experts of
each MoE layer and 1/8 of the vocabulary, and they are data-parallel over
the same 8. This chip holds experts 0-7 and vocabulary ids 0-12,799: the
router keeps its 64 outputs and its top-6, the layer computes its 8
experts' part of the result (dropless) and the shared experts, and the
logits and the loss are over the slice. Every width and all 27 layers are
the published model's (``deepseek_v2_lite.FULL``): 2,744 M parameters.
"""
import dataclasses

from repro_torch.configs import deepseek_v2_lite as base

CHIPS = 8  # chips that share each layer

FULL = dataclasses.replace(
    base.FULL,
    name="deepseek-v2-lite-ep8",
    vocab_size=base.FULL.vocab_size // CHIPS,
    moe=dataclasses.replace(base.MOE, experts_first=0,
                            experts_held=base.MOE.num_experts // CHIPS),
).validate()


def smoke():
    """``deepseek_v2_lite.smoke()`` cut the same way: 8 of its 64 experts,
    1/8 of its vocabulary."""
    cfg = base.smoke()
    return dataclasses.replace(
        cfg, name="deepseek-v2-lite-ep8-smoke", vocab_size=cfg.vocab_size // CHIPS,
        moe=dataclasses.replace(cfg.moe, experts_first=0,
                                experts_held=cfg.moe.num_experts // CHIPS)).validate()
