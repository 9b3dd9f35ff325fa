"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed top-6.

28L d_model=2048 16H (MHA, kv=16) d_ff=1408(expert) vocab=102400.
Layer 0 keeps a dense FFN (d_ff 10944), per the paper. [arXiv:2401.06066]
"""
import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared=2,
        capacity_factor=1.25,
        first_layer_dense=True,
        dense_d_ff=10944,
    ),
    citation="arXiv:2401.06066",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="deepseek-moe-16b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=512,
        dtype="float32",
        moe=MoEConfig(
            num_experts=4, top_k=2, d_expert=64, num_shared=2,
            capacity_factor=1.25, first_layer_dense=True, dense_d_ff=256,
        ),
    ).validate()
