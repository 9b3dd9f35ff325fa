"""qwen3-moe-30b-a3b [moe] — 128 routed experts, top-8, qk-norm GQA.

48L d_model=2048 32H (GQA kv=4, head_dim 128) expert d_ff=768
vocab=151936. No shared experts. [hf:Qwen/Qwen3-30B-A3B]
"""
import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        d_expert=768,
        num_shared=0,
        capacity_factor=1.25,
    ),
    citation="hf:Qwen/Qwen3-30B-A3B",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="qwen3-moe-30b-a3b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=64,
        vocab_size=512,
        dtype="float32",
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, num_shared=0, capacity_factor=1.25),
    ).validate()
