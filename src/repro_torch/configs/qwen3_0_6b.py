"""qwen3-0.6b [dense] — qk-norm GQA, explicit head_dim=128, tied embeddings.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. [hf:Qwen/Qwen3-8B]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    citation="hf:Qwen/Qwen3-8B",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="qwen3-0.6b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    ).validate()
