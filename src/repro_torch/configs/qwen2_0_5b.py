"""qwen2-0.5b [dense] — GQA with QKV bias, tied embeddings.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936. [arXiv:2407.10671]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    citation="arXiv:2407.10671",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="qwen2-0.5b-smoke",
        num_layers=2,
        d_model=112,  # keeps 14 heads x head_dim 8
        num_heads=14,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    ).validate()
