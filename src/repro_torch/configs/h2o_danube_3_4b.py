"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, window 4096.
Natively sub-quadratic at decode (SWA ring cache) -> long_500k runs as-is.
[arXiv:2401.16818]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    block_pattern=("local_attn",),
    citation="arXiv:2401.16818",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="h2o-danube-3-4b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        sliding_window=16,
        dtype="float32",
    ).validate()
