"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048,
rnn_width 2560. Pattern (rglru, rglru, local_attn) x 8 + 2 trailing rglru
(the remainder layers). Natively sub-quadratic -> long_500k runs as-is.
[arXiv:2402.19427]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    sliding_window=2048,
    rnn_width=2560,
    conv_width=4,
    block_pattern=("rglru", "rglru", "local_attn"),
    citation="arXiv:2402.19427",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="recurrentgemma-2b-smoke",
        num_layers=4,  # one full period + 1 remainder rglru
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        d_ff=256,
        vocab_size=512,
        sliding_window=16,
        rnn_width=128,
        dtype="float32",
    ).validate()
