"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (no separate FFN, d_ff=0).

24L d_model=1024 4H vocab=50304; blocks own their up/down projections
(rnn_width = 2 x d_model). Pattern: 5 mLSTM : 1 sLSTM (the paper's
mLSTM-heavy ratio for this scale). [arXiv:2405.04517]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mlp_kind="none",
    pos_kind="none",
    rnn_width=2048,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    citation="arXiv:2405.04517",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="xlstm-350m-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        rnn_width=256,
        vocab_size=512,
        dtype="float32",
        block_pattern=("mlstm", "slstm"),
    ).validate()
