"""whisper-base [audio] — encoder-decoder; conv/mel frontend STUBBED.

6L (x2: 6 encoder + 6 decoder) d_model=512 8H d_ff=2048 vocab=51865,
GeLU MLPs, learned positions, cross-attention from decoder to the 1500
stub frame embeddings. Whisper's real decoder context is 448; we keep a
4096-entry learned table (positions beyond it clamp) so the assigned
train_4k shape lowers — noted deviation. [arXiv:2212.04356]
"""
import dataclasses

from repro_torch.models.config import EncoderConfig, ModelConfig

FULL = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,  # decoder layers; encoder carries its own 6 below
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    mlp_kind="gelu",
    pos_kind="learned",
    max_position=4096,
    encoder=EncoderConfig(num_layers=6, num_frames=1500, frontend_dim=512),
    citation="arXiv:2212.04356",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="whisper-base-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        max_position=256,
        dtype="float32",
        encoder=EncoderConfig(num_layers=2, num_frames=20, frontend_dim=64),
    ).validate()
