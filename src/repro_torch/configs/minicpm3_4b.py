"""minicpm3-4b [dense] — Multi-head Latent Attention (MLA).

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA q_lora=768 kv_lora=256,
qk_nope=64 qk_rope=32 v_head=64 (per the HF config). The decode cache
stores compressed latents — natively long-context, so long_500k runs the
REAL architecture (no SWA variant needed). [hf:openbmb/MiniCPM3-4B]
"""
import dataclasses

from repro_torch.models.config import MLAConfig, ModelConfig

FULL = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    block_pattern=("mla",),
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    citation="hf:openbmb/MiniCPM3-4B",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="minicpm3-4b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        mla=MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        ),
    ).validate()
