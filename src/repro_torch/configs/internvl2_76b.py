"""internvl2-76b [vlm] — InternViT frontend (STUB) + Llama-3-70B-class LLM.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The ViT/projector
frontend is stubbed per the assignment: input_specs delivers precomputed
patch embeddings (256 patches x 3200 = InternViT-6B width); the projector
MLP and the full language backbone are real. [arXiv:2404.16821]
"""
import dataclasses

from repro_torch.models.config import ModelConfig, VisionStubConfig

FULL = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,  # llama-3 base frequency
    vision=VisionStubConfig(num_patches=256, vit_dim=3200),
    citation="arXiv:2404.16821",
).validate()


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL,
        name="internvl2-76b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        dtype="float32",
        vision=VisionStubConfig(num_patches=8, vit_dim=96),
    ).validate()
