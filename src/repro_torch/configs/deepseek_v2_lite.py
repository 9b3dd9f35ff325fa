"""deepseek-v2-lite [moe] — MLA without q LoRA, YaRN RoPE, 2 shared + 64
routed top-6 experts with unnormalised gates (port-only: the JAX package
has no such config).

27L d_model=2048 16H vocab=102400; MLA kv_lora=512 (q projected directly,
no q LoRA), qk_nope=128 qk_rope=64 v_head=128; RoPE theta 10,000 with
YaRN (factor 40, original 4,096 positions, beta 32/1, mscale =
mscale_all_dim = 0.707); layer 0 dense (d_ff 10,944, first_k_dense_replace
1), the other 26 MoE: 64 routed experts of width 1,408, top-6 by softmax,
greedy, gates not renormalised (routed_scaling_factor 1), the balance loss
sequence-wise (seq_aux), 2 shared experts; SiLU, RMSNorm eps 1e-6,
untied head. The balance loss weight (aux_loss_alpha) 0.001 is assumed.
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434]
"""
import dataclasses

from repro_torch.models.config import HeldMoEConfig, MLAConfig, ScaledRopeModelConfig, YaRNConfig

MOE = HeldMoEConfig(
    num_experts=64,
    top_k=6,
    d_expert=1408,
    num_shared=2,
    router_aux_weight=0.001,
    first_layer_dense=True,
    dense_d_ff=10944,
    norm_topk_prob=False,
    routed_scaling_factor=1.0,
    seq_aux=True,
    router_fp32=True,
    dropless=True,
)

FULL = ScaledRopeModelConfig(
    name="deepseek-v2-lite",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    block_pattern=("mla",),
    rope_theta=10000.0,
    norm_eps=1e-6,
    moe=MOE,
    mla=MLAConfig(
        q_lora_rank=0,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    rope_scaling=YaRNConfig(factor=40.0, original_max_position=4096, beta_fast=32.0,
                            beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
    rope_interleave=True,
    attn_sdpa=True,
    citation="hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434",
).validate()


def smoke() -> ScaledRopeModelConfig:
    """The same shape at a CPU size: a dense layer and two MoE layers, 64
    routed experts top-6 and 2 shared at width 32, YaRN over 8 rope dims
    (its ramp from dim 1 to 3), float32."""
    return dataclasses.replace(
        FULL,
        name="deepseek-v2-lite-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=32,
        vocab_size=2048,
        dtype="float32",
        moe=dataclasses.replace(MOE, d_expert=32, dense_d_ff=128),
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
    ).validate()
