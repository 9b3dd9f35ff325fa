"""Counts of an LM training step's work from the shapes alone, whatever
implements it: the FLOPs of one step (``step_flops``), the held experts'
grouped products (``experts_flops``) and the in-place AdamW's bytes
(``adamw_bytes``). ``bench/entries/lm_train.py`` reports them in its
``shape``; the readers ``step_mfu``, ``moe_experts_roofline`` and
``adamw_roofline`` hold them to the peaks of ``counts.py``. Written out
term by term in ``PERF.md``.

``hf`` is a configuration as ``bench/configs/`` states it: the published
``config.json``'s keys, ``n_routed_experts`` the experts held here and
``deployment.router_experts`` the router's width.
"""
from __future__ import annotations

ADAMW_BYTES_PER_PARAM = 28  # read p, g, m, v and write p, m, v, float32
SWIGLU_PRODUCTS = 3  # gate, up, down


def mla_projection_macs(hf: dict) -> int:
    """A token's multiply-adds in one MLA layer's projections: q (no q
    LoRA), the latent, the rope key, the latent's keys and values, out."""
    D, H = hf["hidden_size"], hf["num_attention_heads"]
    r, dn, dr, dv = (hf["kv_lora_rank"], hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                     hf["v_head_dim"])
    assert not hf.get("q_lora_rank"), "the count is of MLA without q LoRA"
    return D * H * (dn + dr) + D * r + D * dr + r * H * dn + r * H * dv + H * dv * D


def forward_terms(hf: dict, seq_len: int) -> dict[str, int]:
    """FLOPs a token of the forward, by term, summed over the layers."""
    D, H, L = hf["hidden_size"], hf["num_attention_heads"], hf["num_hidden_layers"]
    dense = hf["first_k_dense_replace"]
    moe_layers = L - dense
    E = hf["deployment"]["router_experts"]
    K, n, Fe = hf["num_experts_per_tok"], hf["n_routed_experts"], hf["moe_intermediate_size"]
    qk = hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
    return {
        "mla_projections": L * 2 * mla_projection_macs(hf),
        # causal: a token attends (S + 1) / 2 positions on average, counted S / 2
        "attention": L * 2 * (seq_len // 2) * H * (qk + hf["v_head_dim"]),
        "router": moe_layers * 2 * D * E,
        "shared_experts": moe_layers * 2 * SWIGLU_PRODUCTS * D * hf["n_shared_experts"] * Fe,
        # K picks of E experts, n of them held: K n / E assignments a token on average
        "held_experts": moe_layers * K * n * 2 * SWIGLU_PRODUCTS * D * Fe // E,
        "dense_ffn": dense * 2 * SWIGLU_PRODUCTS * D * hf["intermediate_size"],
        "head": 2 * D * hf["vocab_size"],
    }


def step_flops(hf: dict, batch: int, seq_len: int) -> int:
    """One optimizer step: the forward and the backward at twice it, 3F a
    token, no recomputation counted."""
    return 3 * batch * seq_len * sum(forward_terms(hf, seq_len).values())


def experts_flops(assignments: int, hf_or_sizes: dict) -> int:
    """The held experts' grouped products for ``assignments`` (token,
    expert) pairs: three products of D x Fe each."""
    D = hf_or_sizes.get("hidden_size", hf_or_sizes.get("d_model"))
    Fe = hf_or_sizes.get("moe_intermediate_size", hf_or_sizes.get("d_expert"))
    return assignments * 2 * SWIGLU_PRODUCTS * D * Fe


def adamw_bytes(elements: int) -> int:
    return ADAMW_BYTES_PER_PARAM * elements
