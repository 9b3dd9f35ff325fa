"""Model configuration for the assigned-architecture fleet.

Copy of ``repro.models.config`` (pure dataclasses), field for field.

One frozen dataclass describes every architecture family the framework
supports (dense / MoE / MLA / SSM / hybrid / enc-dec / VLM). Hashable so it
can ride in jit static args; every config file in ``repro.configs`` builds
exactly one of these (plus a reduced smoke variant).

Layer composition uses ``block_pattern``: the temporal-mixing kind of each
layer, cycled (e.g. RecurrentGemma's ("rglru", "rglru", "local_attn")).
The model scans over whole pattern periods with stacked params — HLO size
stays O(period), not O(num_layers) (DESIGN.md §5; essential for lowering
the 80-layer configs with 512 virtual devices on one CPU).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    num_shared: int = 0  # always-on shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight
    first_layer_dense: bool = False  # DeepSeekMoE: layer 0 keeps a dense FFN
    dense_d_ff: int = 0  # d_ff of that dense layer
    dispatch_groups: int = 32  # GShard-style rank/capacity groups, aligned
    # with the data shards so dispatch ranks never cross devices (§Perf)

    def __post_init__(self) -> None:
        if self.num_experts <= 0 or self.d_expert <= 0:
            raise ValueError("num_experts and d_expert must be positive")
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError(f"top_k={self.top_k} outside [1, {self.num_experts}]")
        if self.num_shared < 0 or self.capacity_factor <= 0 or self.dispatch_groups <= 0:
            raise ValueError("num_shared >= 0, capacity_factor/dispatch_groups > 0")
        if self.first_layer_dense and self.dense_d_ff <= 0:
            raise ValueError("first_layer_dense requires dense_d_ff > 0")

    # The port-only settings of :class:`HeldMoEConfig`, at the behaviour
    # every JAX config has. Class attributes, not fields, so that a
    # config's ``dataclasses.asdict`` stays JAX's field for field.
    norm_topk_prob = True
    routed_scaling_factor = 1.0
    seq_aux = False
    router_fp32 = False
    dropless = False
    experts_first = 0
    experts_held = 0

    @property
    def held(self) -> int:
        """How many experts this process holds (all of them unless
        ``experts_held`` says fewer)."""
        return self.experts_held or self.num_experts


@dataclasses.dataclass(frozen=True)
class HeldMoEConfig(MoEConfig):
    """DeepSeek-V2's expert layer, as one chip of an expert-parallel
    deployment holds it (port-only; JAX has no such config).

    ``norm_topk_prob``: renormalise the top-k gates to sum to 1 (False:
    the raw softmax probabilities, times ``routed_scaling_factor``).
    ``seq_aux``: the balance loss sequence by sequence, DeepSeek-V2's
    ``seq_aux`` (``moe.route``), in place of the Switch form over the
    batch. ``router_fp32``: the router's product in float32, as the
    published code computes it. ``dropless``: every assignment to a held
    expert is computed (no capacity). ``experts_first``/``experts_held``:
    this process holds experts [first, first + held) of ``num_experts``;
    the router still scores all of them."""

    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    seq_aux: bool = False
    router_fp32: bool = False
    dropless: bool = False
    experts_first: int = 0
    experts_held: int = 0

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.experts_held < 0 or self.experts_first < 0 or \
                self.experts_first + self.held > self.num_experts:
            raise ValueError(f"held experts [{self.experts_first}, "
                             f"{self.experts_first + self.held}) outside [0, {self.num_experts})")
        if self.held != self.num_experts and not self.dropless:
            raise ValueError("a share of the experts is computed by the dropless path only")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    def __post_init__(self) -> None:
        if self.q_lora_rank < 0 or self.kv_lora_rank <= 0:
            raise ValueError("q_lora_rank >= 0 and kv_lora_rank > 0 required")
        if min(self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim) <= 0:
            raise ValueError("MLA head dims must be positive")


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN's RoPE scaling (Peng et al. 2023, arXiv:2309.00071), as
    DeepSeek-V2's ``rope_scaling`` states it (``type`` "yarn")."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    def __post_init__(self) -> None:
        if self.factor <= 0 or self.original_max_position <= 0:
            raise ValueError("YaRN needs factor > 0 and original_max_position > 0")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The modality frontend is
    a stub per the assignment: inputs arrive as precomputed frame embeddings."""

    num_layers: int
    num_frames: int  # encoder sequence length (whisper-base: 1500)
    frontend_dim: int  # embedding dim delivered by the stubbed conv frontend

    def __post_init__(self) -> None:
        if min(self.num_layers, self.num_frames, self.frontend_dim) <= 0:
            raise ValueError("encoder dims must be positive")


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub: precomputed ViT patch embeddings + MLP projector."""

    num_patches: int  # patches prepended per sample
    vit_dim: int  # patch embedding dim delivered by the stubbed ViT

    def __post_init__(self) -> None:
        if self.num_patches <= 0 or self.vit_dim <= 0:
            raise ValueError("vision stub dims must be positive")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- layer composition ---
    block_pattern: tuple[str, ...] = ("attn",)
    # block kinds: attn | local_attn | mla | mlstm | slstm | rglru
    mlp_kind: str = "swiglu"  # swiglu | gelu | none (ssm blocks own their mlp)
    # --- attention options ---
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0  # window for local_attn blocks (0 = unset)
    attn_q_chunk: int = 0  # query-chunked attention at train/prefill (0=off):
    # serializes the (.., S, S) logits to (.., chunk, S) via lax.map +
    # per-chunk remat — the memory lever when heads cannot shard (§Perf)
    rope_theta: float = 10000.0
    pos_kind: str = "rope"  # rope | learned | none
    max_position: int = 0  # for learned positions (0 = unused)
    # --- recurrent options ---
    rnn_width: int = 0  # RG-LRU / xLSTM inner width (0 -> d_model)
    conv_width: int = 4  # temporal conv in recurrent blocks
    # --- sub-configs ---
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    encoder: EncoderConfig | None = None
    vision: VisionStubConfig | None = None
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"  # activation dtype (params stay fp32)
    remat: bool = True  # activation checkpointing over pattern periods
    unroll: bool = False  # python-loop periods instead of lax.scan (used by
    # the dry-run's reduced-depth cost measurements: XLA cost_analysis
    # counts a while body once, unrolled bodies are counted per period)
    citation: str = ""

    def __post_init__(self) -> None:
        # construction-time validation (RR004): the full cross-field check
        # lives in validate(); calling it here means an illegal combination
        # can never travel past the constructor.
        self.validate()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 so embeddings/logits shard on
        any mesh axis (measured: minicpm3's 73448 vocab left an UNSHARDED
        17.9 GiB fp32 logits buffer per device — EXPERIMENTS.md §Perf).
        Padded slots are masked to -inf in the logits; targets never
        reference them."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def remainder_pattern(self) -> tuple[str, ...]:
        return self.block_pattern[: self.num_layers % self.period]

    def validate(self) -> "ModelConfig":
        assert self.arch_type in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"), self.arch_type
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, "GQA group size"
        for b in self.block_pattern:
            assert b in ("attn", "local_attn", "mla", "mlstm", "slstm", "rglru"), b
        if "mla" in self.block_pattern:
            assert self.mla is not None
        if "local_attn" in self.block_pattern:
            assert self.sliding_window > 0
        if self.arch_type == "moe":
            assert self.moe is not None
        if self.arch_type == "audio":
            assert self.encoder is not None
        if self.arch_type == "vlm":
            assert self.vision is not None
        if self.pos_kind == "learned":
            assert self.max_position > 0
        return self

    # The port-only settings of :class:`ScaledRopeModelConfig`, at the
    # behaviour every JAX config has (class attributes, not fields).
    rope_scaling = None
    rope_interleave = False
    attn_sdpa = False

    def has_attention(self) -> bool:
        return any(b in ("attn", "local_attn", "mla") for b in self.block_pattern)

    def is_subquadratic(self) -> bool:
        """True if no block attends to unbounded context (long_500k eligible
        natively — SSM/hybrid/SWA archs)."""
        return not any(b in ("attn", "mla") for b in self.block_pattern)


@dataclasses.dataclass(frozen=True)
class ScaledRopeModelConfig(ModelConfig):
    """A model whose RoPE follows DeepSeek-V2 (port-only).

    ``rope_scaling``: YaRN's frequencies and softmax scale
    (``common.rope_angles``, ``attention.mla_softmax_scale``).
    ``rope_interleave``: the rope dims of q and k are read as DeepSeek-V2's
    published code reads them, adjacent pairs (``view(..., d/2,
    2).transpose(-1, -2)``) before rotate-half. ``attn_sdpa``: MLA's
    train-time attention core is ``torch.nn.functional.
    scaled_dot_product_attention`` (causal, the explicit scale), so no
    (S, S) logits are kept."""

    rope_scaling: YaRNConfig | None = None
    rope_interleave: bool = False
    attn_sdpa: bool = False

    def __post_init__(self) -> None:
        super().__post_init__()
        if (self.rope_scaling is not None or self.rope_interleave or self.attn_sdpa) and \
                "mla" not in self.block_pattern:
            raise ValueError("YaRN, interleaved rope pairs and the fused core are MLA's here")
