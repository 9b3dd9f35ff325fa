"""The port's dense LM substrate against the JAX package's, on the CPU.

Same parameters in both packages (JAX's ``init_model_params`` carried
across with ``models.transformer.params_from_numpy``), same seeded numpy
tokens:

  * every config copy equals JAX's, field by field; all ten
    architectures build (parameters, cache, train state) and run a smoke
    forward; the MoE, MLA, xLSTM, VLM, RG-LRU and encoder-decoder smoke
    configs build, serve and take a training step;
  * ``forward`` equals JAX's for the dense test configs of
    ``tests/test_models.py`` (qk-norm + QKV bias, sliding window), the smoke
    configs of qwen3-0.6b, qwen2-0.5b and h2o-danube-3-4b, and a two-kind
    ("attn", "local_attn") pattern of 5 layers (a non-empty remainder and
    a padded vocab), in float32 and in bfloat16;
  * prefill and decode equal JAX's step for step (logits and caches), and
    the port's own uncached forward (one token, an 8-token chain, a ring
    cache decoding 10 tokens past an 8-slot window: mirrors of
    ``tests/test_models.py:89-140`` at the same atol);
  * ``attn_q_chunk`` equals the unchunked forward, values and gradients;
  * the parameter tree is JAX's (key paths, shapes, dtypes), drawn on the
    generator's device from JAX's distributions.

Tolerances: float32 |d logits| <= 5e-5 max(1, max|logits|) (the packages
sum matmuls in different orders: ~1e-6 relative seen); bfloat16 |d| <=
2**-5 max(1, max|logits|), eight bf16 units in the last place of the
largest logit (each package rounds every activation to bf16 after its own
float32 sums, and a flip early in the stack carries to the logits: ~2.5
units seen). Masked (padded-vocab) logits are -1e30 in both.

On the card (``cuda``-marked, skipped here): qwen3-0.6b at full width in
float32 against JAX's forward on the CPU, and decode against the uncached
forward.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import steps as jsteps
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.runtime import steps as tsteps

B, S = 2, 32
FP32_RTOL = 5e-5
BF16_RTOL = 2.0**-5

DENSE = {
    "dense-gqa": dict(qk_norm=True, qkv_bias=True),
    "dense-swa": dict(name="t-swa", sliding_window=16, block_pattern=("local_attn",)),
    "two-kind": dict(name="t-two", num_layers=5, sliding_window=8, vocab_size=500,
                     block_pattern=("attn", "local_attn"), tie_embeddings=True),
}
SMOKE = {"qwen3-smoke": "qwen3-0.6b", "qwen2-smoke": "qwen2-0.5b", "h2o-smoke": "h2o-danube-3-4b"}
NAMES = list(DENSE) + list(SMOKE)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name: str, dtype: str = "float32", **kw):
    """(JAX config, port config) built from the same fields."""
    if name in SMOKE:
        jc, tc = jreg.get_smoke(SMOKE[name]), treg.get_smoke(SMOKE[name])
    else:
        base = dict(name="t-dense", arch_type="dense", num_layers=4, d_model=128, num_heads=4,
                    num_kv_heads=2, d_ff=256, vocab_size=512)
        base.update(DENSE[name])
        jc, tc = JModelConfig(**base), TModelConfig(**base)
    return (dataclasses.replace(jc, dtype=dtype, **kw),
            dataclasses.replace(tc, dtype=dtype, **kw))


@functools.cache
def _jax_params(name: str):
    jc, _ = _configs(name)
    return jt.init_model_params(jax.random.PRNGKey(0), jc)


def _setup(name: str, dtype: str = "float32", **kw):
    jc, tc = _configs(name, dtype, **kw)
    jp = _jax_params(name)
    return jc, tc, jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _assert_logits(got: torch.Tensor, want, rtol: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    masked = want <= -1e29
    np.testing.assert_array_equal(got[masked], want[masked])
    atol = rtol * max(1.0, float(np.abs(want[~masked]).max()))
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=0, atol=atol)


def _jax_leaves(tree) -> list:
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_config_copy_equals_jax_field_by_field(arch, which):
    get = "get" if which == "full" else "get_smoke"
    jc, tc = getattr(jreg, get)(arch), getattr(treg, get)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.padded_vocab_size, tc.resolved_head_dim, tc.num_periods, tc.remainder_pattern) == \
        (jc.padded_vocab_size, jc.resolved_head_dim, jc.num_periods, jc.remainder_pattern)
    assert dataclasses.asdict(treg.swa_variant(tc)) == dataclasses.asdict(jreg.swa_variant(jc))


def test_registry_copy():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.canon("qwen3-0.6b") == jreg.canon("qwen3-0.6b") == "qwen3_0_6b"
    with pytest.raises(AssertionError):  # validation travels with the copy
        TModelConfig(name="x", arch_type="dense", num_layers=1, d_model=8, num_heads=3,
                     num_kv_heads=2, d_ff=8, vocab_size=8)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_every_architecture_builds_and_runs_a_smoke_forward(arch):
    """All ten architectures of the registry: ``init_model_params``,
    ``init_cache``, ``init_train_state`` and one uncached forward at the
    smoke config, finite on the CPU (an encoder-decoder with its frames, a
    VLM with its patches)."""
    cfg = treg.get_smoke(arch)
    assert treg.get(arch).name == jreg.get(arch).name
    params = tt.init_model_params(torch.Generator().manual_seed(0), cfg)
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(params))
    cache = tt.init_cache(cfg, 2, 24, torch.float32)
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(cache))
    assert any("cross_k" in p for p in flatten(cache)) == (cfg.encoder is not None)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg)
    assert state.step == 0 and len(tree_leaves(state.opt.mu)) == len(tree_leaves(params))
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 0))
    gen = torch.Generator().manual_seed(1)
    kw = {}
    if cfg.encoder is not None:
        kw["frames"] = torch.randn((2, cfg.encoder.num_frames, cfg.encoder.frontend_dim),
                                   generator=gen)
    if cfg.vision is not None:
        kw["patches"] = torch.randn((2, cfg.vision.num_patches, cfg.vision.vit_dim),
                                    generator=gen)
    with torch.no_grad():
        logits, _, aux = tt.forward(params, cfg, toks, **kw)
    P = cfg.vision.num_patches if cfg.vision is not None else 0
    assert logits.shape == (2, P + 16, cfg.padded_vocab_size)
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_moe_and_mla_smoke_configs_serve_and_train(arch):
    """The architectures slice 11 brought (MoE, MLA) build, prefill, decode
    and take a training step at their smoke configs; parity with JAX is in
    tests/test_torch_moe.py and tests/test_torch_mla.py."""
    cfg = treg.get_smoke(arch)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 0))
    logits, cache = tsteps.make_prefill_step(cfg, 20)(state.params, toks)
    assert logits.shape == (2, cfg.padded_vocab_size) and bool(torch.isfinite(logits).all())
    assert ("prelude" in cache) == (cfg.moe is not None and cfg.moe.first_layer_dense)
    logits, cache = tsteps.make_decode_step(cfg)(state.params, cache, 16, toks[:, :1])
    assert bool(torch.isfinite(logits).all())
    new, metrics = tsteps.make_train_step(cfg)(state, {"tokens": toks,
                                                       "targets": torch.roll(toks, -1, 1)})
    assert new.step == 1 and np.isfinite(float(metrics["loss"]))
    assert (float(metrics["aux"]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ["xlstm-350m", "internvl2-76b"])
def test_xlstm_and_vlm_smoke_configs_serve_and_train(arch):
    """The architectures slice 12 brought (xLSTM, the vision stub) build,
    prefill (a VLM with its patches prepended), decode and take a training
    step at their smoke configs; parity with JAX is in
    tests/test_torch_xlstm.py and tests/test_torch_vlm.py."""
    cfg = treg.get_smoke(arch)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 0))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    P = 0
    if cfg.vision is not None:
        P = cfg.vision.num_patches
        batch["patches"] = torch.randn((2, P, cfg.vision.vit_dim),
                                       generator=torch.Generator().manual_seed(1))
    logits, cache = tsteps.make_prefill_step(cfg, P + 20)(state.params, toks,
                                                          patches=batch.get("patches"))
    assert logits.shape == (2, cfg.padded_vocab_size) and bool(torch.isfinite(logits).all())
    logits, cache = tsteps.make_decode_step(cfg)(state.params, cache, P + 16, toks[:, :1])
    assert bool(torch.isfinite(logits).all())
    new, metrics = tsteps.make_train_step(cfg)(state, batch)
    assert new.step == 1 and np.isfinite(float(metrics["loss"])) and float(metrics["aux"]) == 0


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-base"])
def test_rglru_and_encdec_smoke_configs_serve_and_train(arch):
    """The architectures slice 13 brought (RG-LRU, the encoder-decoder)
    prefill (whisper with its frames), decode (without them) and take a
    training step at their smoke configs; parity with JAX is in
    tests/test_torch_rglru.py and tests/test_torch_encdec.py."""
    cfg = treg.get_smoke(arch)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 20), 0))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    if cfg.encoder is not None:
        e = cfg.encoder
        batch["frames"] = torch.randn((2, e.num_frames, e.frontend_dim),
                                      generator=torch.Generator().manual_seed(1))
    logits, cache = tsteps.make_prefill_step(cfg, 24)(state.params, toks,
                                                      frames=batch.get("frames"))
    assert logits.shape == (2, cfg.padded_vocab_size) and bool(torch.isfinite(logits).all())
    logits, cache = tsteps.make_decode_step(cfg)(state.params, cache, 20, toks[:, :1])
    assert bool(torch.isfinite(logits).all())
    new, metrics = tsteps.make_train_step(cfg)(state, batch)
    assert new.step == 1 and np.isfinite(float(metrics["loss"])) and float(metrics["aux"]) == 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_parameter_tree_is_jax_tree(name):
    jc, tc = _configs(name)
    jp = _jax_params(name)
    tp = tt.init_model_params(torch.Generator().manual_seed(0), tc)
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = flatten(tp)
    assert len(tflat) == len(jflat)
    for (tk, tv), (jk, jv) in zip(tflat.items(), jflat.items(), strict=True):
        assert jk.replace("['", "").replace("']", "/").replace("[", "").replace("]", "/") \
            .rstrip("/") == tk
        assert tv.shape == jv.shape and tv.dtype == jv.dtype == np.float32
    assert isinstance(tp["remainder"], list) and len(tp["remainder"]) == len(jp["remainder"])
    assert ("lm_head" in tp) == (not tc.tie_embeddings)


def test_initializers_draw_jax_distributions_on_the_generator_device():
    _, tc = _configs("two-kind", d_model=256, d_ff=512)
    p = tt.init_model_params(torch.Generator().manual_seed(3), tc)
    again = tt.init_model_params(torch.Generator().manual_seed(3), tc)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(again), strict=True))
    assert all(leaf.device.type == "cpu" for leaf in tree_leaves(p))
    # LeCun normal: std 1/sqrt(fan_in) per period slice; embeddings 0.02
    wq = p["stack"]["b0"]["mix"]["wq"]
    assert wq.shape == (2, 256, 4 * 64)
    for per in wq:
        assert abs(float(per.std()) * np.sqrt(256) - 1) < 0.03
    assert abs(float(p["embed"].std()) / 0.02 - 1) < 0.03
    assert abs(float(p["stack"]["b1"]["mlp"]["w_down"].std()) * np.sqrt(512) - 1) < 0.03
    assert torch.equal(p["stack"]["b0"]["ln1"], torch.ones(2, 256))
    assert not torch.equal(wq[0], wq[1])  # one draw per period


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, dtype):
    jc, tc, jp, tp = _setup(name, dtype)
    toks = _tokens(jc, (B, S), 0)
    want, _, _ = jt.forward(jp, jc, jnp.asarray(toks))
    got, cache, aux = tt.forward(tp, tc, torch.from_numpy(toks))
    assert cache is None and float(aux) == 0.0 and got.dtype == torch.float32
    _assert_logits(got, want, FP32_RTOL if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax_step_for_step(name):
    jc, tc, jp, tp = _setup(name)
    toks, cont = _tokens(jc, (B, S), 1), _tokens(jc, (B, 4), 2)
    jpf, jdec = jsteps.make_prefill_step(jc, S + 8), jsteps.make_decode_step(jc)
    tpf, tdec = tsteps.make_prefill_step(tc, S + 8), tsteps.make_decode_step(tc)
    jlg, jcache = jpf(jp, jnp.asarray(toks))
    tlg, tcache = tpf(tp, torch.from_numpy(toks))
    _assert_logits(tlg, jlg, FP32_RTOL)

    def caches_agree():
        for got, want in zip(tree_leaves(tcache), _jax_leaves(jcache), strict=True):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=FP32_RTOL * max(1.0, float(np.abs(want).max())))

    caches_agree()
    for i in range(4):
        jlg, jcache = jdec(jp, jcache, jnp.asarray(S + i, jnp.int32), jnp.asarray(cont[:, i:i + 1]))
        # the position as a host int and as a device counter: the same step
        pos = S + i if i % 2 else torch.tensor(S + i)
        tlg, tcache = tdec(tp, tcache, pos, torch.from_numpy(cont[:, i:i + 1]))
        _assert_logits(tlg, jlg, FP32_RTOL)
    caches_agree()


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_full_forward(name):
    """Prefill(S) + decode(1) == uncached forward over S+1 tokens."""
    _, tc, _, tp = _setup(name)
    toks = torch.from_numpy(_tokens(tc, (B, S), 0))
    _, cache = tsteps.make_prefill_step(tc, S + 8)(tp, toks)
    nxt = toks[:, :1]
    lg, _ = tsteps.make_decode_step(tc)(tp, cache, S, nxt)
    full, _, _ = tt.forward(tp, tc, torch.cat([toks, nxt], 1))
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), atol=2e-4)


def test_multi_token_decode_chain():
    """8 sequential decode steps == uncached forward (dense cfg)."""
    _, tc, _, tp = _setup("dense-gqa")
    toks = torch.from_numpy(_tokens(tc, (B, S), 0))
    _, cache = tsteps.make_prefill_step(tc, S + 16)(tp, toks)
    dec = tsteps.make_decode_step(tc)
    cont = torch.from_numpy(_tokens(tc, (B, 8), 5))
    outs = []
    for i in range(8):
        lg, cache = dec(tp, cache, S + i, cont[:, i:i + 1])
        outs.append(lg)
    full, _, _ = tt.forward(tp, tc, torch.cat([toks, cont], 1))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, S:].numpy(), atol=2e-4)


def test_sliding_window_ring_cache_long_decode():
    """Decode far beyond the window: the ring cache (window slots) agrees
    with an uncached forward."""
    jc, tc = _configs("dense-swa", num_layers=2, sliding_window=8)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jt.init_model_params(
        jax.random.PRNGKey(0), jc)))
    prompt = torch.from_numpy(_tokens(tc, (1, 12), 2))  # > window
    _, cache = tsteps.make_prefill_step(tc, 64)(tp, prompt)
    assert cache["stack"]["b0"]["k"].shape[2] == tc.sliding_window  # (P, B, W, KV, hd)
    dec = tsteps.make_decode_step(tc)
    cont = torch.from_numpy(_tokens(tc, (1, 10), 3))
    outs = []
    for i in range(10):
        lg, cache = dec(tp, cache, 12 + i, cont[:, i:i + 1])
        outs.append(lg)
    full, _, _ = tt.forward(tp, tc, torch.cat([prompt, cont], 1))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, 12:].numpy(), atol=3e-4)


@pytest.mark.parametrize("name", ["dense-gqa", "dense-swa"])
def test_attn_q_chunk_equals_unchunked_forward(name):
    _, tc, _, tp = _setup(name)
    chunked = dataclasses.replace(tc, attn_q_chunk=8)
    toks = torch.from_numpy(_tokens(tc, (B, S), 4))
    tgt = torch.roll(toks, -1, 1)
    outs = []
    for cfg in (tc, chunked):
        leaves = [a.detach().requires_grad_(True) for a in tree_leaves(tp)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), tp)
        logits, _, _ = tt.forward(live, cfg, toks)
        loss = tsteps.cross_entropy(logits, tgt)
        outs.append((logits.detach(), torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(), rtol=0, atol=1e-5)
    for a, b in zip(outs[1][1], outs[0][1], strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))


def test_padded_vocab_is_masked_and_head_is_tied():
    _, tc, _, tp = _setup("two-kind")
    assert tc.padded_vocab_size == 512 and tc.vocab_size == 500 and "lm_head" not in tp
    logits, _, _ = tt.forward(tp, tc, torch.from_numpy(_tokens(tc, (1, 8), 0)))
    assert bool((logits[..., 500:] == -1e30).all()) and bool(torch.isfinite(logits[..., :500]).all())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the full-width model runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# float32 at full width: 28 layers of 1,024-wide sums on the card (cuBLAS)
# against XLA's CPU sums, or against the port's own uncached forward. The
# JAX package's cache bound at 4 layers of 128 (tests/test_models.py:100)
# holds at full width too: its logits are ~0.5 (tied 0.02-scale
# embeddings) and the gaps ~1e-5 (NVIDIA H100)
FULL_FP32_ATOL = 2e-4


@pytest.mark.cuda
def test_full_width_forward_on_the_card_matches_jax_on_the_cpu(cuda_device):
    from repro.configs import qwen3_0_6b as jq
    from repro_torch.configs import qwen3_0_6b as tq

    jc = dataclasses.replace(jq.FULL, dtype="float32")
    tc = dataclasses.replace(tq.FULL, dtype="float32")
    jp = jt.init_model_params(jax.random.PRNGKey(0), jc)
    toks = _tokens(jc, (1, 32), 0)
    want = np.asarray(jt.forward(jp, jc, jnp.asarray(toks))[0])
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), cuda_device)
    del jp
    with torch.no_grad():
        got, _, _ = tt.forward(tp, tc, torch.from_numpy(toks).to(cuda_device))
    ok = want > -1e29
    err = float(np.abs(got.cpu().numpy()[ok] - want[ok]).max())
    print(f"qwen3-0.6b fp32, card vs JAX on the CPU: max|d logits| {err:.3e}")
    assert err <= FULL_FP32_ATOL, err
    assert bool((got[..., tc.vocab_size:] == -1e30).all())


@pytest.mark.cuda
def test_full_width_decode_on_the_card_matches_its_uncached_forward(cuda_device):
    from repro_torch.configs import qwen3_0_6b as tq

    tc = dataclasses.replace(tq.FULL, dtype="float32")
    tp = tt.init_model_params(torch.Generator(cuda_device).manual_seed(0), tc)
    assert sum(a.numel() for a in tree_leaves(tp)) == 596_180_992
    toks = torch.from_numpy(_tokens(tc, (2, 64), 1)).to(cuda_device)
    _, cache = tsteps.make_prefill_step(tc, 72)(tp, toks[:, :56])
    dec = tsteps.make_decode_step(tc)
    outs = []
    for i in range(8):
        lg, cache = dec(tp, cache, 56 + i, toks[:, 56 + i:57 + i])
        outs.append(lg)
    with torch.no_grad():
        full, _, _ = tt.forward(tp, tc, toks)
    ok = full[:, 56:64] > -1e29
    err = float((torch.stack(outs, 1)[:, :8] - full[:, 56:64])[ok].abs().max())
    print(f"qwen3-0.6b fp32 on the card, decode vs uncached: max|d logits| {err:.3e}")
    assert err <= FULL_FP32_ATOL, err
