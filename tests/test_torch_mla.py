"""The port's MLA (``repro_torch.models.attention``'s ``mla_forward``)
against the JAX package's.

Same parameters in both packages (JAX's ``init_mla_params`` /
``init_model_params`` carried across with
``models.transformer.params_from_numpy``), same seeded numpy inputs, at
``tests/test_models.py``'s "mla" config (d_model 128, 4 heads, q_lora 64,
kv_lora 32, nope 16, rope 8, v 16) and at minicpm3-4b's smoke config:

  * ``mla_forward`` over a full sequence equals JAX's, float32 and
    bfloat16;
  * the query-chunked forward (``attn_q_chunk``) equals JAX's chunked
    forward, and the port's unchunked one in values and gradients;
  * a prefill writes the latents at offset 0 and the ABSORBED decode
    attends against them: logits and both cache leaves (``c_kv`` (B, S,
    r), ``k_rope`` (B, S, dr)) equal JAX's step for step, with the
    position as a host int and as a device counter;
  * prefill + decode equals the port's own uncached forward (one token
    and an 8-token chain; JAX's ``tests/test_models.py:89-117`` bound,
    2e-4 absolute, in float32);
  * the minicpm3 smoke model's logits equal JAX's, and its parameter and
    cache trees are JAX's.

Tolerances: float32 |d| <= 2e-5 max(1, max|ref|) (different matmul
summation orders, ~1e-6 relative seen); bfloat16 2**-5 max(1, max|ref|)
(tests/test_torch_lm.py's bound); chunked against unchunked 1e-5, the
gradients 1e-5 of each leaf's largest entry (the same math, reassociated).
In bfloat16 the absorbed decode rounds differently from the expanded
prefill; on the card ``chip_smoke.py`` phase 13 bounds that gap at twice
the bf16 forward's own gap to float32. On the card (``cuda``-marked,
skipped here): minicpm3's smoke model in float32 against JAX's CPU
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
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models.config import MLAConfig as JMLAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import steps as jsteps
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.config import MLAConfig as TMLAConfig
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.runtime import steps as tsteps

B, S = 2, 32
FP32_RTOL = 2e-5
BF16_RTOL = 2.0**-5
CHUNK_ATOL = 1e-5
CACHE_ATOL = 2e-4

BASE = dict(name="t-mla", arch_type="dense", num_layers=4, d_model=128, num_heads=4,
            num_kv_heads=2, d_ff=256, vocab_size=512, block_pattern=("mla",))
MLA = dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype: str = "float32", **kw):
    j = JModelConfig(**BASE, mla=JMLAConfig(**MLA), dtype=dtype)
    t = TModelConfig(**BASE, mla=TMLAConfig(**MLA), dtype=dtype)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


@functools.cache
def _jax_layer():
    jc, _ = _configs()
    return jattn.init_mla_params(jax.random.PRNGKey(0), jc)


def _layer():
    jp = _jax_layer()
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(shape=(B, S, 128), seed: int = 1, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _close(got: torch.Tensor, want, rtol: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_jax(dtype):
    jc, tc = _configs(dtype)
    jp, tp = _layer()
    x = _x()
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pos = np.arange(S)
    want, wc = jattn.mla_forward(jp, jc, jx, jnp.asarray(pos))
    got, c = tattn.mla_forward(tp, tc, tx, torch.from_numpy(pos))
    assert wc is None and c is None and got.dtype == tx.dtype
    _close(got, want, FP32_RTOL if dtype == "float32" else BF16_RTOL)


def test_chunked_forward_matches_jax_and_the_unchunked_forward():
    jc, tc = _configs(attn_q_chunk=8)
    _, plain = _configs()
    jp, tp = _layer()
    x = _x(seed=2)
    pos = np.arange(S)
    want, _ = jattn.mla_forward(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    outs = []
    for cfg in (plain, tc):
        leaves = [a.detach().requires_grad_(True) for a in tree_leaves(tp)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), tp)
        out, _ = tattn.mla_forward(live, cfg, torch.from_numpy(x), torch.from_numpy(pos))
        grads = torch.autograd.grad((out * out).sum(), leaves)
        outs.append((out.detach(), grads))
    _close(outs[1][0], want, FP32_RTOL)
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(), rtol=0, atol=CHUNK_ATOL)
    for a, b in zip(outs[1][1], outs[0][1], strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=CHUNK_ATOL * max(1.0, float(b.abs().max())))


def test_prefill_and_absorbed_decode_match_jax_step_for_step():
    jc, tc = _configs()
    jp, tp = _layer()
    x = _x(seed=3, shape=(B, S + 4, 128))
    T = S + 8
    jcache = jattn.init_mla_cache(jc, B, T, jnp.float32)
    tcache = tattn.init_mla_cache(tc, B, T, torch.float32)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()} == {"c_kv": (B, T, 32), "k_rope": (B, T, 8)}
    want, jcache = jattn.mla_forward(jp, jc, jnp.asarray(x[:, :S]), jnp.arange(S), cache=jcache)
    got, tcache2 = tattn.mla_forward(tp, tc, torch.from_numpy(x[:, :S]), torch.arange(S),
                                     cache=tcache)
    assert tcache2 is tcache  # written in place
    _close(got, want, FP32_RTOL)
    for i in range(4):
        p = S + i
        want, jcache = jattn.mla_forward(jp, jc, jnp.asarray(x[:, p:p + 1]), jnp.asarray([p]),
                                         cache=jcache, cache_pos=jnp.asarray(p, jnp.int32))
        pos = p if i % 2 else torch.tensor(p)
        got, tcache = tattn.mla_forward(tp, tc, torch.from_numpy(x[:, p:p + 1]),
                                        torch.tensor([p]), cache=tcache, cache_pos=pos)
        _close(got, want, FP32_RTOL)
    for k in ("c_kv", "k_rope"):
        _close(tcache[k], jcache[k], FP32_RTOL)
        assert not tcache[k][:, S + 4:].any()  # nothing written past the last position


def test_mla_params_tree():
    jc, tc = _configs()
    jp = _jax_layer()
    tp = tattn.init_mla_params(torch.Generator().manual_seed(0), tc)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32
    assert torch.equal(tp["q_norm"], torch.ones(64)) and torch.equal(tp["kv_norm"], torch.ones(32))
    assert abs(float(tp["w_uq"].std()) * np.sqrt(64) - 1) < 0.05


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.cache
def _jax_model(name: str):
    jc = jreg.get_smoke("minicpm3-4b") if name == "minicpm3" else _configs()[0]
    return jt.init_model_params(jax.random.PRNGKey(0), jc)


def _model(name: str, dtype: str = "float32"):
    if name == "minicpm3":
        jc = dataclasses.replace(jreg.get_smoke("minicpm3-4b"), dtype=dtype)
        tc = dataclasses.replace(treg.get_smoke("minicpm3-4b"), dtype=dtype)
    else:
        jc, tc = _configs(dtype)
    jp = _jax_model(name)
    return jc, tc, jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["t-mla", "minicpm3"])
def test_model_logits_match_jax(name, dtype):
    jc, tc, jp, tp = _model(name, dtype)
    toks = _tokens(jc, (B, S), 0)
    want, _, _ = jt.forward(jp, jc, jnp.asarray(toks))
    got, _, aux = tt.forward(tp, tc, torch.from_numpy(toks))
    assert float(aux) == 0.0
    _close(got, want, FP32_RTOL if dtype == "float32" else BF16_RTOL)


def test_minicpm3_trees_are_jax_trees():
    jc, tc, jp, _ = _model("minicpm3")
    tp = tt.init_model_params(torch.Generator().manual_seed(0), tc)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = flatten(tp)
    assert len(tflat) == len(jflat)
    for (tk, tv), (jk, jv) in zip(tflat.items(), jflat, strict=True):
        assert jax.tree_util.keystr(jk).replace("['", "").replace("']", "/").replace("[", "") \
            .replace("]", "/").rstrip("/") == tk
        assert tuple(tv.shape) == jv.shape
    jcache = jt.init_cache(jc, 2, 24, jnp.float32)
    tcache = tt.init_cache(tc, 2, 24, torch.float32)
    assert [tuple(a.shape) for a in tree_leaves(tcache)] == \
        [a.shape for a in jax.tree.leaves(jcache)]


@pytest.mark.parametrize("name", ["t-mla", "minicpm3"])
def test_model_prefill_and_decode_match_jax(name):
    jc, tc, jp, tp = _model(name)
    toks, cont = _tokens(jc, (B, S), 1), _tokens(jc, (B, 4), 2)
    jlg, jcache = jsteps.make_prefill_step(jc, S + 8)(jp, jnp.asarray(toks))
    tlg, tcache = tsteps.make_prefill_step(tc, S + 8)(tp, torch.from_numpy(toks))
    _close(tlg, jlg, FP32_RTOL)
    for i in range(4):
        jlg, jcache = jsteps.make_decode_step(jc)(jp, jcache, jnp.asarray(S + i, jnp.int32),
                                                  jnp.asarray(cont[:, i:i + 1]))
        pos = S + i if i % 2 else torch.tensor(S + i)
        tlg, tcache = tsteps.make_decode_step(tc)(tp, tcache, pos,
                                                  torch.from_numpy(cont[:, i:i + 1]))
        _close(tlg, jlg, FP32_RTOL)
    for got, want in zip(tree_leaves(tcache), jax.tree.leaves(jcache), strict=True):
        _close(got, want, FP32_RTOL)


@pytest.mark.parametrize("name", ["t-mla", "minicpm3"])
def test_decode_chain_matches_the_uncached_forward(name):
    """Prefill(S) + 8 absorbed decode steps == the uncached forward."""
    _, tc, _, tp = _model(name)
    toks = torch.from_numpy(_tokens(tc, (B, S), 0))
    cont = torch.from_numpy(_tokens(tc, (B, 8), 5))
    _, cache = tsteps.make_prefill_step(tc, S + 8)(tp, toks)
    dec = tsteps.make_decode_step(tc)
    outs = []
    for i in range(8):
        lg, cache = dec(tp, cache, S + i, cont[:, i:i + 1])
        outs.append(lg)
    full, _, _ = tt.forward(tp, tc, torch.cat([toks, cont], 1))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, S:].numpy(),
                               atol=CACHE_ATOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: MLA's card path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_forward_matches_jax_on_the_cpu(cuda_device):
    jc, tc, jp, _ = _model("minicpm3")
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), cuda_device)
    toks = _tokens(jc, (B, S), 0)
    want, _, _ = jt.forward(jp, jc, jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = tt.forward(tp, tc, torch.from_numpy(toks).to(cuda_device))
    _close(got.cpu(), want, FP32_RTOL)
