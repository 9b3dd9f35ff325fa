"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX package's, on the CPU.

Same inputs in both packages: JAX's parameters carried across with
``models.transformer.params_from_numpy``, numpy-seeded activations and
tokens.

  * ``_rglru_scan`` (a log-step scan where JAX takes
    ``jax.lax.associative_scan``) with and without an initial state, at
    S = 1, 7, 64 and 256, on gates in Griffin's range;
  * ``rglru_forward`` without a cache, as a prefill from a nonzero cache
    and as the exact one-step decode, float32 and bfloat16; the cache it
    writes in place against JAX's new cache; ``init_rglru_cache`` against
    JAX's (leaves, shapes, dtypes: h float32 whatever the cache dtype);
  * recurrentgemma-2b's smoke model (one period of (rglru, rglru,
    local_attn) and a remainder rglru): logits float32 and bfloat16,
    prefill + decode logits and caches, one AdamW train step with remat
    on and off;
  * mirrors of ``tests/test_models.py::test_remainder_layers_used`` and
    ``tests/test_runtime_integration.py::test_hybrid_long_decode_state_and_ring_cache``;
  * the published config's parameter tree against JAX's ``eval_shape``
    tree (3,549,795,840 parameters; built on fake tensors), and its
    layout: 8 periods and 2 trailing rglru layers.

Tolerances. The scan: 1e-5 x max(1, max|h|) (the log-step scan and XLA's
associative scan multiply the gates in other orders: 2.4e-7 to 1.4e-6
seen at S = 7 to 2,048 with max|h| <= 4.5). float32 blocks and models:
5e-5 x max(1, max|want|) (the packages sum matmuls in different orders).
bfloat16 blocks, fed the same bf16 inputs and weights: 4 bf16 units in
the last place of the output's largest entry (each package rounds every
activation to bf16 after its own float32 sums). bfloat16 whole model: 2 x
JAX's own bf16 forward's gap to its float32 forward. The train step: the
loss 2e-6 relative, the moments 1e-4 of each leaf's largest entry, the
parameters 5e-5 absolute wherever |g| >= 1e-6 (``tests/test_torch_xlstm.py``'s
bounds, for the same reason). The long decode: 5e-4 absolute (JAX's own
test).

On the card (``cuda``-marked, skipped here): recurrentgemma-2b at its
published width and 4 layers, fp32 prefill and decode against its
uncached forward.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as jreg
from repro.models import rglru as jrglru
from repro.models import transformer as jt
from repro.runtime import steps as jsteps
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import registry as treg
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import AdamState, tree_leaves
from repro_torch.runtime import steps as tsteps

ARCH = "recurrentgemma-2b"
SCAN_RTOL = 1e-5
FP32_RTOL = 5e-5
BF16_ULPS = 4
BF16_NOISE_FACTOR = 2.0
LOSS_RTOL, MOMENT_RTOL, PARAM_ATOL = 2e-6, 1e-4, 5e-5
SIGN_GRAD = 1e-6  # 100 x AdamW's eps
LONG_DECODE_ATOL = 5e-4  # tests/test_runtime_integration.py:58
W = 128  # the smoke config's rnn_width


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype: str = "float32", **kw):
    """recurrentgemma-2b's smoke config (d_model 128, W 128, window 16,
    4 layers: one period and a remainder rglru) in both packages."""
    j = dataclasses.replace(jreg.get_smoke(ARCH), dtype=dtype, **kw)
    t = dataclasses.replace(treg.get_smoke(ARCH), dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _block_params(seed: int, dtype: str):
    """The block's JAX parameters as ``forward``'s one-shot cast leaves them
    (>= 2-D leaves in ``dtype``), and the same as port tensors."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jrglru.init_rglru_params(jax.random.PRNGKey(seed), _configs()[0])
    jp = jax.tree.map(lambda a: a.astype(jdt) if a.ndim >= 2 else a, jp)
    tp = {k: torch.from_numpy(_np(v).copy()).to(tdt if v.ndim >= 2 else torch.float32)
          for k, v in jp.items()}
    return jp, tp


def _act(shape, seed: int, dtype: str, scale: float = 1.0):
    """The same seeded array in both packages, in separate buffers (JAX may
    alias a numpy array, and the port writes caches in place)."""
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    return (jnp.asarray(a.copy()).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got: torch.Tensor, want, dtype: str = "float32") -> None:
    want = _np(want)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    if dtype == "float32":
        atol = FP32_RTOL * max(1.0, top)
    else:  # BF16_ULPS bf16 units in the last place of the largest entry
        atol = BF16_ULPS * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the scan and the block
# ---------------------------------------------------------------------------


def _gates(S: int, seed: int):
    """(u, a, h0) as the block forms them: a = exp(-8 r softplus(lam)) with
    lam from Griffin's init range, r = sigmoid(.), u the gated input."""
    rng = np.random.default_rng(seed)
    lam = np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, W)) / 8.0))
    r = 1 / (1 + np.exp(-rng.normal(size=(2, S, W))))
    a = np.exp(-8.0 * r * np.logaddexp(lam, 0.0)).astype(np.float32)
    u = (np.sqrt(1 - a.astype(np.float64) ** 2) * rng.normal(size=(2, S, W))).astype(np.float32)
    h0 = rng.normal(size=(2, W)).astype(np.float32)
    return u, a, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("S", [1, 7, 64, 256])
def test_rglru_scan_matches_jax(S, with_h0):
    u, a, h0 = _gates(S, S)
    want = np.asarray(jrglru._rglru_scan(jnp.asarray(u), jnp.asarray(a),
                                         jnp.asarray(h0) if with_h0 else None))
    got = trglru._rglru_scan(torch.from_numpy(u), torch.from_numpy(a),
                             torch.from_numpy(h0) if with_h0 else None)
    assert got.shape == (2, S, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=SCAN_RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_forward_without_a_cache_matches_jax(dtype):
    jc, tc = _configs(dtype)
    jp, tp = _block_params(1, dtype)
    jx, tx = _act((2, 37, 128), 0, dtype)
    want, jcache = jrglru.rglru_forward(jp, jc, jx)
    got, tcache = trglru.rglru_forward(tp, tc, tx)
    assert jcache is None and tcache is None and got.dtype == tx.dtype
    _close(got, want, dtype)


def _cache(seed: int, dtype: str):
    """A nonzero block cache in both packages: conv in ``dtype``, h float32
    (``init_rglru_cache``'s dtypes)."""
    jconv, tconv = _act((2, 3, W), seed, dtype)
    jh, th = _act((2, W), seed + 1, "float32", 0.5)
    return {"conv": jconv, "h": jh}, {"conv": tconv, "h": th}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [21, 1], ids=["prefill", "decode"])
def test_rglru_forward_from_a_cache_matches_jax_and_writes_it_in_place(S, dtype):
    jc, tc = _configs(dtype)
    jp, tp = _block_params(2, dtype)
    jx, tx = _act((2, S, 128), 3, dtype)
    jcache, tcache = _cache(10, dtype)
    before = dict(tcache)
    want, jnew = jrglru.rglru_forward(jp, jc, jx, cache=jcache)
    got, tnew = trglru.rglru_forward(tp, tc, tx, cache=tcache)
    _close(got, want, dtype)
    assert tnew is tcache and all(tnew[k] is before[k] for k in before)  # in place
    assert set(tnew) == set(jnew) == {"conv", "h"}
    assert tnew["conv"].dtype == tx.dtype and jnew["conv"].dtype == jx.dtype
    assert tnew["h"].dtype == torch.float32 and jnew["h"].dtype == jnp.float32
    np.testing.assert_array_equal(tnew["conv"].float().numpy(), _np(jnew["conv"]))  # inputs
    _close(tnew["h"], jnew["h"], dtype)  # a float32 leaf of bf16 activations


def test_rglru_cache_is_jax_cache():
    jc, tc = _configs()
    want = jrglru.init_rglru_cache(jc, 3, jnp.bfloat16)
    got = trglru.init_rglru_cache(tc, 3, torch.bfloat16, lead=(2,))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == (2,) + w.shape
        assert str(got[k].dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(got[k][1].float().numpy(), _np(w))


def test_rglru_parameters_follow_jax_init():
    """The leaves' shapes and distributions: lam = softplus^-1(-log u / 8)
    with u in [0.9, 0.999], so a^8 = exp(-8 softplus(lam)) lies there too."""
    _, tc = _configs()
    tp = trglru.init_rglru_params(torch.Generator().manual_seed(0), tc, lead=(3,))
    jp = jax.eval_shape(lambda: jrglru.init_rglru_params(jax.random.PRNGKey(0), _configs()[0]))
    assert {k: (3,) + v.shape for k, v in jp.items()} == {k: tuple(v.shape) for k, v in tp.items()}
    a8 = torch.exp(-8.0 * torch.logaddexp(tp["lam"], torch.zeros(())))
    assert float(a8.min()) >= 0.9 - 1e-6 and float(a8.max()) <= 0.999 + 1e-6


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _model(dtype: str = "float32", **kw):
    jc, tc = _configs(dtype, **kw)
    jp = jt.init_model_params(jax.random.PRNGKey(0), dataclasses.replace(jc, dtype="float32"))
    return jc, tc, jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_logits_match_jax(dtype):
    jc, tc, jp, tp = _model(dtype)
    toks = _tokens(512, (2, 40), 0)  # longer than the 16-token window
    want = np.asarray(jt.forward(jp, jc, jnp.asarray(toks))[0])
    got, cache, aux = tt.forward(tp, tc, torch.from_numpy(toks))
    assert cache is None and float(aux) == 0.0 and got.dtype == torch.float32
    if dtype == "float32":
        _close(got, want)
    else:
        w32 = np.asarray(jt.forward(jp, dataclasses.replace(jc, dtype="float32"),
                                    jnp.asarray(toks))[0])
        noise = float(np.abs(want - w32).max())
        gap = float(np.abs(got.numpy() - want).max())
        assert gap <= BF16_NOISE_FACTOR * noise, (gap, noise)


def test_prefill_and_decode_caches_match_jax():
    jc, tc, jp, tp = _model()
    toks, cont = _tokens(512, (2, 20), 1), _tokens(512, (2, 3), 2)
    jlg, jcache = jsteps.make_prefill_step(jc, 32)(jp, jnp.asarray(toks))
    tlg, tcache = tsteps.make_prefill_step(tc, 32)(tp, torch.from_numpy(toks))
    _close(tlg, jlg)
    for i in range(3):
        jlg, jcache = jsteps.make_decode_step(jc)(jp, jcache, jnp.asarray(20 + i, jnp.int32),
                                                  jnp.asarray(cont[:, i:i + 1]))
        tlg, tcache = tsteps.make_decode_step(tc)(tp, tcache, 20 + i,
                                                  torch.from_numpy(cont[:, i:i + 1]))
        _close(tlg, jlg)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jcache)[0]}
    tflat = flatten(tcache)
    assert len(tflat) == len(jflat) == 3 * 2 + 2  # 3 rglru x (conv, h), 1 ring x (k, v)
    for got, want in zip(tflat.values(), jflat.values(), strict=True):
        assert got.dtype == np.asarray(want).dtype == np.float32
        _close(torch.from_numpy(got), want)
    assert tcache["stack"]["b2"]["k"].shape[2] == tc.sliding_window  # the ring cache


def test_remainder_layers_used():
    """Mirror of tests/test_models.py:178: 5 layers of (rglru, rglru,
    local_attn) leave 2 remainder layers, and they contribute."""
    cfg = TModelConfig(
        name="t-rem", arch_type="hybrid", num_layers=5, d_model=64, num_heads=2,
        num_kv_heads=1, d_ff=128, vocab_size=128, dtype="float32", sliding_window=8,
        block_pattern=("rglru", "rglru", "local_attn"),
    ).validate()
    params = tt.init_model_params(torch.Generator().manual_seed(0), cfg)
    assert len(params["remainder"]) == 2
    assert tt.layout(cfg) == (False, 1, ("rglru", "rglru"))
    t = torch.from_numpy(_tokens(128, (1, 16), 0))
    with torch.no_grad():
        lg, _, _ = tt.forward(params, cfg, t)
        assert bool(torch.isfinite(lg).all())
        params["remainder"][0]["mix"]["w_out"] = torch.zeros_like(
            params["remainder"][0]["mix"]["w_out"])
        lg2, _, _ = tt.forward(params, cfg, t)
    assert float((lg - lg2).abs().max()) > 1e-6


def test_hybrid_long_decode_state_and_ring_cache():
    """Mirror of tests/test_runtime_integration.py:41: decode 12 tokens past
    a 20-token prompt (window 16) == the uncached forward; the RG-LRU state
    stays exact and the ring cache consistent."""
    cfg = treg.get_smoke(ARCH)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg)
    prompt = torch.from_numpy(_tokens(cfg.vocab_size, (1, 20), 1))
    cont = torch.from_numpy(_tokens(cfg.vocab_size, (1, 12), 2))
    _, cache = tsteps.make_prefill_step(cfg, cache_len=64)(state.params, prompt)
    dec = tsteps.make_decode_step(cfg)
    outs = []
    for i in range(12):
        lg, cache = dec(state.params, cache, 20 + i, cont[:, i:i + 1])
        outs.append(lg)
    with torch.no_grad():
        full, _, _ = tt.forward(state.params, cfg, torch.cat([prompt, cont], 1))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, 20:].numpy(),
                               atol=LONG_DECODE_ATOL)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_one_train_step_matches_jax(remat):
    jc, tc = _configs(remat=remat)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jstate.params))
    tstate = tsteps.TrainState(tp, AdamState(0, *(tt.params_from_numpy(jax.tree.map(
        np.asarray, t)) for t in (jstate.opt.mu, jstate.opt.nu))), 0)
    toks = _tokens(512, (2, 40), 3)
    tg = np.roll(toks, -1, axis=1)
    jnew, jm = jax.jit(jsteps.make_train_step(jc, 1e-3))(
        jstate, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)})
    tnew, tm = tsteps.make_train_step(tc, 1e-3)(
        tstate, {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    for tree_t, tree_j in ((tnew.opt.mu, jnew.opt.mu), (tnew.opt.nu, jnew.opt.nu)):
        for got, want in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j), strict=True):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=MOMENT_RTOL * float(np.abs(want).max()))
    # AdamW's first step moves an entry by lr g / (|g| + 1e-8): a sign where
    # |g| >= SIGN_GRAD; entries of smaller |g| swing with the float32 sums'
    # rounding and are held by the moments above
    held = total = 0
    for got, want, mu in zip(tree_leaves(tnew.params), jax.tree.leaves(jnew.params),
                             jax.tree.leaves(jnew.opt.mu), strict=True):
        sign = np.abs(np.asarray(mu)) / 0.1 >= SIGN_GRAD  # g = mu / (1 - b1) after one step
        held, total = held + int(sign.sum()), total + sign.size
        np.testing.assert_allclose(got.numpy()[sign], np.asarray(want)[sign], rtol=0,
                                   atol=PARAM_ATOL)
    assert held > total // 2


def test_train_step_finite_and_decreases():
    """Mirror of tests/test_models.py:76-86 for ``hybrid``: 8 steps on one
    batch, the loss falls."""
    _, tc = _configs()
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), tc)
    toks = torch.from_numpy(_tokens(256, (2, 32), 0))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    step = tsteps.make_train_step(tc, learning_rate=1e-3)
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _tree_is_jax_tree(tp, jp) -> None:
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {k: v for k, v in zip(_paths(tp), tree_leaves(tp), strict=True)}
    assert len(tflat) == len(jflat)
    for (tk, tv), (jk, jv) in zip(tflat.items(), jflat.items(), strict=True):
        assert jk.replace("['", "").replace("']", "/").replace("[", "").replace("]", "/") \
            .rstrip("/") == tk
        assert tuple(tv.shape) == jv.shape and tv.dtype == torch.float32 and jv.dtype == np.float32


def _paths(tree, prefix: str = "") -> list[str]:
    """The key paths of ``tree`` in ``tree_leaves``' order, joined by "/"."""
    if isinstance(tree, torch.Tensor):
        return [prefix.rstrip("/")]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    return [p for k, v in items for p in _paths(v, f"{prefix}{k}/")]


def test_recurrentgemma_2b_parameter_tree_is_jax_tree():
    """The published config, built on fake tensors (no 14 GB on the CPU):
    JAX's tree key for key, 3,549,795,840 parameters, and JAX's split into
    8 periods of (rglru, rglru, local_attn) and 2 trailing rglru layers."""
    jc, tc = jreg.get(ARCH), treg.get(ARCH)
    jp = jax.eval_shape(lambda: jt.init_model_params(jax.random.PRNGKey(0), jc))
    with FakeTensorMode():
        tp = tt.init_model_params(torch.Generator().manual_seed(0), tc)
    _tree_is_jax_tree(tp, jp)
    assert sum(v.numel() for v in tree_leaves(tp)) == 3_549_795_840
    assert tt.layout(tc) == (False, 8, ("rglru", "rglru"))
    assert (tc.num_periods, tc.remainder_pattern) == (jc.num_periods, jc.remainder_pattern)
    assert len(jp["remainder"]) == 2 and jp["stack"]["b0"]["mix"]["lam"].shape == (8, 2560)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: recurrentgemma-2b runs at its published width "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_published_width_decode_on_the_card_matches_its_uncached_forward(card):
    tc = dataclasses.replace(treg.get(ARCH), dtype="float32", num_layers=4)
    tp = tt.init_model_params(torch.Generator(card).manual_seed(0), tc)
    assert sum(a.numel() for a in tree_leaves(tp)) == 1_659_432_960
    toks = torch.from_numpy(_tokens(tc.vocab_size, (2, 136), 1)).to(card)
    _, cache = tsteps.make_prefill_step(tc, 136)(tp, toks[:, :128])
    dec = tsteps.make_decode_step(tc)
    outs = []
    for i in range(8):
        lg, cache = dec(tp, cache, 128 + i, toks[:, 128 + i:129 + i])
        outs.append(lg)
    with torch.no_grad():
        full, _, _ = tt.forward(tp, tc, toks)
    want = full[:, 128:136]
    err = float((torch.stack(outs, 1) - want).abs().max())
    print(f"recurrentgemma-2b (4 layers) fp32 on the card, decode vs uncached: "
          f"max|d logits| {err:.3e}")
    assert err <= 2e-4 * max(1.0, float(want.abs().max())), err
