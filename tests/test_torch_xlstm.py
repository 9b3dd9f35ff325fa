"""The port's xLSTM blocks (``repro_torch.models.ssm``) against the JAX package's, on the CPU.

Same inputs in both packages: JAX's parameters carried across with
``models.transformer.params_from_numpy``, numpy-seeded activations and
tokens.

  * ``_causal_conv`` (``models/rglru.py``) with and without a streaming
    state; ``_chunk_mlstm`` on one chunk from a nonzero state;
  * ``mlstm_forward`` on the chunked path at S = 64 (one chunk), S = 70
    (padded, two chunks) and S = 1 without a cache, prefill from a nonzero
    cache, and the exact one-step decode; ``slstm_forward`` from the
    ``-1e30`` start and from a cache; the cache leaves each returns against
    JAX's new cache (the port writes them into the given tensors);
  * the whole model's logits at JAX's ``t-xlstm`` config
    (``tests/test_models.py:57``), float32 and bfloat16;
  * one AdamW train step from JAX's parameters, with and without remat;
  * mirrors of ``tests/test_runtime_integration.py:62-76`` (prefill 16,
    20 decode steps against the uncached forward) and of the ``xlstm``
    cases of ``tests/test_models.py`` (an overfit of one batch; prefill +
    one decode step against the uncached forward);
  * xlstm-350m's smoke config serves and trains, and its parameter tree
    is JAX's key for key.

Tolerances. float32: 5e-5 x max(1, max|want|) (the packages sum matmuls
and einsums in different orders; ~3e-6 relative seen). bfloat16 blocks,
fed the same bf16 inputs and weights: 4 bf16 units in the last place of
the output's largest entry (each package rounds every activation to bf16
after its own float32 sums; 1-2.5 units seen). bfloat16 whole model: 2 x
JAX's own bf16 forward's gap to its float32 forward (the two packages'
bf16 forwards are each about that far from float32, independently: at 4
layers the port's gap to JAX's is 0.18 against JAX's own 0.23). The train
step: the loss 2e-6 relative, the moments 1e-4 of each leaf's largest
entry, the parameters 5e-5 absolute (``tests/test_torch_lm_train.py``'s
bounds) wherever |g| >= 1e-6, where AdamW's first step is lr sign(g); the
xLSTM's gradients reach 1e-9, 1e-7 of a leaf's largest, and there the
step lr g / (|g| + 1e-8) swings with the float32 sums' rounding (6e-5
seen), so those entries are held by the moments' bound. The decode chain: 5e-4 absolute (JAX's own test).

On the card (``cuda``-marked, skipped here): xlstm-350m at full width,
prefill and decode against its uncached forward in float32.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import steps as jsteps
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import registry as treg
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import AdamState, tree_leaves
from repro_torch.runtime import steps as tsteps

FP32_RTOL = 5e-5
BF16_ULPS = 4
BF16_NOISE_FACTOR = 2.0
LOSS_RTOL, MOMENT_RTOL, PARAM_ATOL = 2e-6, 1e-4, 5e-5
SIGN_GRAD = 1e-6  # 100 x AdamW's eps

# tests/test_models.py:57
T_XLSTM = dict(name="t-xlstm", arch_type="ssm", num_layers=4, d_model=128, num_heads=4,
               num_kv_heads=4, d_ff=0, vocab_size=512, dtype="float32", mlp_kind="none",
               rnn_width=256, block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
               pos_kind="none")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype: str = "float32", **kw):
    fields = {**T_XLSTM, "dtype": dtype, **kw}
    return JModelConfig(**fields).validate(), TModelConfig(**fields).validate()


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _block_params(init, seed: int, dtype: str):
    """A block's JAX parameters as ``forward``'s one-shot cast leaves them
    (>= 2-D leaves in ``dtype``), and the same as port tensors."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = init(jax.random.PRNGKey(seed), _configs()[0])
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
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_causal_conv_matches_jax(with_state, dtype):
    ju, tu = _act((2, 9, 16), 0, dtype)
    jk, tk = _act((4, 16), 1, "float32", 0.5)
    js, ts = _act((2, 3, 16), 2, dtype) if with_state else (None, None)
    jout, jstate = jrglru._causal_conv(ju, jk, js)
    tout, tstate = trglru._causal_conv(tu, tk, ts)
    assert tout.dtype == tu.dtype and tstate.shape == (2, 3, 16)
    _close(tout, jout, dtype)
    np.testing.assert_array_equal(tstate.float().numpy(), _np(jstate))  # the trailing inputs


def test_chunk_mlstm_one_chunk_from_a_state_matches_jax():
    B, H, c, dh = 2, 3, 64, 8
    jq, tq = _act((B, H, c, dh), 0, "float32")
    jk, tk = _act((B, H, c, dh), 1, "float32", 0.3)
    jv, tv = _act((B, H, c, dh), 2, "float32")
    gates = np.random.default_rng(3).normal(size=(2, B, H, c)).astype(np.float32)
    i_np, f_np = np.exp(np.minimum(gates[0], 8.0)), 1 / (1 + np.exp(-(gates[1] + 3.0)))
    jst, tst = _act((B, H, dh, dh), 4, "float32", 0.2)
    jnm, tnm = _act((B, H, dh), 5, "float32", 0.2)
    want = jssm._chunk_mlstm(jq, jk, jv, jnp.asarray(i_np), jnp.asarray(f_np), jst, jnm)
    got = tssm._chunk_mlstm(tq, tk, tv, torch.from_numpy(i_np), torch.from_numpy(f_np), tst, tnm)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 70, 1], ids=["one-chunk", "padded-two-chunks", "one-token"])
def test_mlstm_forward_without_a_cache_matches_jax(S, dtype):
    jc, tc = _configs(dtype)
    jp, tp = _block_params(jssm.init_mlstm_params, 1, dtype)
    jx, tx = _act((2, S, 128), 0, dtype)
    want, jcache = jssm.mlstm_forward(jp, jc, jx)
    got, tcache = tssm.mlstm_forward(tp, tc, tx)
    assert jcache is None and tcache is None and got.dtype == tx.dtype
    _close(got, want, dtype)


def _mlstm_cache(seed: int, dtype: str):
    """A nonzero mLSTM cache in both packages: conv in ``dtype``, state and
    norm float32 (``init_mlstm_cache``'s dtypes)."""
    inner, H, dh = 256, 4, 64
    jconv, tconv = _act((2, 3, inner), seed, dtype)
    jst, tst = _act((2, H, dh, dh), seed + 1, "float32", 0.1)
    jnm, tnm = _act((2, H, dh), seed + 2, "float32", 0.1)
    return {"conv": jconv, "state": jst, "norm": jnm}, {"conv": tconv, "state": tst, "norm": tnm}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [70, 1], ids=["prefill", "decode"])
def test_mlstm_forward_from_a_cache_matches_jax_and_writes_it_in_place(S, dtype):
    jc, tc = _configs(dtype)
    jp, tp = _block_params(jssm.init_mlstm_params, 2, dtype)
    jx, tx = _act((2, S, 128), 3, dtype)
    jcache, tcache = _mlstm_cache(10, dtype)
    before = {k: v for k, v in tcache.items()}
    want, jnew = jssm.mlstm_forward(jp, jc, jx, cache=jcache)
    got, tnew = tssm.mlstm_forward(tp, tc, tx, cache=tcache)
    _close(got, want, dtype)
    assert tnew is tcache and all(tnew[k] is before[k] for k in before)  # in place
    for k in ("conv", "state", "norm"):
        assert tnew[k].dtype == {"conv": tx.dtype}.get(k, torch.float32)
        assert jnew[k].dtype == (jx.dtype if k == "conv" else jnp.float32)
        _close(tnew[k], jnew[k], dtype)  # float32 leaves of bf16 activations


def _slstm_cache(seed: int):
    W = 256
    rng = np.random.default_rng(seed)
    vals = {"c": rng.normal(size=(2, W)), "n": 1 + rng.uniform(size=(2, W)),
            "h": 0.3 * rng.normal(size=(2, W)), "m": rng.normal(size=(2, W))}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    return ({k: jnp.asarray(v) for k, v in vals.items()},
            {k: torch.from_numpy(v.copy()) for k, v in vals.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", ["fresh", "cache"])
def test_slstm_forward_matches_jax(start, dtype):
    jc, tc = _configs(dtype)
    jp, tp = _block_params(jssm.init_slstm_params, 4, dtype)
    assert float(tp["b"][2 * 256]) == 1.0 and float(tp["b"][0]) == 0.0
    jx, tx = _act((2, 33, 128), 5, dtype)
    jcache, tcache = _slstm_cache(6) if start == "cache" else (None, None)
    want, jnew = jssm.slstm_forward(jp, jc, jx, cache=jcache)
    got, tnew = tssm.slstm_forward(tp, tc, tx, cache=tcache)
    _close(got, want, dtype)
    if start == "cache":
        assert tnew is tcache
        for k in ("c", "n", "h", "m"):
            assert tnew[k].dtype == torch.float32
            _close(tnew[k], jnew[k])


def test_block_caches_are_jax_caches():
    jc, tc = _configs()
    for jinit, tinit in ((jssm.init_mlstm_cache, tssm.init_mlstm_cache),
                         (jssm.init_slstm_cache, tssm.init_slstm_cache)):
        want = jinit(jc, 3, jnp.bfloat16)
        got = tinit(tc, 3, torch.bfloat16, lead=(2,))
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == (2,) + w.shape
            assert str(got[k].dtype).split(".")[1] == str(w.dtype)
            np.testing.assert_array_equal(got[k][1].float().numpy(), _np(w))


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
    toks = _tokens(512, (2, 70), 0)
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
    toks, cont = _tokens(512, (2, 40), 1), _tokens(512, (2, 3), 2)
    jlg, jcache = jsteps.make_prefill_step(jc, 48)(jp, jnp.asarray(toks))
    tlg, tcache = tsteps.make_prefill_step(tc, 48)(tp, torch.from_numpy(toks))
    _close(tlg, jlg)
    for i in range(3):
        jlg, jcache = jsteps.make_decode_step(jc)(jp, jcache, jnp.asarray(40 + i, jnp.int32),
                                                  jnp.asarray(cont[:, i:i + 1]))
        tlg, tcache = tsteps.make_decode_step(tc)(tp, tcache, 40 + i,
                                                  torch.from_numpy(cont[:, i:i + 1]))
        _close(tlg, jlg)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jcache)[0]}
    tflat = flatten(tcache)
    assert len(tflat) == len(jflat) == 3 * 3 + 4  # 3 mLSTM layers x 3 leaves, 1 sLSTM x 4
    for got, want in zip(tflat.values(), jflat.values(), strict=True):
        _close(torch.from_numpy(np.asarray(got, np.float32)), want)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_one_train_step_matches_jax(remat):
    jc, tc = _configs(remat=remat)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jstate.params))
    tstate = tsteps.TrainState(tp, AdamState(0, *(tt.params_from_numpy(jax.tree.map(
        np.asarray, t)) for t in (jstate.opt.mu, jstate.opt.nu))), 0)
    toks = _tokens(512, (2, 70), 3)
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
    # the first AdamW step moves an entry by lr g / (|g| + 1e-8): a sign
    # where |g| >= SIGN_GRAD, but it swings by up to lr where |g| is within
    # float32 rounding of the leaf's sums (|g| ~ 1e-9 here, 1e-7 of the
    # largest gradient); those entries are held by the moments above
    held = total = 0
    for got, want, mu in zip(tree_leaves(tnew.params), jax.tree.leaves(jnew.params),
                             jax.tree.leaves(jnew.opt.mu), strict=True):
        sign = np.abs(np.asarray(mu)) / 0.1 >= SIGN_GRAD  # g = mu / (1 - b1) after one step
        held, total = held + int(sign.sum()), total + sign.size
        np.testing.assert_allclose(got.numpy()[sign], np.asarray(want)[sign], rtol=0,
                                   atol=PARAM_ATOL)
    assert held > total // 2


def test_xlstm_decode_long_chain():
    """Mirror of tests/test_runtime_integration.py:62-76: prefill 16, then
    20 decode steps == the uncached forward (matrix + scalar memory)."""
    cfg = treg.get_smoke("xlstm-350m")
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg)
    prompt = torch.from_numpy(_tokens(cfg.vocab_size, (2, 16), 3))
    cont = torch.from_numpy(_tokens(cfg.vocab_size, (2, 20), 4))
    _, cache = tsteps.make_prefill_step(cfg, cache_len=48)(state.params, prompt)
    dec = tsteps.make_decode_step(cfg)
    outs = []
    for i in range(20):
        lg, cache = dec(state.params, cache, 16 + i, cont[:, i:i + 1])
        outs.append(lg)
    full, _, _ = tt.forward(state.params, cfg, torch.cat([prompt, cont], 1))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, 16:].numpy(), atol=5e-4)


def test_train_step_finite_and_decreases():
    """Mirror of tests/test_models.py:76-86 for ``xlstm``: 8 steps on one
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


def test_decode_matches_full_forward():
    """Mirror of tests/test_models.py:89-100 for ``xlstm``: prefill(S) +
    decode(1) == the uncached forward over S + 1 tokens."""
    _, tc = _configs()
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), tc)
    toks = torch.from_numpy(_tokens(256, (2, 32), 0))
    _, cache = tsteps.make_prefill_step(tc, cache_len=40)(state.params, toks)
    lg, _ = tsteps.make_decode_step(tc)(state.params, cache, 32, toks[:, :1])
    full, _, _ = tt.forward(state.params, tc, torch.cat([toks, toks[:, :1]], 1))
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), atol=2e-4)


def test_xlstm_350m_parameter_tree_is_jax_tree():
    jc, tc = jreg.get_smoke("xlstm-350m"), treg.get_smoke("xlstm-350m")
    jp = jax.eval_shape(lambda: jt.init_model_params(jax.random.PRNGKey(0), jc))
    tp = tt.init_model_params(torch.Generator().manual_seed(0), tc)
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = flatten(tp)
    assert len(tflat) == len(jflat)
    for (tk, tv), (jk, jv) in zip(tflat.items(), jflat.items(), strict=True):
        assert jk.replace("['", "").replace("']", "/").replace("[", "").replace("]", "/") \
            .rstrip("/") == tk
        assert tv.shape == jv.shape and tv.dtype == jv.dtype == np.float32
    # the gate biases: input 0, forget 3 (mLSTM); forget 1 (sLSTM)
    b_if = tp["stack"]["b0"]["mix"]["b_if"]
    assert b_if.tolist() == [[0.0] * 4 + [3.0] * 4]
    b = tp["stack"]["b1"]["mix"]["b"][0]
    assert float(b[2 * 256:3 * 256].min()) == float(b[2 * 256:3 * 256].max()) == 1.0
    assert float(b[:2 * 256].abs().max()) == float(b[3 * 256:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_full_width_xlstm_decode_on_the_card_matches_its_uncached_forward():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: xlstm-350m runs at full width on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tc = dataclasses.replace(treg.get("xlstm-350m"), dtype="float32")
    tp = tt.init_model_params(torch.Generator(dev).manual_seed(0), tc)
    assert sum(a.numel() for a in tree_leaves(tp)) == 590_423_200
    toks = torch.from_numpy(_tokens(tc.vocab_size, (2, 136), 1)).to(dev)
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
    print(f"xlstm-350m fp32 on the card, decode vs uncached: max|d logits| {err:.3e}")
    assert err <= 2e-4 * max(1.0, float(want.abs().max())), err
