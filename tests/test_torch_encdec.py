"""The port's encoder-decoder (whisper) against the JAX package's, on the CPU.

Same inputs in both packages: JAX's parameters carried across with
``models.transformer.params_from_numpy``, numpy-seeded frames, activations
and tokens.

  * ``attention.gqa_forward(encoder_kv=)``, the cross-attention (the
    queries of ``wq`` alone, unmasked), float32 and bfloat16;
  * ``transformer._encoder_forward`` with ``enc_proj`` (frontend 64 into
    d_model 128) and without it (frontend = d_model, as whisper-base);
  * the model's logits with frames, float32 and bfloat16; prefill with
    frames, then decode without them: logits and the cross cache
    (``cross_k``/``cross_v``) against JAX's; one AdamW train step with
    remat on and off; learned positions past ``max_position`` clamping to
    its last entry, in the uncached forward and in decode;
  * a mirror of ``tests/test_models.py::test_whisper_style_encdec``;
  * the serve CLI's frames (``launch.serve.lm_request``: prompts, then
    frames, from one ``default_rng``) and the train CLI's frame stream
    (``launch.train.stub_stream``, resumed too) are JAX's draws bitwise;
  * whisper-base's published parameter tree against JAX's ``eval_shape``
    tree (100,167,680 parameters, no ``enc_proj``).

Tolerances: float32 5e-5 x max(1, max|want|) (the packages sum matmuls in
different orders); bfloat16 blocks fed the same bf16 inputs and weights:
4 bf16 units in the last place of the output's largest entry; bfloat16
models: 2 x JAX's own bf16 forward's gap to its float32 forward. The
train step: the loss 2e-6 relative, the moments 1e-4 of each leaf's
largest entry, the parameters 5e-5 absolute wherever |g| >= 1e-6
(``tests/test_torch_xlstm.py``'s bounds, for the same reason).

On the card (``cuda``-marked, skipped here): whisper-base uncut, fp32
prefill with 1,500 frames and decode against its uncached forward.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models.config import EncoderConfig as JEncoderConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import steps as jsteps
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import registry as treg
from repro_torch.launch.serve import lm_request
from repro_torch.launch.train import stub_stream
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.config import EncoderConfig as TEncoderConfig
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import AdamState, tree_leaves, tree_map
from repro_torch.runtime import steps as tsteps

B, S, T = 2, 32, 20
FP32_RTOL = 5e-5
BF16_ULPS = 4
BF16_NOISE_FACTOR = 2.0
LOSS_RTOL, MOMENT_RTOL, PARAM_ATOL = 2e-6, 1e-4, 5e-5
SIGN_GRAD = 1e-6  # 100 x AdamW's eps


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype: str = "float32", frontend: int = 64, **kw):
    """tests/test_models.py:142's t-encdec (frontend 64 into d_model 128)
    in both packages; ``frontend`` 128 leaves out ``enc_proj``."""
    fields = {**dict(name="t-encdec", arch_type="audio", num_layers=2, d_model=128,
                     num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512, dtype=dtype,
                     mlp_kind="gelu", pos_kind="learned", max_position=128), **kw}
    return (JModelConfig(encoder=JEncoderConfig(2, T, frontend), **fields).validate(),
            TModelConfig(encoder=TEncoderConfig(2, T, frontend), **fields).validate())


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _act(shape, seed: int, dtype: str = "float32", scale: float = 1.0):
    """The same seeded array in both packages, in separate buffers."""
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


def _model(dtype: str = "float32", frontend: int = 64, **kw):
    jc, tc = _configs(dtype, frontend, **kw)
    jp = jt.init_model_params(jax.random.PRNGKey(0), dataclasses.replace(jc, dtype="float32"))
    return jc, tc, jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


def _cast(jp, tp, dtype: str):
    """Both trees as ``forward``'s one-shot cast leaves them (>= 2-D leaves
    in ``dtype``)."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    return (jax.tree.map(lambda a: a.astype(jdt) if a.ndim >= 2 else a, jp),
            tree_map(lambda a: a.to(tdt) if a.ndim >= 2 else a, tp))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_cross_attention_matches_jax(dtype):
    jc, tc = _configs(dtype)
    jp = jattn.init_gqa_params(jax.random.PRNGKey(1), jc)
    jp, tp = _cast(jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp)), dtype)
    jx, tx = _act((B, 9, 128), 0, dtype)
    jk, tk = _act((B, T, 4, 32), 1, dtype)
    jv, tv = _act((B, T, 4, 32), 2, dtype)
    positions = np.arange(9) + 50  # ignored: no rope, no mask
    want, jc_out = jattn.gqa_forward(jp, jc, jx, jnp.asarray(positions), encoder_kv=(jk, jv))
    got, tc_out = tattn.gqa_forward(tp, tc, tx, torch.from_numpy(positions), encoder_kv=(tk, tv))
    assert jc_out is None and tc_out is None and got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("frontend", [64, 128], ids=["enc_proj", "no-proj"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_forward_matches_jax(dtype, frontend):
    jc, tc, jp, tp = _model(dtype, frontend)
    assert ("enc_proj" in tp) == ("enc_proj" in jp) == (frontend != 128)
    jp, tp = _cast(jp, tp, dtype)
    jf, tf = _act((B, T, frontend), 3)
    want = jt._encoder_forward(jp, jc, jf)
    got = tt._encoder_forward(tp, tc, tf)
    assert got.shape == (B, T, 128) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_logits_with_frames_match_jax(dtype):
    jc, tc, jp, tp = _model(dtype)
    toks = _tokens(512, (B, S), 0)
    jf, tf = _act((B, T, 64), 1)
    want = np.asarray(jt.forward(jp, jc, jnp.asarray(toks), frames=jf)[0])
    got, cache, aux = tt.forward(tp, tc, torch.from_numpy(toks), frames=tf)
    assert cache is None and float(aux) == 0.0 and got.shape == (B, S, 512)
    if dtype == "float32":
        _close(got, want)
    else:
        w32 = np.asarray(jt.forward(jp, dataclasses.replace(jc, dtype="float32"),
                                    jnp.asarray(toks), frames=jf)[0])
        noise = float(np.abs(want - w32).max())
        gap = float(np.abs(got.numpy() - want).max())
        assert gap <= BF16_NOISE_FACTOR * noise, (gap, noise)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_frames_then_decode_matches_jax(dtype):
    jc, tc, jp, tp = _model(dtype)
    toks, cont = _tokens(512, (B, S), 1), _tokens(512, (B, 3), 2)
    jf, tf = _act((B, T, 64), 3)
    jlg, jcache = jsteps.make_prefill_step(jc, S + 8)(jp, jnp.asarray(toks), frames=jf)
    tlg, tcache = tsteps.make_prefill_step(tc, S + 8)(tp, torch.from_numpy(toks), frames=tf)
    w32 = None
    if dtype == "bfloat16":  # the bf16 prefill's own gap to the float32 one
        w32 = jsteps.make_prefill_step(dataclasses.replace(jc, dtype="float32"), S + 8)(
            jp, jnp.asarray(toks), frames=jf)[0]

    def held(got, want, want32):
        if want32 is None:
            _close(got, want)
        else:
            noise = float(np.abs(_np(want) - _np(want32)).max())
            assert float(np.abs(got.numpy() - _np(want)).max()) <= BF16_NOISE_FACTOR * noise

    held(tlg, jlg, w32)
    # the cache is JAX's tree; the cross keys and values of every layer
    jpaths = [jax.tree_util.keystr(k).replace("['", "").replace("']", "/").replace("[", "")
              .replace("]", "/").rstrip("/")
              for k, _ in jax.tree_util.tree_flatten_with_path(jcache)[0]]
    assert _paths(tcache) == jpaths
    tcross, jcross = tcache["stack"]["b0"], jcache["stack"]["b0"]
    for k in ("cross_k", "cross_v"):
        assert tuple(tcross[k].shape) == jcross[k].shape == (2, B, T, 4, 32)
        assert tcross[k].dtype == getattr(torch, dtype) and str(jcross[k].dtype) == dtype
        _close(tcross[k], jcross[k], dtype)
    cross_v = tcross["cross_v"].clone()
    for i in range(3):
        jlg, jcache = jsteps.make_decode_step(jc)(jp, jcache, jnp.asarray(S + i, jnp.int32),
                                                  jnp.asarray(cont[:, i:i + 1]))
        tlg, tcache = tsteps.make_decode_step(tc)(tp, tcache, S + i,
                                                  torch.from_numpy(cont[:, i:i + 1]))
        if dtype == "float32":
            _close(tlg, jlg)
        else:
            assert bool(torch.isfinite(tlg).all())
    # decode left the cross cache as the prefill wrote it
    assert torch.equal(tcache["stack"]["b0"]["cross_v"], cross_v)


def _paths(tree, prefix: str = "") -> list[str]:
    """The key paths of ``tree`` in ``tree_leaves``' order, joined by "/"."""
    if isinstance(tree, torch.Tensor):
        return [prefix.rstrip("/")]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    return [p for k, v in items for p in _paths(v, f"{prefix}{k}/")]


def test_decode_without_frames_matches_the_uncached_forward():
    """Prefill(S) with frames + 4 decode steps without them == the uncached
    forward over S + 4 tokens with the frames (the JAX package's own
    decode bound, tests/test_models.py:100)."""
    _, tc, _, tp = _model()
    toks = torch.from_numpy(_tokens(512, (B, S + 4), 4))
    _, tf = _act((B, T, 64), 5)
    _, cache = tsteps.make_prefill_step(tc, S + 4)(tp, toks[:, :S], frames=tf)
    dec = tsteps.make_decode_step(tc)
    outs = []
    for i in range(4):
        lg, cache = dec(tp, cache, S + i, toks[:, S + i:S + i + 1])
        outs.append(lg)
    with torch.no_grad():
        full, _, _ = tt.forward(tp, tc, toks, frames=tf)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, S:].numpy(), atol=2e-4)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_one_train_step_matches_jax(remat):
    jc, tc = _configs(remat=remat)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jstate.params))
    tstate = tsteps.TrainState(tp, AdamState(0, *(tt.params_from_numpy(jax.tree.map(
        np.asarray, t)) for t in (jstate.opt.mu, jstate.opt.nu))), 0)
    toks = _tokens(512, (B, S), 6)
    tg = np.roll(toks, -1, axis=1)
    jf, tf = _act((B, T, 64), 7)
    jnew, jm = jax.jit(jsteps.make_train_step(jc, 1e-3))(
        jstate, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg), "frames": jf})
    tnew, tm = tsteps.make_train_step(tc, 1e-3)(
        tstate, {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg),
                 "frames": tf})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    for tree_t, tree_j in ((tnew.opt.mu, jnew.opt.mu), (tnew.opt.nu, jnew.opt.nu)):
        for got, want in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j), strict=True):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=MOMENT_RTOL * float(np.abs(want).max()))
    held = total = 0
    for got, want, mu in zip(tree_leaves(tnew.params), jax.tree.leaves(jnew.params),
                             jax.tree.leaves(jnew.opt.mu), strict=True):
        sign = np.abs(np.asarray(mu)) / 0.1 >= SIGN_GRAD  # g = mu / (1 - b1) after one step
        held, total = held + int(sign.sum()), total + sign.size
        np.testing.assert_allclose(got.numpy()[sign], np.asarray(want)[sign], rtol=0,
                                   atol=PARAM_ATOL)
    assert held > total // 2
    # the encoder's layers took a step too
    assert float((tnew.params["encoder"]["b0"]["mix"]["wq"] - tp["encoder"]["b0"]["mix"]["wq"])
                 .abs().max()) > 0


def test_positions_past_max_position_clamp():
    """Learned positions clamp at max_position - 1: an uncached forward over
    24 tokens at max_position 16 equals JAX's, and so does decoding past it."""
    jc, tc, jp, tp = _model(max_position=16)
    toks = _tokens(512, (B, 24), 8)
    jf, tf = _act((B, T, 64), 9)
    want = jt.forward(jp, jc, jnp.asarray(toks), frames=jf)[0]
    got, _, _ = tt.forward(tp, tc, torch.from_numpy(toks), frames=tf)
    _close(got, want)
    _, cache = tsteps.make_prefill_step(tc, 24)(tp, torch.from_numpy(toks[:, :20]), frames=tf)
    lg, _ = tsteps.make_decode_step(tc)(tp, cache, 20, torch.from_numpy(toks[:, 20:21]))
    _close(lg, want[:, 20])


def test_whisper_style_encdec():
    """Mirror of tests/test_models.py:141: a train step with frames, then a
    prefill with frames and a decode step without them, all finite."""
    _, tc = _configs()
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), tc)
    toks = torch.from_numpy(_tokens(256, (B, S), 10))
    frames = torch.randn((B, T, 64), generator=torch.Generator().manual_seed(11))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1), "frames": frames}
    state, m = tsteps.make_train_step(tc, learning_rate=1e-3)(state, batch)
    assert np.isfinite(float(m["loss"]))
    _, cache = tsteps.make_prefill_step(tc, cache_len=S + 8)(state.params, toks, frames=frames)
    lg, _ = tsteps.make_decode_step(tc)(state.params, cache, S, toks[:, :1])
    assert bool(torch.isfinite(lg).all())


def test_cross_attention_without_frames_or_cache_raises():
    _, tc = _configs()
    tp = tt.init_model_params(torch.Generator().manual_seed(0), tc)
    with pytest.raises(ValueError, match="needs the encoder's output"):
        tt.forward(tp, tc, torch.from_numpy(_tokens(512, (1, 4), 0)))


def test_serve_cli_draws_the_jax_clis_prompts_and_frames():
    cfg = treg.get_smoke("whisper-base")
    prompts, frames, patches = lm_request(cfg, 3, 16, seed=7)
    # src/repro/launch/serve.py:136-142
    rng = np.random.default_rng(7)
    want_p = np.asarray(jnp.asarray(rng.integers(0, cfg.vocab_size, (3, 16)), jnp.int32))
    e = cfg.encoder
    want_f = np.asarray(jnp.asarray(rng.normal(size=(3, e.num_frames, e.frontend_dim)),
                                    jnp.float32))
    np.testing.assert_array_equal(prompts, want_p)
    np.testing.assert_array_equal(frames, want_f)
    assert frames.dtype == np.float32 and patches is None


def test_train_cli_frame_stream_is_the_jax_clis_and_resumes():
    cfg = treg.get_smoke("whisper-base")
    e = cfg.encoder
    # src/repro/launch/train.py:67-72 (no vision stub: the frames are the rng's only draws)
    rng = np.random.default_rng(3)
    want = [np.asarray(jnp.asarray(rng.normal(size=(2, e.num_frames, e.frontend_dim)),
                                   jnp.float32)) for _ in range(4)]
    got = stub_stream(cfg, 2, 3)
    for w in want:
        frames, patches = next(got)
        assert patches is None
        np.testing.assert_array_equal(frames, w)
    np.testing.assert_array_equal(next(stub_stream(cfg, 2, 3, skip=2))[0], want[2])


@pytest.mark.parametrize("arch,smoke,want", [
    ("whisper-base", False, 100_167_680),
    ("whisper-base", True, None),
])
def test_whisper_base_parameter_tree_is_jax_tree(arch, smoke, want):
    get = (jreg.get_smoke, treg.get_smoke) if smoke else (jreg.get, treg.get)
    jc, tc = get[0](arch), get[1](arch)
    jp = jax.eval_shape(lambda: jt.init_model_params(jax.random.PRNGKey(0), jc))
    tp = tt.init_model_params(torch.Generator().manual_seed(0), tc)
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = flatten(tp)
    assert len(tflat) == len(jflat)
    for (tk, tv), (jk, jv) in zip(tflat.items(), jflat.items(), strict=True):
        assert jk.replace("['", "").replace("']", "/").replace("[", "").replace("]", "/") \
            .rstrip("/") == tk
        assert tv.shape == jv.shape and tv.dtype == jv.dtype == np.float32
    n = sum(v.size for v in tflat.values())
    assert n == sum(int(np.prod(v.shape)) for v in jflat.values())
    if want is not None:
        assert n == want
    # enc_proj only where the frontend's width is not d_model's (smoke: 64 != 128)
    assert ("enc_proj" in tp) == smoke
    assert tp["encoder"]["b0"]["ln1"].shape == (tc.encoder.num_layers, tc.d_model)
    assert tp["enc_pos"].shape == (tc.encoder.num_frames, tc.d_model)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: whisper-base runs uncut on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_whisper_base_decode_on_the_card_matches_its_uncached_forward(card):
    tc = dataclasses.replace(treg.get("whisper-base"), dtype="float32")
    tp = tt.init_model_params(torch.Generator(card).manual_seed(0), tc)
    assert sum(a.numel() for a in tree_leaves(tp)) == 100_167_680
    toks = torch.from_numpy(_tokens(tc.vocab_size, (2, 136), 1)).to(card)
    e = tc.encoder
    frames = torch.randn((2, e.num_frames, e.frontend_dim), generator=torch.Generator(card)
                         .manual_seed(2), device=card)
    _, cache = tsteps.make_prefill_step(tc, 136)(tp, toks[:, :128], frames=frames)
    dec = tsteps.make_decode_step(tc)
    outs = []
    for i in range(8):
        lg, cache = dec(tp, cache, 128 + i, toks[:, 128 + i:129 + i])
        outs.append(lg)
    with torch.no_grad():
        full, _, _ = tt.forward(tp, tc, toks, frames=frames)
    want = full[:, 128:136]
    ok = want > -1e29
    err = float((torch.stack(outs, 1) - want)[ok].abs().max())
    print(f"whisper-base fp32 on the card, decode vs uncached: max|d logits| {err:.3e}")
    assert err <= 2e-4 * max(1.0, float(want[ok].abs().max())), err
