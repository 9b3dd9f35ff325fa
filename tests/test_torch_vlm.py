"""The port's vision stub (the VLM projector, ``models/transformer.py``) against the JAX package's, on the CPU.

Same parameters in both packages (JAX's ``init_model_params`` carried
across with ``models.transformer.params_from_numpy``), same seeded numpy
tokens and patches:

  * a mirror of ``tests/test_models.py:162-175``: the logits are (B, P +
    S, V), the image positions first, and the train step's loss (the text
    region only) equals JAX's;
  * ``forward`` with patches equals JAX's in float32 and bfloat16;
  * prefill with patches, then decode, equal JAX's step for step, and the
    port's own uncached forward;
  * one AdamW step with patches in the batch equals JAX's;
  * the serve CLI's inputs (``launch.serve.lm_request``: prompts, then
    patches, from one ``default_rng``) and the train CLI's patch stream
    (``launch.train.stub_stream``, resumed too) are JAX's draws bitwise;
  * internvl2-76b's smoke config: its parameter tree is JAX's key for key.

Tolerances: ``tests/test_torch_lm.py``'s — float32 5e-5 x max(1,
max|logits|), bfloat16 2**-5 x max(1, max|logits|); the train step's loss
2e-6 relative and its parameters 5e-5 absolute
(``tests/test_torch_lm_train.py``).

On the card (``cuda``-marked, skipped here): internvl2-76b's published
width at 2 layers, prefill with 256 patches and decode against its
uncached forward in float32.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import VisionStubConfig as JVision
from repro.runtime import steps as jsteps
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import registry as treg
from repro_torch.launch.serve import generate, lm_request
from repro_torch.launch.train import stub_stream
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import VisionStubConfig as TVision
from repro_torch.optim import AdamState, tree_leaves
from repro_torch.runtime import steps as tsteps

B, S, P, VIT = 2, 32, 8, 96
FP32_RTOL, BF16_RTOL = 5e-5, 2.0**-5
LOSS_RTOL, PARAM_ATOL = 2e-6, 5e-5

# tests/test_models.py:163-167
T_VLM = dict(name="t-vlm", arch_type="vlm", num_layers=2, d_model=128, num_heads=4,
             num_kv_heads=2, d_ff=256, vocab_size=512, dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype: str = "float32"):
    jc = JModelConfig(**{**T_VLM, "dtype": dtype}, vision=JVision(P, VIT)).validate()
    tc = TModelConfig(**{**T_VLM, "dtype": dtype}, vision=TVision(P, VIT)).validate()
    jp = jt.init_model_params(jax.random.PRNGKey(0), dataclasses.replace(jc, dtype="float32"))
    return jc, tc, jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


def _inputs(seed: int, s: int = S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, s)).astype(np.int32)
    patches = rng.normal(size=(B, P, VIT)).astype(np.float32)
    return toks, patches


def _close(got: torch.Tensor, want, rtol: float = FP32_RTOL) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_vlm_patches_prepended():
    """Mirror of tests/test_models.py:162-175: the image positions come
    first in the logits, and the loss is taken on the text region."""
    jc, tc, jp, tp = _setup()
    toks, patches = _inputs(0)
    logits, _, _ = tt.forward(tp, tc, torch.from_numpy(toks), patches=torch.from_numpy(patches))
    assert logits.shape == (B, P + S, tc.vocab_size)  # image tokens prepended
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1), "patches": patches}
    _, jm = jax.jit(jsteps.make_train_step(jc, learning_rate=1e-3))(
        jsteps.init_train_state(jax.random.PRNGKey(0), jc),
        {k: jnp.asarray(v) for k, v in batch.items()})
    state = tsteps.TrainState(tp, AdamState(0, *(tt.params_from_numpy(jax.tree.map(
        lambda a: np.zeros_like(np.asarray(a)), jp)) for _ in range(2))), 0)
    _, tm = tsteps.make_train_step(tc, learning_rate=1e-3)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(tm["loss"]))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    # the text region's CE, from the prepended logits
    text = tsteps.cross_entropy(logits[:, P:], torch.from_numpy(np.roll(toks, -1, 1)))
    assert abs(float(text) - float(tm["ce"])) <= LOSS_RTOL * float(text)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_patches_matches_jax(dtype):
    jc, tc, jp, tp = _setup(dtype)
    toks, patches = _inputs(1)
    want, _, _ = jt.forward(jp, jc, jnp.asarray(toks), patches=jnp.asarray(patches))
    got, _, _ = tt.forward(tp, tc, torch.from_numpy(toks), patches=torch.from_numpy(patches))
    _close(got, want, FP32_RTOL if dtype == "float32" else BF16_RTOL)
    # without patches the stub is bypassed: the text-only model
    want, _, _ = jt.forward(jp, jc, jnp.asarray(toks))
    got, _, _ = tt.forward(tp, tc, torch.from_numpy(toks))
    assert got.shape == (B, S, tc.vocab_size)
    _close(got, want, FP32_RTOL if dtype == "float32" else BF16_RTOL)


def test_prefill_with_patches_then_decode_matches_jax_and_the_uncached_forward():
    jc, tc, jp, tp = _setup()
    toks, patches = _inputs(2)
    cont = np.random.default_rng(3).integers(0, 512, (B, 4)).astype(np.int32)
    cache_len = P + S + 8
    jlg, jcache = jsteps.make_prefill_step(jc, cache_len)(jp, jnp.asarray(toks),
                                                          patches=jnp.asarray(patches))
    tlg, tcache = tsteps.make_prefill_step(tc, cache_len)(tp, torch.from_numpy(toks),
                                                          patches=torch.from_numpy(patches))
    _close(tlg, jlg)
    outs = []
    for i in range(4):
        pos = P + S + i
        jlg, jcache = jsteps.make_decode_step(jc)(jp, jcache, jnp.asarray(pos, jnp.int32),
                                                  jnp.asarray(cont[:, i:i + 1]))
        tlg, tcache = tsteps.make_decode_step(tc)(tp, tcache, pos,
                                                  torch.from_numpy(cont[:, i:i + 1]))
        _close(tlg, jlg)
        outs.append(tlg)
    for got, want in zip(tree_leaves(tcache), jax.tree.leaves(jcache), strict=True):
        _close(got, want)
    full, _, _ = tt.forward(tp, tc, torch.from_numpy(np.concatenate([toks, cont], 1)),
                            patches=torch.from_numpy(patches))
    np.testing.assert_allclose(torch.stack(outs, 1)[:, :3].numpy(),
                               full[:, P + S:P + S + 3].numpy(), atol=2e-4)


def test_one_train_step_with_patches_matches_jax():
    jc, tc, _, _ = _setup()
    jstate = jsteps.init_train_state(jax.random.PRNGKey(1), jc)
    tstate = tsteps.TrainState(
        tt.params_from_numpy(jax.tree.map(np.asarray, jstate.params)),
        AdamState(0, *(tt.params_from_numpy(jax.tree.map(np.asarray, t))
                       for t in (jstate.opt.mu, jstate.opt.nu))), 0)
    toks, patches = _inputs(4)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1), "patches": patches}
    jnew, jm = jax.jit(jsteps.make_train_step(jc, 1e-3))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = tsteps.make_train_step(tc, 1e-3)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert tuple(tnew.params["projector"]["w1"].shape) == (VIT, 128)
    for got, want in zip(tree_leaves(tnew.params), jax.tree.leaves(jnew.params), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PARAM_ATOL)


def test_serve_cli_draws_the_jax_clis_prompts_and_patches():
    cfg = treg.get_smoke("internvl2-76b")
    prompts, frames, patches = lm_request(cfg, 3, 16, seed=7)
    assert frames is None  # no encoder: the patches follow the prompts
    # src/repro/launch/serve.py:136-144
    rng = np.random.default_rng(7)
    want_p = np.asarray(jnp.asarray(rng.integers(0, cfg.vocab_size, (3, 16)), jnp.int32))
    v = cfg.vision
    want_x = np.asarray(jnp.asarray(rng.normal(size=(3, v.num_patches, v.vit_dim)), jnp.float32))
    np.testing.assert_array_equal(prompts, want_p)
    np.testing.assert_array_equal(patches, want_x)
    assert patches.dtype == np.float32
    assert lm_request(treg.get_smoke("qwen3-0.6b"), 3, 16, seed=7)[1:] == (None, None)


def test_train_cli_patch_stream_is_the_jax_clis_and_resumes():
    cfg = treg.get_smoke("internvl2-76b")
    v = cfg.vision
    # src/repro/launch/train.py:67-78 (no encoder: the patches are the rng's only draws)
    rng = np.random.default_rng(3)
    want = [np.asarray(jnp.asarray(rng.normal(size=(2, v.num_patches, v.vit_dim)), jnp.float32))
            for _ in range(4)]
    got = stub_stream(cfg, 2, 3)
    for w in want:
        frames, patches = next(got)
        assert frames is None
        np.testing.assert_array_equal(patches, w)
    resumed = stub_stream(cfg, 2, 3, skip=2)
    np.testing.assert_array_equal(next(resumed)[1], want[2])
    assert next(stub_stream(treg.get_smoke("qwen3-0.6b"), 2, 3)) == (None, None)


def test_generate_prepends_the_patches_on_the_cpu():
    _, tc, _, tp = _setup()
    toks, patches = _inputs(5)
    out = generate(tp, tc, torch.from_numpy(toks), 4, patches=torch.from_numpy(patches))
    full, _, _ = tt.forward(tp, tc, torch.from_numpy(toks), patches=torch.from_numpy(patches))
    assert out["tokens"].shape == (B, 4)
    assert torch.equal(out["tokens"][:, 0], torch.argmax(full[:, -1], -1))


def test_internvl2_smoke_parameter_tree_is_jax_tree():
    jc, tc = jreg.get_smoke("internvl2-76b"), treg.get_smoke("internvl2-76b")
    jp = jax.eval_shape(lambda: jt.init_model_params(jax.random.PRNGKey(0), jc))
    tp = tt.init_model_params(torch.Generator().manual_seed(0), tc)
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = flatten(tp)
    assert len(tflat) == len(jflat)
    for (tk, tv), (jk, jv) in zip(tflat.items(), jflat.items(), strict=True):
        assert jk.replace("['", "").replace("']", "/").replace("[", "").replace("]", "/") \
            .rstrip("/") == tk
        assert tv.shape == jv.shape and tv.dtype == jv.dtype == np.float32
    w1 = tp["projector"]["w1"]
    assert abs(float(w1.std()) * np.sqrt(tc.vision.vit_dim) - 1) < 0.05  # LeCun normal


@pytest.mark.cuda
def test_full_width_vlm_decode_on_the_card_matches_its_uncached_forward():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: internvl2-76b's published width runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tc = dataclasses.replace(treg.get("internvl2-76b"), dtype="float32", num_layers=2)
    tp = tt.init_model_params(torch.Generator(dev).manual_seed(0), tc)
    v = tc.vision
    gen = torch.Generator(dev).manual_seed(1)
    toks = torch.randint(0, tc.vocab_size, (1, 72), generator=gen, device=dev)
    patches = torch.randn((1, v.num_patches, v.vit_dim), generator=gen, device=dev)
    _, cache = tsteps.make_prefill_step(tc, v.num_patches + 72)(tp, toks[:, :64],
                                                                  patches=patches)
    dec = tsteps.make_decode_step(tc)
    outs = []
    for i in range(8):
        lg, cache = dec(tp, cache, v.num_patches + 64 + i, toks[:, 64 + i:65 + i])
        outs.append(lg)
    with torch.no_grad():
        full, _, _ = tt.forward(tp, tc, toks, patches=patches)
    want = full[:, v.num_patches + 64:]
    err = float((torch.stack(outs, 1) - want).abs().max())
    print(f"internvl2-76b (2 layers) fp32 on the card, decode vs uncached: max|d logits| "
          f"{err:.3e}")
    assert err <= 2e-4 * max(1.0, float(want.abs().max())), err
