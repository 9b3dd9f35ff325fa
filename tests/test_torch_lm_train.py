"""The port's LM training half against the JAX package's, on the CPU.

Same seeded numpy inputs through both packages:

  * ONE ``make_train_step`` step from the same parameters and batch: the
    loss, the AdamW moments (hence the clipped gradient) and the
    parameters after clip + AdamW, without remat, with remat (a
    ``torch.utils.checkpoint`` per period), with ``microbatches=2``
    (accumulate, then average) and with ``attn_q_chunk``;
  * the optimizer and schedule mirrors of ``tests/test_substrate.py:26-62``,
    and ``adamw_update`` / ``global_norm`` / the schedules against JAX's;
    ``tree_map`` over dicts in JAX's sorted-key order, unchanged on the
    NamedTuple trees of the GP;
  * ``synthetic_token_batches`` bitwise JAX's;
  * LM train-state checkpoints both ways: a JAX-saved state loads into
    the port and trains on (the step JAX takes next), a port-saved one
    loads into JAX bitwise, and the port resumes bitwise on the CPU (the
    mirror of ``tests/test_runtime_integration.py:15-38``);
  * an overfit (8 steps on one batch) of each dense test config (the
    mirror of ``tests/test_models.py:76-86``).

Tolerances: the loss 2e-6 relative; the moments 1e-4 of each leaf's
largest entry (float32 gradients summed in different orders); the
parameters after a step 5e-5 absolute, 5% of the lr-1e-3 step: AdamW's
update m / (sqrt(v) + 1e-8) is a sign wherever |g| >> 1e-8 and swings
where a gradient is within rounding of 1e-8 (~2e-5 seen there).

On the card (``cuda``-marked, skipped here): a resume of qwen3-0.6b's
smoke config is bitwise the uninterrupted run. It is on an NVIDIA H100
with torch's default (nondeterministic-allowed) algorithms: the
embedding gather's backward (``index_put_`` with accumulate) gave the
same bits run to run there, as did the same bf16 step taken twice at
full width (``chip_smoke.py`` phase 12).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_train_state as jload
from repro.checkpoint import save_train_state as jsave
from repro.configs import get_smoke as jget_smoke
from repro.data.tokens import synthetic_token_batches as jbatches
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adam_init as jadam_init
from repro.optim import adamw_update as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import global_norm as jglobal_norm
from repro.optim import linear_warmup_cosine as jwarmup
from repro.runtime import steps as jsteps
from repro_torch.checkpoint import load_train_state, save_train_state
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import (
    AdamState,
    adam_init,
    adam_update,
    adamw_update,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import steps as tsteps

LR = 1e-3
LOSS_RTOL = 2e-6
MOMENT_RTOL = 1e-4
PARAM_ATOL = 5e-5

SMALL = dict(name="t-train", arch_type="dense", num_layers=5, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=128, vocab_size=300, qk_norm=True, sliding_window=8,
             block_pattern=("attn", "local_attn"), dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(state) -> list:
    """The tensors of a port TrainState: params, mu, nu (the counters are ints)."""
    return [*tree_leaves(state.params), *tree_leaves(state.opt.mu), *tree_leaves(state.opt.nu)]


def _carry(jstate) -> tsteps.TrainState:
    """A JAX TrainState as the port's: the same leaves, int counters."""
    p = tt.params_from_numpy(jax.tree.map(np.asarray, jstate.params))
    mu = tt.params_from_numpy(jax.tree.map(np.asarray, jstate.opt.mu))
    nu = tt.params_from_numpy(jax.tree.map(np.asarray, jstate.opt.nu))
    return tsteps.TrainState(p, AdamState(int(jstate.opt.step), mu, nu), int(jstate.step))


def _batch(vocab: int, b: int, s: int, seed: int):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _assert_state(tstate, jstate, loss_t, loss_j) -> None:
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    assert int(tstate.step) == int(jstate.step) and int(tstate.opt.step) == int(jstate.opt.step)
    for tree_t, tree_j in ((tstate.opt.mu, jstate.opt.mu), (tstate.opt.nu, jstate.opt.nu)):
        for got, want in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j), strict=True):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=MOMENT_RTOL * float(np.abs(want).max()))
    for got, want in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,microbatches", [
    (dict(remat=False), 1), (dict(remat=True), 1), (dict(), 2), (dict(attn_q_chunk=8), 1),
], ids=["plain", "remat", "microbatches-2", "q-chunk"])
def test_one_train_step_matches_jax(kw, microbatches):
    jc, tc = JModelConfig(**{**SMALL, **kw}), TModelConfig(**{**SMALL, **kw})
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = _carry(jstate)
    toks, tg = _batch(300, 4, 32, 0)
    jnew, jm = jax.jit(jsteps.make_train_step(jc, LR, microbatches=microbatches))(
        jstate, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)})
    tnew, tm = tsteps.make_train_step(tc, LR, microbatches=microbatches)(
        tstate, {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg)})
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    assert abs(float(tm["ce"]) - float(tm["loss"])) == 0.0
    _assert_state(tnew, jnew, tm["loss"], jm["loss"])
    # the state it stepped from is untouched (a functional step, as JAX's)
    assert all(torch.equal(a, torch.from_numpy(np.array(b))) for a, b in zip(
        tree_leaves(tstate.params), jax.tree.leaves(jstate.params), strict=True))


@pytest.mark.parametrize("name", ["dense-gqa", "dense-swa", "qwen3-smoke"])
def test_train_step_finite_and_decreases(name):
    if name == "qwen3-smoke":
        cfg = get_smoke("qwen3-0.6b")
    else:
        extra = (dict(qk_norm=True, qkv_bias=True) if name == "dense-gqa"
                 else dict(sliding_window=16, block_pattern=("local_attn",)))
        cfg = TModelConfig(name="t", arch_type="dense", num_layers=4, d_model=128, num_heads=4,
                           num_kv_heads=2, d_ff=256, vocab_size=512, dtype="float32", **extra)
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    step = tsteps.make_train_step(cfg, learning_rate=1e-3)
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # overfits one batch


def test_cross_entropy_uniform():
    V = 64
    ce = tsteps.cross_entropy(torch.zeros(2, 3, V), torch.zeros(2, 3, dtype=torch.int32))
    np.testing.assert_allclose(float(ce), np.log(V), rtol=1e-5)


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------


def test_adam_converges_quadratic_on_a_dict():
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = adam_init(params)
    for _ in range(600):
        grads = {"w": 2 * (params["w"] - target)}
        params, state = adam_update(params, grads, state, lr=0.05)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-3)


def test_adamw_decays_unused_weights():
    params = {"w": torch.ones(4)}
    state = adam_init(params)
    zeros = {"w": torch.zeros(4)}
    for _ in range(100):
        params, state = adamw_update(params, zeros, state, lr=1e-2, weight_decay=0.1)
    assert float(params["w"].abs().max()) < 1.0  # decayed toward zero


@pytest.mark.parametrize("max_norm,seed", [(0.1, 1), (0.5, 2), (1.0, 3), (3.7, 4), (10.0, 5)])
def test_clip_by_global_norm(max_norm, seed):
    g = {"a": torch.from_numpy(np.random.default_rng(seed).normal(size=8).astype(np.float32)) * 100}
    clipped = clip_by_global_norm(g, max_norm)
    assert float(global_norm(clipped)) <= max_norm * (1 + 1e-5)
    small = {"a": g["a"] * 1e-6}  # under the bound: unchanged
    assert torch.equal(clip_by_global_norm(small, max_norm)["a"], small["a"])


def test_schedules():
    s = cosine_schedule(1.0, 100, final_frac=0.1)
    assert abs(float(s(torch.tensor(0))) - 1.0) < 1e-6
    assert abs(float(s(torch.tensor(100))) - 0.1) < 1e-6
    w = linear_warmup_cosine(1.0, 10, 110)
    assert float(w(torch.tensor(5))) == pytest.approx(0.5, abs=1e-6)
    assert float(w(torch.tensor(10))) == pytest.approx(1.0, abs=1e-2)
    assert float(constant_schedule(0.3)(torch.tensor(7))) == pytest.approx(0.3)


def test_schedules_match_jax():
    steps = np.arange(0, 130, dtype=np.int32)
    for tf, jf in ((cosine_schedule(3e-4, 100, 0.05), jcosine(3e-4, 100, 0.05)),
                   (linear_warmup_cosine(1e-3, 10, 110), jwarmup(1e-3, 10, 110))):
        got = tf(torch.from_numpy(steps)).numpy()
        want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_adamw_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(0)
    tree = {"z": rng.normal(size=(3, 4)), "a": {"b": rng.normal(size=5), "c": [rng.normal(size=2)]}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    jp, tp = jax.tree.map(jnp.asarray, tree), tt.params_from_numpy(tree)
    js, ts = jadam_init(jp), adam_init(tp)
    for k in range(3):
        g = jax.tree.map(lambda a, k=k: (rng.normal(size=a.shape) * 10 ** k).astype(np.float32),
                         tree)
        jg, tg = jclip(jax.tree.map(jnp.asarray, g), 1.0), clip_by_global_norm(
            tt.params_from_numpy(g), 1.0)
        np.testing.assert_allclose(float(global_norm(tg)), float(jglobal_norm(jg)), rtol=1e-6)
        jp, js = jadamw(jp, jg, js, lr=1e-2)
        tp, ts = adamw_update(tp, tg, ts, lr=1e-2)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert ts.step == int(js.step) == 3


def test_tree_map_visits_dicts_in_sorted_order_and_keeps_gp_trees():
    t = {"b": torch.tensor(1.0), "a": [torch.tensor(2.0), {"d": torch.tensor(3.0),
                                                         "c": torch.tensor(4.0)}]}
    assert [float(x) for x in tree_leaves(t)] == [2.0, 4.0, 3.0, 1.0]  # jax.tree.leaves' order
    doubled = tree_map(lambda x: 2 * x, t)
    assert float(doubled["a"][1]["c"]) == 8.0 and isinstance(doubled["a"], list)
    with pytest.raises(ValueError, match="dict keys"):
        tree_map(torch.add, {"a": torch.tensor(1.0)}, {"b": torch.tensor(1.0)})
    # a GP tree (NamedTuples of tensors): the leaves in field order, as before
    from repro_torch.core import psvgp
    from repro_torch.core.partition import make_grid, partition_data
    from repro_torch.core.svgp import SVGPConfig
    from repro_torch.data.spatial import e3sm_like_field

    ds = e3sm_like_field(n=300, seed=0)
    data = partition_data(ds.x, ds.y, make_grid(ds.x, 2, 2))
    cfg = psvgp.PSVGPConfig(svgp=SVGPConfig(num_inducing=3, input_dim=2))
    state = psvgp.init(0, cfg, data)
    fields = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            fields.append(node)
        elif node is not None and not isinstance(node, int):
            for child in node:
                walk(child)

    walk(state.params)
    assert len(fields) == len(tree_leaves(state.params))
    assert all(a is b for a, b in zip(fields, tree_leaves(state.params), strict=True))


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,b,s,seed,start", [(512, 2, 32, 0, 0), (151936, 3, 17, 7, 5),
                                                  (1000, 8, 256, 1, 3)])
def test_synthetic_token_batches_are_jax_bitwise(vocab, b, s, seed, start):
    got = list(synthetic_token_batches(vocab, b, s, seed=seed, num_batches=3, start_row=start))
    want = list(jbatches(vocab, b, s, seed=seed, num_batches=3, start_row=start))
    assert len(got) == len(want) == 3
    for (gt, gg), (wt, wg) in zip(got, want, strict=True):
        assert gt.dtype == wt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gg, wg)


def _data(vocab: int, n: int):
    return list(synthetic_token_batches(vocab, 2, 32, seed=1, num_batches=n))


def test_jax_saved_lm_state_loads_into_the_port_and_trains_on(tmp_path):
    jc = jget_smoke("qwen3-0.6b")
    tc = get_smoke("qwen3-0.6b")
    data = _data(tc.vocab_size, 4)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc)
    jstep = jax.jit(jsteps.make_train_step(jc, LR))
    for toks, tg in data[:3]:
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)})
    jsave(str(tmp_path), 3, jstate)
    template = tsteps.init_train_state(torch.Generator().manual_seed(9), tc)
    restored = load_train_state(str(tmp_path), template)
    assert restored.step == 3 and restored.opt.step == 3
    j_leaves = [*jax.tree.leaves(jstate.params), *jax.tree.leaves(jstate.opt.mu),
                *jax.tree.leaves(jstate.opt.nu)]
    for a, b in zip(_leaves(restored), j_leaves, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    toks, tg = data[3]
    jnext, jm = jstep(jstate, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tg)})
    tnext, tm = tsteps.make_train_step(tc, LR)(
        restored, {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg)})
    _assert_state(tnext, jnext, tm["loss"], jm["loss"])


def test_port_saved_lm_state_loads_into_jax(tmp_path):
    tc = get_smoke("qwen3-0.6b")
    state = tsteps.init_train_state(torch.Generator().manual_seed(0), tc)
    step = tsteps.make_train_step(tc, LR)
    for toks, tg in _data(tc.vocab_size, 2):
        state, _ = step(state, {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tg)})
    save_train_state(str(tmp_path), 2, state)
    template = jsteps.init_train_state(jax.random.PRNGKey(0), jget_smoke("qwen3-0.6b"))
    restored = jload(str(tmp_path), template)
    assert int(restored.step) == 2 and int(restored.opt.step) == 2
    j_leaves = [*jax.tree.leaves(restored.params), *jax.tree.leaves(restored.opt.mu),
                *jax.tree.leaves(restored.opt.nu)]
    for a, b in zip(_leaves(state), j_leaves, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _train(state, step, data):
    metrics = None
    for toks, tg in data:
        state, metrics = step(state, {"tokens": torch.from_numpy(toks).to(_dev(state)),
                                      "targets": torch.from_numpy(tg).to(_dev(state))})
    return state, metrics


def _dev(state):
    return state.params["embed"].device


def _resume(tmp_path, device):
    """(uninterrupted, resumed) states and last losses: 3 steps, save, 3
    more; restore into a fresh template and replay the last 3."""
    cfg = get_smoke("qwen3-0.6b")
    data = _data(cfg.vocab_size, 6)
    step = tsteps.make_train_step(cfg, LR)
    state, _ = _train(tsteps.init_train_state(torch.Generator(device).manual_seed(0), cfg),
                      step, data[:3])
    save_train_state(str(tmp_path), 3, state)
    direct, m_direct = _train(state, step, data[3:])
    template = tsteps.init_train_state(torch.Generator(device).manual_seed(1), cfg)
    restored = load_train_state(str(tmp_path), template)
    assert restored.step == 3 and _dev(restored).type == torch.device(device).type
    resumed, m_resumed = _train(restored, step, data[3:])
    return direct, m_direct, resumed, m_resumed


def test_lm_train_checkpoint_resume_is_bitwise_on_the_cpu(tmp_path):
    direct, m_direct, resumed, m_resumed = _resume(tmp_path, "cpu")
    assert torch.equal(m_direct["loss"], m_resumed["loss"])
    assert direct.step == resumed.step == 6
    for a, b in zip(_leaves(direct), _leaves(resumed), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_lm_train_checkpoint_resume_on_the_card(tmp_path, cuda_device):
    direct, m_direct, resumed, m_resumed = _resume(tmp_path, "cuda")
    assert direct.step == resumed.step == 6
    assert torch.equal(m_direct["loss"], m_resumed["loss"])
    for a, b in zip(_leaves(direct), _leaves(resumed), strict=True):
        assert torch.equal(a, b)


