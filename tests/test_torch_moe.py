"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's.

Same parameters in both packages (JAX's ``init_moe_params`` /
``init_model_params`` carried across with
``models.transformer.params_from_numpy``), same seeded numpy inputs:

  * ``moe_forward``'s output and aux loss equal JAX's at capacity factors
    4.0 and 0.25 and at dispatch groups 1 and 32 (the mirror of
    ``tests/test_models.py::test_moe_capacity_drops_and_aux``: the tight
    capacity drops and changes the output, stays finite, aux in (0.5, 2));
  * the routing integers equal JAX's exactly: the top-k expert ids, each
    assignment's rank within its expert's group and the keep mask (JAX's
    ``jax.lax.top_k`` and stable ``argsort`` ranks, computed here from
    ``src/repro/models/moe.py:75-110``'s formulas);
  * a TIE: two router columns equal, so two experts get the same
    probability; ``jax.lax.top_k`` takes the lower index first and so
    does the port's stable sort;
  * the whole deepseek-moe-16b and qwen3-moe-30b-a3b smoke models'
    logits and aux, in float32 and bfloat16;
  * one training step's loss and gradients against JAX's
    ``value_and_grad`` of its ``_loss_fn``; the aux loss moves the
    router's gradient;
  * the expert-parallel path (``moe_forward(..., group=)``) on 2 spawned
    gloo ranks against the local path: output, aux and gradients, one
    all-reduce a forward; and ``transformer.forward(..., moe_group=)``.

Tolerances: float32 |d| <= 2e-5 max(1, max|ref|) on outputs and logits
(the packages sum matmuls in different orders: ~1e-6 relative seen), aux
2e-6 relative; gradients 1e-4 of each leaf's largest entry, the loss 2e-6
relative (tests/test_torch_lm_train.py's bounds); bfloat16 logits 2**-5
max(1, max|ref|) (tests/test_torch_lm.py's bound) on every token row but
those a router near-tie sends to other experts in the two packages (one
of 64 seen, logits then ~1.3 apart): such a token's swapped experts must
have bf16 router logits at most one bf16 ulp apart in both packages; aux
2e-2 relative. The expert-parallel
path against the local one: the output within 2e-5 absolute (JAX's own
``tests/test_moe_spmd.py`` bound), aux equal (both rank the whole token
set), gradients within 3e-4 absolute (JAX's bound there): x's and the
router's and shared experts' on every rank, each rank's own experts' rows
of the expert leaves (the other rows get no gradient on that rank).

The dispatch scatter adds at most one nonzero row to a slot (a dropped
assignment adds 0 * x), so it is exact in any order; the combine adds a
token's K rows in index order; on the card (``cuda``-marked, skipped
here) the same training step twice is held BITWISE, and the forward at
smoke size in float32 to JAX's CPU forward.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import pickle
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.runtime import steps as jsteps
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.runtime import steps as tsteps

FP32_RTOL = 2e-5
AUX_RTOL = 2e-6
BF16_RTOL = 2.0**-5
BF16_AUX_RTOL = 2e-2
GRAD_RTOL = 1e-4
LOSS_RTOL = 2e-6
SPMD_ATOL = 2e-5
SPMD_GRAD_ATOL = 3e-4
JOIN_TIMEOUT_S = 120

# tests/test_models.py's "moe" config
BASE = dict(name="t-moe", arch_type="moe", num_layers=3, d_model=128, num_heads=4,
            num_kv_heads=4, d_ff=256, vocab_size=512, dtype="float32")
MOE = dict(num_experts=4, top_k=2, d_expert=64, num_shared=1, first_layer_dense=True,
           dense_d_ff=256, capacity_factor=4.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**moe_kw):
    moe = dict(MOE, **moe_kw)
    return (JModelConfig(**BASE, moe=JMoEConfig(**moe)),
            TModelConfig(**BASE, moe=TMoEConfig(**moe)))


@functools.cache
def _jax_moe_params():
    jc, _ = _configs()
    return jmoe.init_moe_params(jax.random.PRNGKey(0), jc)


def _params(tie: bool = False):
    jp = _jax_moe_params()
    if tie:
        jp = dict(jp, router=jp["router"].at[:, 2].set(jp["router"][:, 1]))
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(shape=(2, 16, 128), seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got: torch.Tensor, want, rtol: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


def _jax_routing(jp, cfg, x):
    """JAX's routing integers by src/repro/models/moe.py:75-110's formulas:
    (expert ids (T, K), ranks (G, Tg*K), keep (G, Tg*K))."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    T = xt.shape[0]
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), axis=-1)
    _, ids = jax.lax.top_k(probs, K)
    G = m.dispatch_groups
    while T % G:
        G //= 2
    Tg = T // G
    Cg = max(int(m.capacity_factor * Tg * K / E), 1)

    def group_ranks(eid_flat):
        order = jnp.argsort(eid_flat, stable=True)
        counts = jnp.zeros((E,), jnp.int32).at[eid_flat].add(1)
        seg_start = jnp.cumsum(counts) - counts
        rank_sorted = jnp.arange(Tg * K, dtype=jnp.int32) - seg_start[eid_flat[order]]
        return jnp.zeros((Tg * K,), jnp.int32).at[order].set(rank_sorted)

    ranks = jax.vmap(group_ranks)(ids.reshape(G, Tg * K))
    return np.asarray(ids), np.asarray(ranks), np.asarray(ranks < Cg), np.asarray(probs)


def _port_routing(tp, cfg, x):
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    probs, _, ids, _ = tmoe.route(tp, cfg, xt)
    G, Tg, Cg = tmoe.dispatch_layout(cfg, xt.shape[0])
    ranks = tmoe.group_ranks(ids.reshape(G, Tg * cfg.moe.top_k), cfg.moe.num_experts)
    return ids.numpy(), ranks.numpy(), (ranks < Cg).numpy(), probs.numpy()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 32])
@pytest.mark.parametrize("capacity", [4.0, 0.25])
def test_moe_forward_matches_jax(capacity, groups):
    jc, tc = _configs(capacity_factor=capacity, dispatch_groups=groups)
    jp, tp = _params()
    x = _x()
    want, waux = jmoe.moe_forward(jp, jc, jnp.asarray(x))
    got, aux = tmoe.moe_forward(tp, tc, torch.from_numpy(x))
    _close(got, want, FP32_RTOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)
    assert 0.5 < float(aux) < 2.0 and bool(torch.isfinite(got).all())
    jids, jranks, jkeep, _ = _jax_routing(jp, jc, x)
    ids, ranks, keep, _ = _port_routing(tp, tc, x)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(ranks, jranks)
    np.testing.assert_array_equal(keep, jkeep)
    assert keep.all() == (capacity == 4.0 or groups == 32)  # 0.25 over one group drops


def test_tight_capacity_drops_and_changes_the_output():
    """The mirror of tests/test_models.py::test_moe_capacity_drops_and_aux."""
    _, hi = _configs(dispatch_groups=1)
    _, lo = _configs(capacity_factor=0.25, dispatch_groups=1)
    _, tp = _params()
    x = torch.from_numpy(_x())
    with tmoe.routing_log() as log:
        out_hi, aux = tmoe.moe_forward(tp, hi, x)
        out_lo, _ = tmoe.moe_forward(tp, lo, x)
    kept = [(int(k), n) for k, n in log]
    assert kept[0] == (64, 64) and kept[1][0] < 64  # T * K = 64 assignments
    assert bool(torch.isfinite(out_lo).all())
    assert float((out_hi - out_lo).abs().max()) > 1e-6
    assert 0.5 < float(aux) < 2.0


@pytest.mark.parametrize("groups", [1, 32])
def test_tied_router_columns_take_the_lower_expert_first(groups):
    jc, tc = _configs(dispatch_groups=groups)
    jp, tp = _params(tie=True)
    x = _x()
    jids, jranks, jkeep, jprobs = _jax_routing(jp, jc, x)
    ids, ranks, keep, probs = _port_routing(tp, tc, x)
    # the tie is exact in both packages
    assert (jprobs[:, 1] == jprobs[:, 2]).all() and (probs[:, 1] == probs[:, 2]).all()
    tied = ((ids == 1) | (ids == 2)).sum(1) >= 1
    assert tied.sum() > 0
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(ranks, jranks)
    np.testing.assert_array_equal(keep, jkeep)
    # where both tied experts are chosen, 1 comes before 2; where one of
    # them is, it is 1
    both = (ids == 1).any(1) & (ids == 2).any(1)
    assert (ids[both] == [1, 2]).all()
    assert not ((ids == 2).any(1) & ~(ids == 1).any(1)).any()
    want, _ = jmoe.moe_forward(jp, jc, jnp.asarray(x))
    got, _ = tmoe.moe_forward(tp, tc, torch.from_numpy(x))
    _close(got, want, FP32_RTOL)


def test_moe_params_tree_and_distributions():
    jc, tc = _configs()
    jp = _jax_moe_params()
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), tc)
    assert sorted(tp) == sorted(jp) and sorted(tp["shared"]) == sorted(jp["shared"])
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32
    # LeCun normal over the in axis (1 for the stacked experts)
    assert abs(float(tp["w_down"].std()) * np.sqrt(64) - 1) < 0.05
    assert abs(float(tp["w_gate"].std()) * np.sqrt(128) - 1) < 0.05
    no_shared = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, num_shared=0))
    assert "shared" not in tmoe.init_moe_params(torch.Generator().manual_seed(0), no_shared)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

SMOKE = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]


@functools.cache
def _jax_model(arch: str):
    return jt.init_model_params(jax.random.PRNGKey(0), jreg.get_smoke(arch))


def _model(arch: str, dtype: str = "float32"):
    jc = dataclasses.replace(jreg.get_smoke(arch), dtype=dtype)
    tc = dataclasses.replace(treg.get_smoke(arch), dtype=dtype)
    jp = _jax_model(arch)
    return jc, tc, jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _record_moe_inputs(monkeypatch) -> tuple[list, list]:
    """Record every MoE layer's (input, router) in both packages' forward
    (JAX's from inside its layer scan, in order)."""
    jlog, tlog = [], []
    jorig, torig = jmoe.moe_forward, tmoe.moe_forward

    def jax_moe(p, cfg, x):
        jax.debug.callback(lambda xx, r: jlog.append((np.asarray(xx), np.asarray(r))),
                           x, p["router"], ordered=True)
        return jorig(p, cfg, x)

    def port_moe(p, cfg, x, *, group=None):
        tlog.append((x.detach().clone(), p["router"].detach().clone()))
        return torig(p, cfg, x, group=group)

    monkeypatch.setattr(jmoe, "moe_forward", jax_moe)
    monkeypatch.setattr(tmoe, "moe_forward", port_moe)
    return jlog, tlog


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0**-126))) - 7)


def _flipped_tokens(jlog, tlog, cfg) -> np.ndarray:
    """(T,) True where some MoE layer sends the token to other top-k
    experts in the two packages. Each such token is asserted to be a
    near-tie: every expert only JAX picks and every expert only the port
    picks have bfloat16 router logits at most one bf16 ulp apart, in JAX's
    logits and in the port's."""
    K = cfg.moe.top_k
    flipped = None
    assert len(jlog) == len(tlog) > 0
    for (jx, jr), (tx, tr) in zip(jlog, tlog, strict=True):
        D = jx.shape[-1]
        jxt = jnp.asarray(jx).reshape(-1, D)
        jlogits = np.asarray((jxt @ jnp.asarray(jr).astype(jxt.dtype)).astype(jnp.float32))
        _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(jlogits), axis=-1), K)
        txt = tx.reshape(-1, D)
        tlogits = (txt @ tr.to(txt.dtype)).to(torch.float32).numpy()
        tids = tmoe.route({"router": tr}, cfg, txt)[2].numpy()
        jids = np.asarray(jids)
        layer = np.array([set(a) != set(b) for a, b in zip(jids, tids, strict=True)])
        for t in np.flatnonzero(layer):
            only_j = sorted(set(jids[t]) - set(tids[t]))
            only_t = sorted(set(tids[t]) - set(jids[t]))
            for lg in (jlogits[t], tlogits[t]):
                for a in only_j:
                    for b in only_t:
                        gap = abs(float(lg[a]) - float(lg[b]))
                        assert gap <= _bf16_ulp(max(abs(lg[a]), abs(lg[b]))), (t, a, b, gap)
        flipped = layer if flipped is None else flipped | layer
    return flipped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_model_logits_and_aux_match_jax(arch, dtype, monkeypatch):
    jc, tc, jp, tp = _model(arch, dtype)
    toks = _tokens(jc, (2, 32), 0)
    jlog, tlog = _record_moe_inputs(monkeypatch)
    want, _, waux = jt.forward(jp, jc, jnp.asarray(toks))
    got, cache, aux = tt.forward(tp, tc, torch.from_numpy(toks))
    assert cache is None and ("prelude" in tp) == (arch == "deepseek-moe-16b")
    if dtype == "float32":
        _close(got, want, FP32_RTOL)
        np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)
        return
    # bfloat16: the packages round activations differently, so a router
    # near-tie can send a token to another expert (1 token of 64 seen);
    # that token's row is exempt, every other row holds the bf16 bound
    flipped = _flipped_tokens(jlog, tlog, tc)
    want = np.asarray(want, np.float32).reshape(flipped.size, -1)
    err = np.abs(got.float().numpy().reshape(flipped.size, -1) - want)
    ok = (err <= BF16_RTOL * max(1.0, float(np.abs(want).max()))).all(-1)
    assert ok[~flipped].all(), np.flatnonzero(~ok & ~flipped)
    np.testing.assert_allclose(float(aux), float(waux), rtol=BF16_AUX_RTOL)


@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_model_prefill_and_decode_match_jax(arch):
    jc, tc, jp, tp = _model(arch)
    toks, cont = _tokens(jc, (2, 16), 1), _tokens(jc, (2, 3), 2)
    jlg, jcache = jsteps.make_prefill_step(jc, 20)(jp, jnp.asarray(toks))
    tlg, tcache = tsteps.make_prefill_step(tc, 20)(tp, torch.from_numpy(toks))
    _close(tlg, jlg, FP32_RTOL)
    for i in range(3):
        jlg, jcache = jsteps.make_decode_step(jc)(jp, jcache, jnp.asarray(16 + i, jnp.int32),
                                                  jnp.asarray(cont[:, i:i + 1]))
        tlg, tcache = tsteps.make_decode_step(tc)(tp, tcache, torch.tensor(16 + i),
                                                  torch.from_numpy(cont[:, i:i + 1]))
        _close(tlg, jlg, FP32_RTOL)
    assert sorted(tcache) == sorted(jcache)
    for got, want in zip(tree_leaves(tcache), jax.tree.leaves(jcache), strict=True):
        _close(got, want, FP32_RTOL)


@pytest.mark.parametrize("arch", SMOKE)
def test_one_training_step_loss_and_gradients_match_jax(arch):
    jc, tc, jp, tp = _model(arch)
    toks = _tokens(jc, (2, 16), 3)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    (jloss, (jce, jaux)), jgrads = jax.value_and_grad(jsteps._loss_fn, has_aux=True)(
        jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, ce, aux), grads = tsteps._value_and_grad(
        tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    for got, want in zip(tree_leaves(grads), jax.tree.leaves(jgrads), strict=True):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(want).max()))


def test_aux_loss_moves_the_router_gradient():
    _, tc, _, tp = _model("deepseek-moe-16b")
    toks = torch.from_numpy(_tokens(tc, (2, 16), 4))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    no_aux = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, router_aux_weight=0.0))
    _, g = tsteps._value_and_grad(tp, tc, batch)
    _, g0 = tsteps._value_and_grad(tp, no_aux, batch)
    r, r0 = g["stack"]["b0"]["moe"]["router"], g0["stack"]["b0"]["moe"]["router"]
    assert float(r0.abs().max()) > 0  # the gates carry a gradient to the router alone
    assert float((r - r0).abs().max()) > 1e-6
    assert torch.equal(g["embed"] * 0, g0["embed"] * 0)


# ---------------------------------------------------------------------------
# the expert-parallel path on gloo ranks
# ---------------------------------------------------------------------------

SPMD_MOE = dict(num_experts=8, top_k=2, d_expert=32, num_shared=1, capacity_factor=8.0,
                dispatch_groups=1)
SPMD_BASE = dict(name="t", arch_type="moe", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=4, d_ff=64, vocab_size=128, dtype="float32")


def _spmd_inputs():
    jc = JModelConfig(**SPMD_BASE, moe=JMoEConfig(**SPMD_MOE))
    tc = TModelConfig(**SPMD_BASE, moe=TMoEConfig(**SPMD_MOE))
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jc)
    x = np.random.default_rng(5).normal(size=(8, 16, 64)).astype(np.float32)
    mp = jt.init_model_params(jax.random.PRNGKey(1), jc)
    toks = _tokens(jc, (2, 16), 6)
    return tc, jax.tree.map(np.asarray, jp), x, jax.tree.map(np.asarray, mp), toks


def _layer_grads(tp, tc, x, group=None):
    leaves = [a.detach().requires_grad_(True) for a in tree_leaves(tp)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), tp)
    xs = x.detach().requires_grad_(True)
    out, aux = tmoe.moe_forward(live, tc, xs, group=group)
    (out.sum() + aux).backward()
    return out.detach(), aux.detach(), [a.grad for a in leaves], xs.grad


def _spmd_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            tc, jp, x, mp, toks = _spmd_inputs()
            tp = tt.params_from_numpy(jp)
            tmoe.reset_collectives()
            with torch.no_grad():
                out, aux = tmoe.moe_forward(tp, tc, torch.from_numpy(x), group=dist.group.WORLD)
            forward_only = dict(tmoe.COLLECTIVES)
            res = {"out": out.numpy(), "aux": float(aux), "forward_only": forward_only}
            o, a, g, gx = _layer_grads(tp, tc, torch.from_numpy(x), dist.group.WORLD)
            res.update(grad_out=o.numpy(), grads=[t.numpy() for t in g], grad_x=gx.numpy(),
                       with_backward=dict(tmoe.COLLECTIVES))
            with torch.no_grad():
                logits, _, maux = tt.forward(tt.params_from_numpy(mp), tc, torch.from_numpy(toks),
                                             moe_group=dist.group.WORLD)
            res.update(logits=logits.numpy(), model_aux=float(maux))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — a rank reports its failure to the parent
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def spmd_run(tmp_path_factory):
    import multiprocessing as mp

    out = tmp_path_factory.mktemp("moe_spmd")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spmd_rank, args=(r, 2, str(out / "store"), str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        assert not any(p.is_alive() for p in procs), "MoE ranks still running"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res["error"]
        results.append(res)
    return results


def test_expert_parallel_forward_matches_the_local_path(spmd_run):
    tc, jp, x, _, _ = _spmd_inputs()
    tp = tt.params_from_numpy(jp)
    with torch.no_grad():
        want, waux = tmoe._moe_forward_local(tp, tc, torch.from_numpy(x))
    for res in spmd_run:
        np.testing.assert_allclose(res["out"], want.numpy(), rtol=0, atol=SPMD_ATOL)
        assert res["aux"] == float(waux)
        # one all-reduce a forward, none in a forward without autograd's backward
        assert res["forward_only"] == {"forward_all_reduce": 1, "backward_all_reduce": 0}
    np.testing.assert_array_equal(spmd_run[0]["out"], spmd_run[1]["out"])


def test_expert_parallel_gradients_match_the_local_path(spmd_run):
    tc, jp, x, _, _ = _spmd_inputs()
    _, _, want, want_x = _layer_grads(tt.params_from_numpy(jp), tc, torch.from_numpy(x))
    names = list(flatten(tt.params_from_numpy(jp)))  # tree_leaves' order
    e_local = tc.moe.num_experts // 2
    for rank, res in enumerate(spmd_run):
        # forward 2 (the no-grad call and this one), backward 2 (x and the gates)
        assert res["with_backward"] == {"forward_all_reduce": 2, "backward_all_reduce": 2}
        np.testing.assert_allclose(res["grad_x"], want_x.numpy(), rtol=0, atol=SPMD_GRAD_ATOL)
        for name, got, w in zip(names, res["grads"], want, strict=True):
            w = w.numpy()
            if name in ("w_gate", "w_up", "w_down"):
                # a rank's own experts' rows; the others' get no gradient here
                mine = slice(rank * e_local, (rank + 1) * e_local)
                np.testing.assert_allclose(got[mine], w[mine], rtol=0, atol=SPMD_GRAD_ATOL)
                others = np.delete(got, np.arange(mine.start, mine.stop), axis=0)
                assert not others.any(), name
            else:
                np.testing.assert_allclose(got, w, rtol=0, atol=SPMD_GRAD_ATOL, err_msg=name)


def test_transformer_forward_with_a_moe_group_matches_the_local_model(spmd_run):
    tc, _, _, mp, toks = _spmd_inputs()
    with torch.no_grad():
        want, _, waux = tt.forward(tt.params_from_numpy(mp), tc, torch.from_numpy(toks))
    for res in spmd_run:
        np.testing.assert_allclose(res["logits"], want.numpy(), rtol=0,
                                   atol=FP32_RTOL * max(1.0, float(want.abs().max())))
        assert res["model_aux"] == float(waux)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the MoE layer's card path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SMOKE)
def test_card_forward_matches_jax_on_the_cpu(cuda_device, arch):
    jc, tc, jp, _ = _model(arch)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), cuda_device)
    toks = _tokens(jc, (2, 32), 0)
    want, _, waux = jt.forward(jp, jc, jnp.asarray(toks))
    with torch.no_grad():
        got, _, aux = tt.forward(tp, tc, torch.from_numpy(toks).to(cuda_device))
    _close(got.cpu(), want, FP32_RTOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)


@pytest.mark.cuda
def test_card_training_step_twice_is_bitwise(cuda_device):
    """The same bf16 step from the same state, twice: bitwise on the card
    (the dispatch scatter's atomics add one nonzero row a slot; the
    combine has none)."""
    cfg = dataclasses.replace(treg.get_smoke("deepseek-moe-16b"), dtype="bfloat16")
    toks = torch.from_numpy(_tokens(cfg, (4, 64), 7)).to(cuda_device)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    step = tsteps.make_train_step(cfg, learning_rate=1e-3)
    runs = []
    for _ in range(2):
        state = tsteps.init_train_state(torch.Generator(cuda_device).manual_seed(0), cfg)
        state, metrics = step(state, batch)
        runs.append((tree_leaves(state.params), float(metrics["loss"])))
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0], strict=True))
