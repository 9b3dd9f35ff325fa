"""The dry-run's explicit layouts (``repro_torch.sharding.dtensor``), on the CPU.

Held here, over a fake process group whose rank is set per case:

  * the three-way split of attention's core (``heads_local``): on ranks
    0, 1 and n - 1 of a 16-wide model axis, the rank's local call on real
    tensors equals the matching heads (a: deepseek-moe-16b's 16 / 16;
    b: qwen3-0.6b's 16 query heads over 8 key heads) or query rows (c:
    qwen2-0.5b's 14 / 2) of the plain ``_sdpa_core``, under a causal mask
    read at the rank's offset, at a few positions;
  * the mLSTM's value-dim split (``batch_local(split=)``): the rank's
    slice of h and C equals the plain chunkwise form's, n whole;
  * the gradients of those splits and of the column-, row- and
    vocab-parallel products: each rank's local gradients, put together as
    their layouts say (a pending sum summed over the ranks), equal the
    plain op's;
  * the PSVGP gather lane's records on both production meshes: JAX's
    breakdown, the loss all-reduced;
  * the pinned cut cells (``launch.pins``): each record's collective kinds
    by model function, its peak and its collective bytes by kind, which
    ``pins.reckoned`` reckons from the shapes where they follow from them
    (held exactly here); no site gathers the logits.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.launch import pins
from repro_torch.launch.mesh import MeshSpec, device_mesh
from repro_torch.models import attention, ssm
from repro_torch.sharding import dtensor

N = 16  # the model axis
RANKS = (0, 1, N - 1)


@pytest.fixture(scope="module", autouse=True)
def _fake_world_torn_down():
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_mesh(rank: int):
    """A 1 x 16 ("data", "model") mesh over a fake group in which this
    process is ``rank``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=rank, world_size=N, store=FakeStore())
    return device_mesh(MeshSpec(("data", "model"), (1, N)))


def _whole(t, dmesh):
    """``t`` as a DTensor every rank holds whole."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, dmesh, [Replicate(), Replicate()], run_check=False)


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("S", [32, 48])
@pytest.mark.parametrize("arch,how", [("deepseek_moe_16b", "heads"), ("qwen3_0_6b", "group"),
                                      ("qwen2_0_5b", "rows")])
def test_heads_local_split_is_the_plain_core(arch, how, S, rank, monkeypatch):
    cfg = get(arch)
    H, KV, hd, B = cfg.num_heads, cfg.num_kv_heads, 8, 2
    rng = np.random.default_rng(S + H)
    q, k, v = _randn(rng, B, S, H, hd), _randn(rng, B, S, KV, hd), _randn(rng, B, S, KV, hd)
    mask = attention.causal_mask(S, S)
    full = attention._sdpa_core(q, k, v, mask, KV)

    local = []
    core = attention._sdpa_core

    def record(*a):
        out = core(*a)
        local.append(out)
        return out

    monkeypatch.setattr(attention, "_sdpa_core", record)
    dmesh = _rank_mesh(rank)
    attention._sdpa(*(_whole(t, dmesh) for t in (q, k, v)), mask, KV)
    (got,) = local
    if how == "rows":  # S/n query rows from rank * S/n, every head
        assert H % N  # 14 query heads do not split over 16
        want = full[:, rank * S // N:(rank + 1) * S // N]
    else:  # H/n query heads from rank * H/n (and, grouped, their one key head)
        assert (KV % N == 0) == (how == "heads")
        want = full[:, :, rank * H // N:(rank + 1) * H // N]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("S", [64, 100])
def test_mlstm_value_dim_split_is_the_plain_chunks(S, rank):
    B, H, dh = 2, 4, 2 * N  # xlstm-350m's 4 heads; dh cut from 512
    rng = np.random.default_rng(S)
    q, k, v = (_randn(rng, B, H, S, dh) for _ in range(3))
    i_gate = torch.exp(torch.clamp_max(_randn(rng, B, H, S), 8.0))
    f_gate = torch.sigmoid(_randn(rng, B, H, S) + 3.0)
    state, norm = _randn(rng, B, H, dh, dh), _randn(rng, B, H, dh)
    args = (q, k, v, i_gate, f_gate, state, norm)
    h, c, n = ssm._mlstm_chunks(*args, S, 64)

    dmesh = _rank_mesh(rank)
    hd, cd, nd = dtensor.batch_local(lambda *a: ssm._mlstm_chunks(*a, S, 64),
                                     tuple(_whole(t, dmesh) for t in args),
                                     split=(None, None, 3, None, None, 3, None),
                                     out_split=(3, 3, None))
    cols = slice(rank * dh // N, (rank + 1) * dh // N)
    torch.testing.assert_close(hd.to_local(), h[..., cols], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cd.to_local(), c[..., cols], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nd.to_local(), n, rtol=0, atol=0)  # every rank whole


def _summed_grads(call, operands, model_pl, upstream, monkeypatch):
    """The gradients of ``operands`` that ``call`` gives, rank by rank
    over the fake group and put together as their layouts say: each
    operand is laid out over the model axis as ``model_pl`` says (a
    DTensor placement), every ``_to_local`` is recorded with the model
    axis's placement of its gradient, and each rank backpropagates its
    own part of ``upstream`` (the outputs' gradients) from its local
    outputs to the local operands it took. A gradient split over the
    model axis is concatenated, a pending sum (``Partial``) summed over
    the ranks, and a replicated one must be the same on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    real = dtensor._to_local
    seen = []

    def record(a, dmesh, placements, grad=None):
        local = real(a, dmesh, placements, grad)
        seen.append((a, (grad or placements)[1], local))
        return local

    monkeypatch.setattr(dtensor, "_to_local", record)
    parts = [[] for _ in operands]
    for rank in range(N):
        dmesh = _rank_mesh(rank)
        seen.clear()
        dts = [DTensor.from_local((t if pl.is_replicate() else t.tensor_split(N, pl.dim)[rank])
                                  .detach().requires_grad_(), dmesh, [Replicate(), pl],
                                  run_check=False) for t, pl in zip(operands, model_pl)]
        outs = call(*dts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ups = [u.tensor_split(N, o.placements[1].dim)[rank] if o.placements[1].is_shard() else u
               for o, u in zip(outs, upstream, strict=True)]
        taken = [next((pl, loc) for a, pl, loc in seen if a is dt) for dt in dts]
        grads = torch.autograd.grad([o.to_local() for o in outs], [loc for _, loc in taken], ups)
        for part, (pl, _), g in zip(parts, taken, grads, strict=True):
            part.append((pl, g))
    out = []
    for part in parts:
        pl = part[0][0]
        assert all(p == pl for p, _ in part)
        if pl.is_shard():
            out.append(torch.cat([g for _, g in part], dim=pl.dim))
        elif pl.is_partial():
            out.append(sum(g for _, g in part))
        else:
            assert all(torch.equal(g, part[0][1]) for _, g in part)
            out.append(part[0][1])
    return out


def _plain_grads(fn, operands, upstream):
    leaves = [t.detach().requires_grad_() for t in operands]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, upstream)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "qwen3_0_6b", "qwen2_0_5b"])
def test_heads_local_gradients_sum_to_the_plain(arch, monkeypatch):
    """(a) heads, (b) a group's key head and (c) query rows: the ranks'
    gradients of q, k and v, put together, are the plain core's."""
    from torch.distributed.tensor import Replicate

    cfg = get(arch)
    H, KV, hd, B, S = cfg.num_heads, cfg.num_kv_heads, 8, 2, 32
    rng = np.random.default_rng(H + KV)
    qkv = [_randn(rng, B, S, H, hd), _randn(rng, B, S, KV, hd), _randn(rng, B, S, KV, hd)]
    mask = attention.causal_mask(S, S)
    up = [_randn(rng, B, S, H, hd)]
    want = _plain_grads(lambda q, k, v: attention._sdpa_core(q, k, v, mask, KV), qkv, up)
    got = _summed_grads(lambda q, k, v: attention._sdpa(q, k, v, mask, KV), qkv,
                        [Replicate()] * 3, up, monkeypatch)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_mlstm_value_split_gradients_sum_to_the_plain(monkeypatch):
    """The value-dim split, n's gradient included: every rank computes n
    whole from the whole q, k and gates, whose gradients sum over the
    ranks, so each backpropagates 1/n of n's gradient."""
    from torch.distributed.tensor import Replicate

    B, H, dh, S = 2, 4, 2 * N, 64
    rng = np.random.default_rng(7)
    q, k, v = (_randn(rng, B, H, S, dh) for _ in range(3))
    i_gate = torch.exp(torch.clamp_max(_randn(rng, B, H, S), 8.0))
    f_gate = torch.sigmoid(_randn(rng, B, H, S) + 3.0)
    args = [q, k, v, i_gate, f_gate, _randn(rng, B, H, dh, dh), _randn(rng, B, H, dh)]
    up = [_randn(rng, B, H, S, dh), _randn(rng, B, H, dh, dh), _randn(rng, B, H, dh)]

    def chunks(*a):
        return ssm._mlstm_chunks(*a, S, 64)

    want = _plain_grads(chunks, args, up)
    got = _summed_grads(lambda *a: dtensor.batch_local(
        chunks, a, split=(None, None, 3, None, None, 3, None), out_split=(3, 3, None)),
        args, [Replicate()] * 7, up, monkeypatch)
    for g, w in zip(got, want, strict=True):  # fp32 sums reordered: to 1e-5 of the largest
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("how", ["column", "row", "vocab"])
def test_product_gradients_sum_to_the_plain(how, monkeypatch):
    """Column- and row-parallel ``linear`` and the LM head
    (``vocab_logits``), the weight split over the model axis as the
    rules lay it out: the ranks' gradients of x and w are the plain
    product's."""
    from torch.distributed.tensor import Replicate, Shard

    rng = np.random.default_rng(len(how))
    x, w = _randn(rng, 2, 8, 2 * N), _randn(rng, 2 * N, 3 * N)
    up = [_randn(rng, 2, 8, 3 * N)]
    want = _plain_grads(lambda x, w: x @ w, [x, w], up)
    if how == "vocab":
        def call(x, w):
            return dtensor.vocab_logits(x, w, lambda h, ww, v0: h @ ww)
    else:
        call = dtensor.linear
    w_pl = Shard(0) if how == "row" else Shard(1)
    got = _summed_grads(call, [x, w], [Replicate(), w_pl], up, monkeypatch)
    for g, ww in zip(got, want, strict=True):
        torch.testing.assert_close(g, ww, rtol=1e-5, atol=1e-5)


def test_plain_tensors_go_straight_in():
    x, w = torch.randn(2, 3, 4), torch.randn(4, 5)
    assert torch.equal(dtensor.linear(x, w), x @ w)
    starts = []

    def logits(h, ww, v0):
        starts.append(v0)
        return h @ ww

    assert torch.equal(dtensor.vocab_logits(x, w, logits), x @ w)
    assert starts == [0]


@functools.cache
def _record(name: str) -> dict:
    torch.set_num_threads(1)
    return pins.trace_cell(name)


@pytest.mark.parametrize("name", list(pins.CELLS))
def test_pinned_cell(name):
    got = _record(name)
    assert pins.check(name, got) == []
    arch, shape, layers, _ = pins.CELLS[name]
    want = pins.reckoned(name)
    if want is not None and shape == "train_4k":  # all but the parameters' gradient sums
        assert got["kinds"]["all-gather"] == want["all-gather"]
        assert want["all-reduce"] < got["kinds"]["all-reduce"] < want["all-reduce"] * 1.05
    elif want is not None:  # every collective follows from the shapes
        assert got["kinds"] == want
    if arch == "psvgp":
        return
    cfg = get(arch)
    B_l = {"prefill_32k": 32, "train_4k": 256}[shape] // N  # batch rows a device
    S = {"prefill_32k": 32_768, "train_4k": 4_096}[shape] if layers else 128
    # the local logits shard (fp32) is live; the whole logits are never gathered
    assert got["peak"] >= B_l * S * cfg.padded_vocab_size // N * 4
    assert got["largest"] < B_l * S * cfg.padded_vocab_size * 4


@pytest.mark.parametrize("multi_pod,gathered", [(False, 1146880), (True, 2293760)])
def test_gather_lane_record_is_jax(multi_pod, gathered):
    """JAX's ``--psvgp --comm gather`` records on 16 x 16 and 2 x 16 x 16."""
    from repro_torch.launch import dryrun

    rec = dryrun.dryrun_psvgp(multi_pod=multi_pod, comm="gather", verbose=False)
    assert rec["collective_breakdown"] == {"all-gather": gathered, "all-reduce": 4}

