"""The LM train step's spans and counters (``repro_torch.trace``), on the
CPU at DeepSeek-V2-Lite's smoke size: the step's spans nest under
``lm.train_step``; the expert layers' counters match a hand count of the
routing; with the tracer off nothing is stamped and the step's bits are
the traced step's.
"""
from __future__ import annotations

import collections

import pytest
import torch

from repro_torch import configs, trace
from repro_torch.models import attention, moe, transformer
from repro_torch.models.common import rms_norm
from repro_torch.optim.adam import tree_leaves, tree_map
from repro_torch.runtime import steps

B, S = 2, 16
LAYER_SPANS = ("mla.attention", "moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.set_enabled(False)
    trace.drain()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    trace.set_enabled(False)
    trace.drain()
    torch.set_num_threads(before)


def _problem():
    cfg = configs.get_smoke("deepseek-v2-lite-ep8")
    state = steps.init_train_state(torch.Generator().manual_seed(4), cfg)
    ids = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(5))
    return cfg, state, {"tokens": ids[:, :-1], "targets": ids[:, 1:]}


def _traced_step(cfg, state, batch):
    trace.set_enabled(True)
    try:
        out = steps.make_train_step(cfg, 1e-3, in_place=True)(state, batch)
    finally:
        trace.set_enabled(False)
    return out, trace.drain()


def test_the_steps_spans_nest_under_its_root():
    cfg, state, batch = _problem()
    _, drained = _traced_step(cfg, state, batch)
    spans = drained["spans"]
    assert drained["dropped"] == 0
    roots = [s for s in spans if s["name"] == "lm.train_step"]
    assert len(roots) == 1 and roots[0]["parent_id"] is None
    root = roots[0]
    assert all(s["trace_id"] == root["span_id"] for s in spans)
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        if s is not root:
            assert s["parent_id"] in by_id
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
    direct = [s["name"] for s in spans if s["parent_id"] == root["span_id"]]
    assert direct[-2:] == ["lm.clip", "lm.adamw"]
    counts = collections.Counter(s["name"] for s in spans)
    moe_layers = cfg.num_layers - 1
    # every layer's forward, and again in the backward's recomputation of the periods
    assert counts["mla.attention"] == 1 + 2 * moe_layers
    for name in LAYER_SPANS[1:]:
        assert counts[name] == 2 * moe_layers
    adamw = next(s for s in spans if s["name"] == "lm.adamw")
    assert adamw["attrs"]["elements"] == sum(a.numel() for a in tree_leaves(state.params))
    assert "device_ms" not in adamw["attrs"]  # no CUDA events off the card


def test_the_expert_counters_match_a_hand_count():
    cfg, state, batch = _problem()
    params = tree_map(torch.clone, state.params)
    _, drained = _traced_step(cfg, state, batch)
    experts = [s["attrs"] for s in drained["spans"] if s["name"] == "moe.experts"]
    dropped = [s["attrs"]["dropped"] for s in drained["spans"] if s["name"] == "moe.combine"]
    # the first MoE layer's routing by hand, from the same input
    with torch.no_grad():
        p = tree_map(lambda a: a[0], params["stack"]["b0"]["moe"])
        h = _moe_input(params, cfg, batch["tokens"])
        _, _, ids, _ = moe.route(p, cfg, h.reshape(B * S, -1), batch=B)
    m = cfg.moe
    held = ((ids >= m.experts_first) & (ids < m.experts_first + m.held)).reshape(-1)
    per_expert = torch.bincount(ids.reshape(-1)[held] - m.experts_first, minlength=m.held)
    assert experts[0]["assignments"] == int(held.sum())
    assert float(experts[0]["max_load"]) == pytest.approx(
        float(per_expert.max()) / (int(held.sum()) / m.held), rel=1e-6)
    assert all(float(d) == 0 for d in dropped)
    # the backward recomputes the layers in reverse order and routes them the same
    moe_layers = cfg.num_layers - 1
    assert [e["assignments"] for e in experts[:moe_layers]] == \
        [e["assignments"] for e in experts[moe_layers:]][::-1]


def _moe_input(params, cfg, tokens):
    """The first MoE layer's normed input, by the model's own blocks."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1])
    x, _, _ = transformer.layer_forward(params["prelude"], cfg, "mla", x, positions)
    lp = tree_map(lambda a: a[0], params["stack"]["b0"])
    out, _ = attention.mla_forward(lp["mix"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
                                   positions)
    return rms_norm(x + out, lp["ln2"], cfg.norm_eps)


def test_off_stamps_nothing_and_leaves_the_bits():
    cfg, state, batch = _problem()
    copy = steps.TrainState(tree_map(torch.clone, state.params),
                            steps.adam_init(state.params), 0)
    (traced, m1), drained = _traced_step(cfg, state, batch)
    assert drained["spans"]
    untraced, m2 = steps.make_train_step(cfg, 1e-3, in_place=True)(copy, batch)
    assert trace.drain()["spans"] == []
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(tree_leaves(traced.params), tree_leaves(untraced.params), strict=True):
        assert torch.equal(a, b)
