"""``repro_torch.trace``, the port's opt-in host tracer, and its spans at the
boundaries of ``psvgp.fit``.

On the CPU: a captured-lane fit's span tree (``psvgp.fit`` rooting
``psvgp.warm_up``, ``psvgp.replay`` and ``psvgp.copy_out``; ``psvgp.init``
its own trace) and an eager fit's single span; the state bitwise the same
with tracing on and off; nothing recorded and no ``record_function``
range entered while off; the bounded buffer counting what it drops; each span,
mapped onto the profiler's clock, inside its own ``record_function`` event
(within a margin that a busy CPU's preemptions stay under) and nested as its
events are. On the card (``cuda``-marked, skipped
without a GPU): a capture traced gives the same projection launches, the
same device ops a replay and a bitwise state as one untraced.
"""
from __future__ import annotations

import collections

import pytest
import torch
from test_torch_scan import _bitwise, _problem

from repro_torch import trace
from repro_torch.core import psvgp
from repro_torch.kernels import launches, svgp_proj

ITERS = 8
MARGIN_NS = 5_000_000  # a span against its profiler event, mapped: room for preemptions


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    trace.set_enabled(False)
    trace.drain()
    yield
    trace.set_enabled(False)
    trace.drain()


def _by_name(spans: list[dict]) -> dict[str, dict]:
    named = {s["name"]: s for s in spans}
    assert len(named) == len(spans), [s["name"] for s in spans]
    return named


def test_captured_fit_span_tree():
    static, _, data = _problem("gather", True, "cpu")
    trace.set_enabled(True)
    psvgp.fit(static, psvgp.init(1, static.cfg, data), data, ITERS, use_scan=True)
    drained = trace.drain()
    assert drained["dropped"] == 0
    spans = _by_name(drained["spans"])
    assert set(spans) == {"psvgp.init", "psvgp.fit", "psvgp.warm_up", "psvgp.replay",
                          "psvgp.copy_out"}
    init, root = spans["psvgp.init"], spans["psvgp.fit"]
    assert init["parent_id"] is None and init["trace_id"] == init["span_id"]
    assert root["parent_id"] is None and root["trace_id"] == root["span_id"] != init["trace_id"]
    for name in ("psvgp.warm_up", "psvgp.replay", "psvgp.copy_out"):
        s = spans[name]
        assert s["parent_id"] == root["span_id"] and s["trace_id"] == root["trace_id"], name
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"], name
    assert root["attrs"] == spans["psvgp.warm_up"]["attrs"] == {}  # the allocator's: CUDA only
    assert spans["psvgp.replay"]["attrs"] == {"replays": ITERS - psvgp.WARMUP_STEPS}
    order = [s["name"] for s in drained["spans"]]  # finished spans, in the order they closed
    assert order == ["psvgp.init", "psvgp.warm_up", "psvgp.replay", "psvgp.copy_out",
                     "psvgp.fit"]


def test_eager_fit_has_one_span_and_each_fit_its_own_trace():
    static, state, data = _problem("ppermute", False, "cpu")
    trace.set_enabled(True)
    psvgp.fit(static, state, data, ITERS)
    psvgp.fit(static, state, data, ITERS, use_scan=True)
    spans = trace.drain()["spans"]
    eager, captured = spans[0], spans[-1]
    assert eager["name"] == captured["name"] == "psvgp.fit"
    assert eager["attrs"] == {}
    assert eager["trace_id"] != captured["trace_id"]
    assert [s["trace_id"] for s in spans[1:]] == [captured["trace_id"]] * (len(spans) - 1)


@pytest.mark.parametrize("use_scan", [False, True], ids=["eager", "captured"])
def test_tracing_leaves_the_state_bitwise(use_scan):
    static, state, data = _problem("gather", True, "cpu")
    plain = psvgp.fit(static, state, data, ITERS, use_scan=use_scan)
    trace.set_enabled(True)
    traced = psvgp.fit(static, state, data, ITERS, use_scan=use_scan)
    assert _bitwise(traced, plain) == []


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    static, state, data = _problem("gather", False, "cpu")
    psvgp.fit(static, psvgp.init(0, static.cfg, data), data, ITERS, use_scan=True)
    drained = trace.drain()
    assert entered == [] and drained["spans"] == [] and drained["dropped"] == 0
    assert trace.span("psvgp.fit") is trace.span("anything")  # the one shared no-op
    trace.set_enabled(True)
    psvgp.fit(static, state, data, ITERS, use_scan=True)
    assert entered == ["psvgp.fit", "psvgp.warm_up", "psvgp.replay", "psvgp.copy_out"]


def test_the_bounded_buffer_counts_what_it_drops(monkeypatch):
    static, state, data = _problem("gather", False, "cpu")
    monkeypatch.setattr(trace._TRACER, "spans", collections.deque(maxlen=3))
    trace.set_enabled(True)
    psvgp.fit(static, state, data, ITERS, use_scan=True)  # 4 spans
    psvgp.fit(static, state, data, ITERS)  # 1 span
    drained = trace.drain()
    assert drained["dropped"] == 2
    assert [s["name"] for s in drained["spans"]] == ["psvgp.copy_out", "psvgp.fit",
                                                     "psvgp.fit"]
    assert trace.drain()["dropped"] == 0  # a drain resets the count


def test_spans_map_onto_the_profilers_clock():
    """Each span, mapped with the tracer's anchor, lies inside its own
    ``record_function`` event, give or take ``MARGIN_NS`` at each end, and
    the mapped spans nest as their events do. (The tight reading, within
    50 us, is held by the span probe's test in ``bench/tests``: one OS
    preemption between the range and the stamp would exceed it.)"""
    static, state, data = _problem("gather", True, "cpu")
    trace.set_enabled(True)
    psvgp.fit(static, state, data, ITERS, use_scan=True)  # record_function's first call is slow
    trace.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        psvgp.fit(static, psvgp.init(2, static.cfg, data), data, ITERS, use_scan=True)
    drained = trace.drain()
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith("psvgp."):
            events.setdefault(e.name, []).append(
                (origin + round(1e3 * e.time_range.start), origin + round(1e3 * e.time_range.end)))
    assert len(drained["spans"]) == 5
    mapped = {}
    for s in drained["spans"]:
        (start, end), = events[s["name"]]
        a = trace.epoch_ns(s["start_ns"], drained["anchor_ns"])
        b = trace.epoch_ns(s["end_ns"], drained["anchor_ns"])
        assert start - MARGIN_NS <= a <= b <= end + MARGIN_NS, s
        mapped[s["name"]] = (a, b)
    root = mapped["psvgp.fit"]
    inner = [mapped[n] for n in ("psvgp.warm_up", "psvgp.replay", "psvgp.copy_out")]
    assert root[0] <= inner[0][0] and inner[-1][1] <= root[1]
    assert all(x[1] <= y[0] for x, y in zip(inner, inner[1:]))  # in order, none overlapping
    assert mapped["psvgp.init"][1] <= root[0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _replay_ops(captured: psvgp.CapturedStep, replays: int = 5) -> int | None:
    """Device ops of ``replays`` replays in the profiler, None where it saw
    no device event."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        captured.replay(replays)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ops) or None


@pytest.mark.cuda
def test_cuda_traced_capture_launches_the_same_and_is_bitwise(cuda_device):
    static, state, data = _problem("gather", True, cuda_device, grid=4, n=2000, m=5, batch=16)
    runs = {}
    for on in (False, True):
        trace.set_enabled(on)
        launches.reset()
        final = psvgp.fit(static, state, data, 40, use_scan=True)
        n_proj = svgp_proj.LAUNCHES["svgp_projection"]
        warm = psvgp.fit(static, state, data, psvgp.WARMUP_STEPS, use_scan=True)
        captured = psvgp.CapturedStep(static, psvgp.device_counters(warm, cuda_device), data)
        torch.cuda.synchronize()
        trace.set_enabled(False)
        runs[on] = (final, n_proj, dict(captured.captured), _replay_ops(captured))
    assert _bitwise(runs[True][0], runs[False][0]) == []
    assert runs[True][1:] == runs[False][1:]
    assert runs[True][1] == 40 and runs[True][2] == {"svgp_projection": 1, "adam_update": 1,
                                                     "minibatch_draws": 1}
    spans = [s for s in trace.drain()["spans"] if s["name"] != "psvgp.init"]
    names = [s["name"] for s in spans]
    assert names[:6] == ["psvgp.warm_up", "psvgp.capture.step", "psvgp.capture",
                         "psvgp.replay", "psvgp.copy_out", "psvgp.fit"]
    named = {s["name"]: s for s in spans[:6]}
    assert set(named["psvgp.fit"]["attrs"]) == {"retained_bytes", "device_allocs", "device_frees"}
    assert set(named["psvgp.capture"]["attrs"]) == {"reserved_bytes", "device_allocs"}
    replay = named["psvgp.replay"]["attrs"]
    assert replay["replays"] == 40 - psvgp.WARMUP_STEPS and replay["device_ms"] > 0
