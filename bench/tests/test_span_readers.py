"""The span readers (``bench/metrics/`` over ``bench/spans.py``) and the
span probe (``bench/probes/fit_trace_probe.py``) on the CPU: each reader's
arithmetic on hand-made spans, nothing read from units without spans (a
program without the tracer), and the probe's traced window, accounting and
profile attribution on the tiny cell."""
from __future__ import annotations

import os

import pytest
from conftest import ROOT, TINY_CELL, tiny_copy

from bench import harness

BENCH = os.path.join(ROOT, "bench")


def span(name, start_ms, end_ms, **attrs):
    return {"name": name, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "attrs": attrs}


def fit_unit(warm, capture, step, replay, device_ms, retained, allocs, init=2.0, tail=1.0):
    """One fit's spans laid end to end: init, then the fit's warm-up,
    capture (its step inside), replays and copy-out."""
    t = init
    warm_up = span("psvgp.warm_up", t, t + warm)
    t += warm
    inner = span("psvgp.capture.step", t + 1, t + 1 + step)
    cap = span("psvgp.capture", t, t + capture, reserved_bytes=2**21, device_allocs=1)
    t += capture
    rep = span("psvgp.replay", t, t + replay, replays=100, device_ms=device_ms)
    t += replay
    out = span("psvgp.copy_out", t, t + tail)
    t += tail
    root = span("psvgp.fit", init, t, retained_bytes=retained, device_allocs=allocs,
                device_frees=allocs)
    spans = [span("psvgp.init", 0, init), warm_up, inner, cap, rep, out, root]
    return {"steps": 103, "wall_s": t / 1e3, "trace": {"spans": spans, "dropped": 0}}


def read(name: str, units: list[dict]):
    return harness.load_module(BENCH, "metrics", name).read({"units": units})


def test_each_reader_on_hand_made_spans():
    units = [fit_unit(30, 40, 10, 90, 90.0, 67e6, 4),
             fit_unit(50, 60, 10, 95, 99.0, 68e6, 6),
             fit_unit(40, 400, 15, 92, 93.0, 66e6, 5)]
    assert read("warmup_ms", units) == pytest.approx(40)
    assert read("capture_self_ms", units) == pytest.approx(50)
    # init 2 + fit (warm + capture + replay + 1) - replay: the third fit's 443
    assert read("fit_overhead_max_ms", units) == pytest.approx(443)
    assert read("replay_fit_spread_pct", units) == pytest.approx(100 * (0.99 - 0.90) / 0.93)
    assert read("fit_retained_mb", units) == pytest.approx(67)
    assert read("fit_device_allocs", units) == 5


@pytest.mark.parametrize("name", ["warmup_ms", "capture_self_ms", "fit_overhead_max_ms",
                                  "replay_fit_spread_pct", "fit_retained_mb",
                                  "fit_device_allocs"])
def test_readers_find_nothing_without_spans(name):
    """A program without the tracer leaves no ``trace`` in its units."""
    units = [{"steps": 2500, "wall_s": 2.4, "device_ms": 2200.0, "device_steps": 2497}] * 3
    assert read(name, units) is None
    assert read(name, [dict(u, trace={"spans": [], "dropped": 0}) for u in units]) is None


def test_probe_on_the_tiny_cell(tmp_path):
    import torch

    from repro_torch import trace

    root = tiny_copy(str(tmp_path))
    bench_dir = os.path.join(root, "bench")
    found = harness.load_cell(root, bench_dir, TINY_CELL)
    entry = harness.load_module(bench_dir, "entries", found["mix"]["entry"])
    probe = harness.load_module(BENCH, "probes", "fit_trace_probe")
    run = probe.traced_run(entry, trace)(found["cfg"], found["mix"], found["limits"], 5,
                                         torch.device("cpu"))
    units = probe.window(run, 2)
    assert not trace.span("probe").on  # off again after the window
    names = {s["name"] for s in units[0]["trace"]["spans"]}
    assert names == {"psvgp.init", "psvgp.fit", "psvgp.warm_up", "psvgp.replay",
                     "psvgp.copy_out"}
    metrics = probe.read_metrics(BENCH, units)
    assert metrics["warmup_ms"] > 0 and metrics["fit_overhead_max_ms"] > 0
    # no capture, no CUDA events and no allocator on the CPU
    assert [metrics[k] for k in ("capture_self_ms", "replay_fit_spread_pct", "fit_retained_mb",
                                 "fit_device_allocs")] == [None] * 4
    rows = probe.per_fit(units)
    assert all(r["covered"] >= 0.95 and r["dropped"] == 0 for r in rows)
    costs = probe.cost(run, trace, 4, first=100)
    assert set(costs) == {"off", "on", "on_over_off"} and not trace.span("probe").on
    prof = probe.profile_fit(run, trace, 8, seed=3)
    assert prof["device_events"] == 0 and prof["spans_ms"]["psvgp.fit"] > 0
    assert prof["span_vs_record_function_max_us"] <= 50
