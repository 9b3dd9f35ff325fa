"""Probe of the program's own spans on the graph lane (``repro_torch.trace``),
read as a traced run of a cell would read them; adds no cell.

    python3 bench/probes/fit_trace_probe.py --workload psvgp_e3sm.ne30_fit --seed 1 \\
        --fits 24 --cost-fits 16 --out fit_trace_ne30.json

Sets the cell's entry up as a run does (the check's drive included), then:

1. window: ``--fits`` whole fits under the entry's ``timed_units()`` with
   the tracer switched on, each fit's spans drained into its unit's
   ``trace``, and the span readers of ``bench/metrics/`` (``SPAN_METRICS``)
   read over them; for each fit, its ``psvgp.replay`` device ms against the
   entry's own events, the share of ``psvgp.init`` + ``psvgp.fit`` host time
   that the inner spans cover, and its time in the ``torch.cuda.empty_cache``
   and ``synchronize`` calls inside its capture;
2. cost: ``--cost-fits`` fits without the entry's events, the tracer off
   and on in turns (off, on, on, off, ...): ``fit_step_ms`` of each side,
   and the host us of one span and of one ``memory_stats`` call;
3. one whole fit of ``--profile-iters`` steps (init, warm-up, capture,
   replays, copy-out) under ``torch.profiler`` with the tracer on: every
   gap of the card's work over 100 us put down to the innermost span that
   covers its middle, and each span against its ``record_function`` event.

(That a graph captured traced launches the same ops and leaves a bitwise
state is ``tests/test_torch_trace.py``'s ``cuda``-marked test.)

Prints one JSON line and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPAN_METRICS = ("warmup_ms", "capture_self_ms", "fit_overhead_max_ms", "replay_fit_spread_pct",
                "fit_retained_mb", "fit_device_allocs")
INNER = ("psvgp.init", "psvgp.warm_up", "psvgp.capture", "psvgp.copy_out", "psvgp.replay")
GAP_US = 100.0


def traced_run(entry, trace):
    """The entry's run class, with the tracer switched on inside
    ``timed_units()`` and each unit's spans drained into its record."""

    class TracedRun(entry.Run):
        @contextlib.contextmanager
        def timed_units(self):
            trace.set_enabled(True)
            try:
                with super().timed_units():
                    yield
            finally:
                trace.set_enabled(False)

        def unit(self, k: int) -> dict:
            record = super().unit(k)
            record["trace"] = trace.drain()
            return record

    return TracedRun


def read_metrics(bench_dir: str, units: list[dict]) -> dict:
    from bench import harness

    records = {"units": units}
    return {name: harness.load_module(bench_dir, "metrics", name).read(records)
            for name in SPAN_METRICS}


def per_fit(units: list[dict]) -> list[dict]:
    """For each fit: its spans' host ms, attributes, the replays' device ms
    against the entry's events, and the inner spans' share of the fit."""
    from bench import spans

    rows = []
    for u in units:
        names = ("psvgp.init", "psvgp.fit", "psvgp.warm_up", "psvgp.capture",
                 "psvgp.capture.step", "psvgp.replay", "psvgp.copy_out")
        row = {"wall_ms": 1e3 * u["wall_s"], **{n[6:] + "_ms": spans.ms(u, n) for n in names}}
        for name, key in (("psvgp.fit", "retained_bytes"), ("psvgp.fit", "device_allocs"),
                          ("psvgp.fit", "device_frees"), ("psvgp.capture", "reserved_bytes"),
                          ("psvgp.capture", "device_allocs"), ("psvgp.replay", "device_ms"),
                          ("psvgp.replay", "replays")):
            got = spans.attr(u, name, key)
            if got:
                row[f"{name[6:]}.{key}"] = sum(got)
        host = row["init_ms"] + row["fit_ms"]
        row["covered"] = sum(spans.ms(u, n) for n in INNER) / host if host else None
        if u.get("device_ms") and row.get("replay.device_ms"):
            row["replay_ms_outside"] = u["device_ms"]
            row["replay_agree"] = row["replay.device_ms"] / u["device_ms"]
            row["replay_step_ms"] = row["replay.device_ms"] / row["replay.replays"]
        row["dropped"] = u["trace"]["dropped"]
        row.update({f"capture.{k}_ms": v for k, v in u.get("calls", {}).items()})
        rows.append(row)
    return rows


@contextlib.contextmanager
def timed_calls(module, names: tuple[str, ...], log: list):
    """Within it each call of ``module.<name>`` appends (name, start_ns,
    end_ns) to ``log`` (the capture's prologue calls ``torch.cuda``'s by
    attribute)."""
    originals = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                log.append((name, t0, time.perf_counter_ns()))
        return call

    for name, fn in originals.items():
        setattr(module, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def window(run, fits: int, first: int = 0) -> list[dict]:
    """``fits`` traced units; each also gets ``calls``: ms of the
    ``torch.cuda`` calls timed by :func:`timed_calls` inside its
    ``psvgp.capture``."""
    import torch

    from bench import spans

    units = []
    with run.timed_units():
        for k in range(fits):
            log: list = []
            with timed_calls(torch.cuda, ("empty_cache", "synchronize"), log):
                u = run.unit(first + k)
            capture = spans.named(u, "psvgp.capture")
            inside = [(n, a, b) for n, a, b in log
                      if any(c["start_ns"] <= a and b <= c["end_ns"] for c in capture)]
            u["calls"] = {n: sum(b - a for m, a, b in inside if m == n) / 1e6
                          for n in ("empty_cache", "synchronize")}
            units.append(u)
    return units


def tracer_cost_us(trace, device, reps: int = 2000) -> dict:
    """Host us of one traced span (enter, ``set``, exit) and of one
    ``torch.cuda.memory_stats`` call, the tracer's own work on its path."""
    import torch

    trace.set_enabled(True)
    try:
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            with trace.span("probe.cost") as sp:
                sp.set(n=1)
        span_us = (time.perf_counter_ns() - t0) / reps / 1e3
    finally:
        trace.set_enabled(False)
        trace.drain()
    t0 = time.perf_counter_ns()
    for _ in range(reps // 10):
        torch.cuda.memory_stats(device)
    return {"span": span_us, "memory_stats": (time.perf_counter_ns() - t0) / (reps // 10) / 1e3}


def cost(run, trace, fits: int, first: int) -> dict:
    """fit_step_ms with the tracer off and on, in turns."""
    sides: dict[bool, list] = {False: [], True: []}
    for k in range(fits):
        on = (k % 4) in (1, 2)
        trace.set_enabled(on)
        try:
            u = run.unit(first + k)
        finally:
            trace.set_enabled(False)
        sides[on].append(u)
    out = {}
    for on, units in sides.items():
        if units:
            wall, steps = sum(u["wall_s"] for u in units), sum(u["steps"] for u in units)
            out["on" if on else "off"] = {"fit_step_ms": 1e3 * wall / steps,
                                          "fit_s": [u["wall_s"] for u in units]}
    if len(out) == 2:
        out["on_over_off"] = out["on"]["fit_step_ms"] / out["off"]["fit_step_ms"]
    return out


def _innermost(spans: list[dict], t: float) -> str:
    covering = [s for s in spans if s["start"] <= t <= s["end"]]
    return min(covering, key=lambda s: s["end"] - s["start"])["name"] if covering else "none"


def attribute(prof, drained: dict, trace) -> dict:
    """Each gap over GAP_US between the card's work, put down to the
    innermost span covering its middle (times in us on the profiler's clock),
    and each span's distance from its own ``record_function`` event."""
    import torch

    from bench import profiles

    origin = prof.profiler.kineto_results.trace_start_ns()
    dev, host = profiles.events(prof)
    mapped = [{"name": s["name"],
               "start": 1e-3 * (trace.epoch_ns(s["start_ns"], drained["anchor_ns"]) - origin),
               "end": 1e-3 * (trace.epoch_ns(s["end_ns"], drained["anchor_ns"]) - origin)}
              for s in drained["spans"]]
    t0 = min(s["start"] for s in mapped) if mapped else 0.0
    busy = [(1e6 * a, 1e6 * b) for a, b in profiles.busy_intervals(dev)]
    gaps, by_span = [], {}
    for (_, a), (b, _) in zip(busy, busy[1:], strict=False):
        if b - a <= GAP_US:
            continue
        mid = 0.5 * (a + b)
        span = _innermost(mapped, mid)
        covering = [h for h in host if 1e6 * h[1] <= mid <= 1e6 * h[2]]
        event = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "none"
        gaps.append({"at_ms": 1e-3 * (a - t0), "us": b - a, "span": span, "host_event": event})
        by_span[span] = by_span.get(span, 0.0) + (b - a)
    offsets = []
    rf = {}
    for e in prof.events():
        if e.name.startswith("psvgp.") and e.device_type != torch.autograd.DeviceType.CUDA:
            rf.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    for s in mapped:
        candidates = rf.get(s["name"], [])
        if candidates:
            a, b = min(candidates, key=lambda ab: abs(ab[0] - s["start"]))
            offsets.append(max(abs(a - s["start"]), abs(b - s["end"])))
    spans_ms = {}
    for s in mapped:
        spans_ms[s["name"]] = spans_ms.get(s["name"], 0.0) + 1e-3 * (s["end"] - s["start"])
    return {"device_events": len(dev), "busy_ms": 1e-3 * sum(b - a for a, b in busy),
            "window_ms": 1e-3 * (max(s["end"] for s in mapped) - t0) if mapped else None,
            "spans_ms": spans_ms, "gap_us_by_span": by_span,
            "gaps_over_100us": sorted(gaps, key=lambda g: -g["us"])[:60],
            "n_gaps_over_100us": len(gaps),
            "span_vs_record_function_max_us": max(offsets) if offsets else None}


def profile_fit(run, trace, iters: int, seed: int) -> dict:
    """One whole fit of ``iters`` steps under the profiler, traced."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace.set_enabled(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            state = run.psvgp.init(seed, run.pcfg, run.data)
            run.psvgp.fit(run.static, state, run.data, iters, seed=seed, use_scan=True)
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
    finally:
        trace.set_enabled(False)
    return attribute(prof, trace.drain(), trace)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--fits", type=int, default=24)
    parser.add_argument("--cost-fits", type=int, default=16)
    parser.add_argument("--profile-iters", type=int, default=200)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p or ".") != os.path.dirname(__file__)]
    import torch

    from bench import harness
    from bench.seeds import sub_seed

    if not torch.cuda.is_available():
        print("fit_trace_probe: needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    from repro_torch import trace

    bench_dir = os.path.join(ROOT, "bench")
    found = harness.load_cell(ROOT, bench_dir, args.workload)
    if found is None:
        print(f"fit_trace_probe: no workload {args.workload!r}", file=sys.stderr)
        return 2
    cfg, mix = found["cfg"], found["mix"]
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["allow_tf32"])
    device = torch.device("cuda", 0)
    entry = harness.load_module(bench_dir, "entries", mix["entry"])
    t0 = time.perf_counter()
    run = traced_run(entry, trace)(cfg, mix, found["limits"], args.seed, device)
    setup_s = time.perf_counter() - t0
    units = window(run, args.fits)
    rows = per_fit(units)
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(device), "torch": torch.__version__,
              "setup_s": setup_s, "metrics": read_metrics(bench_dir, units), "fits": rows,
              "covered_min": min(r["covered"] for r in rows),
              "replay_agree": [min(r["replay_agree"] for r in rows),
                               max(r["replay_agree"] for r in rows)],
              "cost": cost(run, trace, args.cost_fits, first=10_000),
              "profile": profile_fit(run, trace, min(args.profile_iters, run.iters),
                                     sub_seed(args.seed, "probe:profile")),
              "tracer_cost_us": tracer_cost_us(trace, device),
              "peak_bytes": torch.cuda.max_memory_allocated(device)}
    result["window_fit_step_ms"] = 1e3 * sum(u["wall_s"] for u in units) / sum(
        u["steps"] for u in units)
    result["replay_step_ms_median"] = statistics.median(r["replay_step_ms"] for r in rows)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
