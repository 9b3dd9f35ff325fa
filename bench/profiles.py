"""Reduce a ``torch.profiler`` window to plain records the metric readers
read, and to the result line's ``breakdown``.

Times are seconds on the profiler's own clock (host and device events share
it). Device events are every kernel, copy and fill the card ran.
"""
from __future__ import annotations

import torch

NAME_CHARS = 120
TOP = 10


def _short(name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def events(prof) -> tuple[list, list]:
    """(device events, host events), each a list of [name, start_s, end_s]
    sorted by start."""
    dev, host = [], []
    for e in prof.events():
        row = [e.name, 1e-6 * e.time_range.start, 1e-6 * e.time_range.end]
        (dev if e.device_type == torch.autograd.DeviceType.CUDA else host).append(row)
    return sorted(dev, key=lambda r: r[1]), sorted(host, key=lambda r: r[1])


def busy_intervals(dev: list) -> list[tuple[float, float]]:
    """The union of the device events' intervals, in order."""
    out: list[list[float]] = []
    for _, a, b in dev:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(dev: list) -> float:
    return sum(b - a for a, b in busy_intervals(dev))


def top_device_ops(dev: list) -> list[list]:
    """[[kernel name, seconds summed over the window]], the TOP largest."""
    per: dict[str, float] = {}
    for name, a, b in dev:
        per[name] = per.get(name, 0.0) + (b - a)
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
    return [[_short(k), v] for k, v in ranked]


def idle_gaps(dev: list, host: list) -> list[list]:
    """[[what the host was doing, seconds]] of the TOP longest gaps between
    device work: each gap is named by the shortest host event that spans
    its middle ("host: none" where none does)."""
    spans = busy_intervals(dev)
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(spans, spans[1:], strict=False) if b0 > a1]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        covering = [h for h in host if h[1] <= mid <= h[2]]
        name = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "host: none"
        out.append([_short(name), b - a])
    return out


def reduce(prof, window_s: float, items: int) -> dict:
    """The record of one profiled window of ``items`` units of work (steps,
    replays) that lasted ``window_s`` on the host clock."""
    dev, host = events(prof)
    return {"device_events": dev, "busy_s": busy_s(dev), "window_s": window_s, "items": items,
            "top_device_ops": top_device_ops(dev), "idle_gaps": idle_gaps(dev, host)}
