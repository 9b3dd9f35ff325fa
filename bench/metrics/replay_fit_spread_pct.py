"""replay_fit_spread_pct: how far replay speed varies between the window's
fits, in %: (max - min) / median of each fit's device ms a replay, from the
CUDA events the program's ``psvgp.replay`` span records outside the graph."""
import statistics

from bench import spans


def read(records: dict) -> float | None:
    per_fit = []
    for u in spans.traced(records):
        ms, n = spans.attr(u, "psvgp.replay", "device_ms"), spans.attr(u, "psvgp.replay", "replays")
        if ms and len(ms) == len(n) and sum(n):
            per_fit.append(sum(ms) / sum(n))
    if len(per_fit) < 2:
        return None
    return 100.0 * (max(per_fit) - min(per_fit)) / statistics.median(per_fit)
