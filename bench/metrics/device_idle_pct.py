"""device_idle_pct: the share of a replayed step in which the card runs
nothing, in %: one less the device's busy time a replay in the profiled
replays (the union of its kernels, copies and fills) over the replayed
step's time by CUDA events in the unprofiled window (the profiler's own
tracing slows the graph's launch, so the profiled window is no measure of
the step)."""


def read(records: dict) -> float | None:
    prof = records.get("profile")
    timed = [u for u in records["units"] if u.get("replays")]
    if not prof or not prof["device_events"] or not timed:
        return None
    step_ms = sum(u["replay_ms"] for u in timed) / sum(u["replays"] for u in timed)
    busy_ms = 1e3 * prof["busy_s"] / prof["items"]
    return 100.0 * (1.0 - busy_ms / step_ms)
