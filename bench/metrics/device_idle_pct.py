"""device_idle_pct: the share of a step in which the card runs nothing, in
%: one less the device's busy time a step in the profiled window (the union
of its kernels, copies and fills) over the step's time by CUDA events in
the unprofiled window (the units' ``device_ms`` over their
``device_steps``; on the graph lane a replayed step). The profiler's own
tracing slows the graph's launch, so the profiled window is no measure of
the step."""


def read(records: dict) -> float | None:
    prof = records.get("profile")
    timed = [u for u in records["units"] if u.get("device_steps")]
    if not prof or not prof.get("device_events") or not prof.get("items") or not timed:
        return None
    step_ms = sum(u["device_ms"] for u in timed) / sum(u["device_steps"] for u in timed)
    busy_ms = 1e3 * prof["busy_s"] / prof["items"]
    return 100.0 * (1.0 - busy_ms / step_ms)
