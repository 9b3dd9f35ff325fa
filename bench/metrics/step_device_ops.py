"""step_device_ops: device operations (kernels, copies, fills) a step runs,
counted in the profiled window (on the graph lane, replayed steps)."""


def read(records: dict) -> float | None:
    prof = records.get("profile")
    if not prof or not prof.get("device_events") or not prof.get("items"):
        return None
    return len(prof["device_events"]) / prof["items"]
