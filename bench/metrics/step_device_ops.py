"""step_device_ops: device operations (kernels, copies, fills) a replayed
step runs, counted in the profiled replays."""


def read(records: dict) -> float | None:
    prof = records.get("profile")
    if not prof or not prof["device_events"]:
        return None
    return len(prof["device_events"]) / prof["items"]
