"""replay_step_ms: device ms of one step by CUDA events around the units'
timed steps (``device_ms`` over ``device_steps``; on the graph lane each
fit's run of replays), over every unit of the window."""


def read(records: dict) -> float | None:
    timed = [u for u in records["units"] if u.get("device_steps")]
    steps = sum(u["device_steps"] for u in timed)
    return sum(u["device_ms"] for u in timed) / steps if steps else None
