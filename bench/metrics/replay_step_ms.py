"""replay_step_ms: device ms of one replayed step of the graph lane, by
CUDA events around each fit's run of replays, over every fit of the window."""


def read(records: dict) -> float | None:
    timed = [u for u in records["units"] if u.get("replays")]
    replays = sum(u["replays"] for u in timed)
    return sum(u["replay_ms"] for u in timed) / replays if replays else None
