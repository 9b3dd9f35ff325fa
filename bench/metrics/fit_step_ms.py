"""fit_step_ms: the window's wall time over every SGD step of its fits
(each fit's init, warm-up and capture included), in ms."""


def read(records: dict) -> float | None:
    window = records["window"]
    return 1e3 * window["seconds"] / window["steps"] if window["steps"] else None
