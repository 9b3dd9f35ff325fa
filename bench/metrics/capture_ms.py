"""capture_ms: what a fit costs beyond its replays (init, the eager
warm-up steps, the graph's capture, the copy-out): the fit's wall time less
its replays' event-timed device time, the median over the window's fits."""
import statistics


def read(records: dict) -> float | None:
    timed = [1e3 * u["wall_s"] - u["replay_ms"] for u in records["units"] if u.get("replays")]
    return statistics.median(timed) if timed else None
