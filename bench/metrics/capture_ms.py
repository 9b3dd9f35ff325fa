"""capture_ms: what a unit costs beyond its event-timed steps: its wall
time less their device time (``device_ms``), the median over the window's
units. On the graph lane, what a fit costs beyond its replays: init, the
eager warm-up steps, the graph's capture, the copy-out."""
import statistics


def read(records: dict) -> float | None:
    timed = [1e3 * u["wall_s"] - u["device_ms"] for u in records["units"]
             if u.get("device_steps")]
    return statistics.median(timed) if timed else None
