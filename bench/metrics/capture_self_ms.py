"""capture_self_ms: host ms of a fit's graph capture outside the captured
step itself (``psvgp.capture`` less ``psvgp.capture.step``: the capture's
synchronize, garbage collection and ``empty_cache``, begin and end, and the
graph's instantiation), the median over the window's fits."""
import statistics

from bench import spans


def read(records: dict) -> float | None:
    timed = [spans.ms(u, "psvgp.capture") - spans.ms(u, "psvgp.capture.step")
             for u in spans.traced(records) if spans.named(u, "psvgp.capture")]
    return statistics.median(timed) if timed else None
