"""fit_overhead_max_ms: the per-fit stall: host ms of ``psvgp.init`` plus the
part of ``psvgp.fit`` outside its ``psvgp.replay``, the largest over the
window's fits."""
from bench import spans


def read(records: dict) -> float | None:
    timed = [spans.ms(u, "psvgp.init") + spans.ms(u, "psvgp.fit") - spans.ms(u, "psvgp.replay")
             for u in spans.traced(records) if spans.named(u, "psvgp.fit")]
    return max(timed) if timed else None
