"""warmup_ms: host ms of a fit's eager warm-up before the capture (the
program's ``psvgp.warm_up`` span: three eager steps on a new side stream),
the median over the window's fits."""
import statistics

from bench import spans


def read(records: dict) -> float | None:
    timed = [spans.ms(u, "psvgp.warm_up") for u in spans.traced(records)
             if spans.named(u, "psvgp.warm_up")]
    return statistics.median(timed) if timed else None
