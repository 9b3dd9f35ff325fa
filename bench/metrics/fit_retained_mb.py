"""fit_retained_mb: device memory a fit leaves allocated beyond the state it
returns, in MB (``retained_bytes`` on the program's ``psvgp.fit`` span),
the median over the window's fits."""
import statistics

from bench import spans


def read(records: dict) -> float | None:
    kept = [b / 1e6 for u in spans.traced(records)
            for b in spans.attr(u, "psvgp.fit", "retained_bytes")]
    return statistics.median(kept) if kept else None
