"""fit_device_allocs: cudaMalloc calls a fit makes (``device_allocs`` on the
program's ``psvgp.fit`` span: the allocator's ``num_device_alloc``
delta), the median over the window's fits."""
import statistics

from bench import spans


def read(records: dict) -> float | None:
    allocs = [n for u in spans.traced(records) for n in spans.attr(u, "psvgp.fit", "device_allocs")]
    return float(statistics.median(allocs)) if allocs else None
