"""moe_dispatch_ms: device ms a step of the expert layers' routing, sort,
dispatch and combine (the ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans' CUDA events) in the forward passes, the backward's
recomputation included, over the window's traced units."""
from bench import spans

NAMES = ("moe.route", "moe.dispatch", "moe.combine")


def read(records: dict) -> float | None:
    units = spans.traced(records)
    times = [sp["attrs"]["device_ms"] for u in units for n in NAMES for sp in spans.named(u, n)
             if sp["attrs"].get("device_ms") is not None]
    steps = sum(u["steps"] for u in units)
    return sum(times) / steps if times and steps else None
