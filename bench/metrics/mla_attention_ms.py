"""mla_attention_ms: device ms a step of MLA's attention core (the
``mla.attention`` spans' CUDA events: the fused causal attention over the
expanded latents) in the forward passes, the backward's recomputation
included, over the window's traced units."""
from bench import spans


def read(records: dict) -> float | None:
    units = spans.traced(records)
    times = [sp["attrs"]["device_ms"] for u in units for sp in spans.named(u, "mla.attention")
             if sp["attrs"].get("device_ms") is not None]
    steps = sum(u["steps"] for u in units)
    return sum(times) / steps if times and steps else None
