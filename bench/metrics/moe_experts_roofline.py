"""moe_experts_roofline: the held experts' grouped products in the expert
layers' forward passes (the backward's recomputation included), as a share
of the BF16 peak, in %: their FLOPs, from each ``moe.experts`` span's
``assignments`` counter (``counts_lm.experts_flops``, the shape's
``d_model`` and ``d_expert``), over their device ms, from the span's CUDA
events, summed over the window's traced units. A run without such spans,
or a shape without those sizes, reads nothing."""
from bench import counts, counts_lm, spans


def read(records: dict) -> float | None:
    s = records.get("shape") or {}
    if records.get("platform") != "gpu" or not all(k in s for k in ("d_model", "d_expert")):
        return None
    flops = ms = 0.0
    for unit in spans.traced(records):
        for sp in spans.named(unit, "moe.experts"):
            a = sp["attrs"]
            if a.get("device_ms") is None or a.get("assignments") is None:
                continue
            flops += counts_lm.experts_flops(int(a["assignments"]), s)
            ms += a["device_ms"]
    if not ms:
        return None
    return 100.0 * flops / (ms / 1e3) / counts.PEAK_BF16_FLOP_PER_S
