"""step_mfu: the whole step's share of the card's FP32 peak, in %: the
frozen analytic FLOPs of one SGD step (bench/counts.py) over fit_step_ms."""
from bench import counts


def read(records: dict) -> float | None:
    window, s = records["window"], records["shape"]
    if not window["steps"] or records.get("platform") != "gpu":
        return None
    step_s = window["seconds"] / window["steps"]
    flops = counts.step_flops(s["P"], s["B"], s["m"], s["d"])
    return 100.0 * flops / step_s / counts.PEAK_FP32_FLOP_PER_S
