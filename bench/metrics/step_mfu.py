"""step_mfu: the whole step's share of the card's peak, in %: the step's
FLOPs as the entry reports them in its ``shape`` (``step_flops``, counted
by ``bench/counts.py`` from the shapes alone) over fit_step_ms, over the
peak the shape names (``peak``: a key of ``counts.PEAK_FLOP_PER_S``)."""
from bench import counts


def read(records: dict) -> float | None:
    window, s = records["window"], records.get("shape") or {}
    peak = counts.PEAK_FLOP_PER_S.get(s.get("peak"))
    if not window["steps"] or records.get("platform") != "gpu" or not s.get("step_flops") \
            or peak is None:
        return None
    step_s = window["seconds"] / window["steps"]
    return 100.0 * s["step_flops"] / step_s / peak
