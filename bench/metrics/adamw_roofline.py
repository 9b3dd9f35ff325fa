"""adamw_roofline: the LM step's in-place AdamW as a share of its bytes
bound, in %: 28 B a parameter (``counts_lm.adamw_bytes``: p, g, m and v
read, p, m and v written, float32; the span's ``elements``) over the HBM
rate, over the ``lm.adamw`` spans' device ms, summed over the window's
traced units."""
from bench import counts, counts_lm, spans


def read(records: dict) -> float | None:
    if records.get("platform") != "gpu":
        return None
    nbytes = ms = 0.0
    for unit in spans.traced(records):
        for sp in spans.named(unit, "lm.adamw"):
            a = sp["attrs"]
            if a.get("device_ms") is None or not a.get("elements"):
                continue
            nbytes += counts_lm.adamw_bytes(int(a["elements"]))
            ms += a["device_ms"]
    if not ms:
        return None
    return 100.0 * nbytes / counts.PEAK_BYTES_PER_S / (ms / 1e3)
