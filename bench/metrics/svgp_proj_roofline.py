"""svgp_proj_roofline: the ELBO projection kernel's share of its roofline,
in %: its least time (bench/counts.py) over its mean device time in the
profiled replays. A step without the kernel, or a shape without the
projection's sizes, reads nothing."""
import re

from bench import counts

KERNEL = re.compile(r"projection(_wide)?_kernel")
SIZES = ("P", "B", "m", "d")


def read(records: dict) -> float | None:
    prof, s = records.get("profile"), records.get("shape") or {}
    times = [b - a for name, a, b in (prof or {}).get("device_events", ()) if KERNEL.search(name)]
    if not times or not all(k in s for k in SIZES):
        return None
    bound, _ = counts.projection_bound_s(*(s[k] for k in SIZES))
    return 100.0 * bound / (sum(times) / len(times))
