"""svgp_proj_roofline: the ELBO projection kernel's share of its roofline,
in %: its least time (bench/counts.py) over its mean device time in the
profiled replays."""
import re

from bench import counts

KERNEL = re.compile(r"projection(_wide)?_kernel")


def read(records: dict) -> float | None:
    prof, s = records.get("profile"), records["shape"]
    times = [b - a for name, a, b in (prof or {}).get("device_events", ()) if KERNEL.search(name)]
    if not times:
        return None
    bound, _ = counts.projection_bound_s(s["P"], s["B"], s["m"], s["d"])
    return 100.0 * bound / (sum(times) / len(times))
