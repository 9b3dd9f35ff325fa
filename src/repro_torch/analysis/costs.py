"""Pass ``costs`` — cost-model gates, from the recorded traces.

The port's counterpart of ``repro.analysis.costs``. The paper's claims are
quantitative: on the mesh a rank holds O(1/P) of the cache, and blend work
is linear in the query block. The JAX package reads XLA's
``cost_analysis()``/``memory_analysis()`` of the compiled programs; the
port has no compiler to ask, so it measures the same five metrics
(:data:`METRICS`) from the ``hlo`` pass's recorder over one request of
each ``ref`` program, at JAX's scale points:

  * flops — the product ops by the formulas of
    ``torch.utils.flop_counter.FlopCounterMode``, one per output element
    for pointwise ops, one per input element for reductions;
  * bytes_accessed — every op's input and output bytes (views,
    allocations and cross-device copies excluded);
  * arg_bytes — the bytes of the cache leaves resident on the device or
    rank (the storages they keep alive: a view of the whole cache counts
    whole) plus the request's routed blocks;
  * out_bytes — the device program's outputs (per rank on the mesh);
  * temp_bytes — the peak of the live op outputs over the request.

All five are derived from shapes, so they come out the same on any
machine: a committed baseline (:data:`DEFAULT_BASELINE`, the port's own
file) gates drift on the CPU. The scale points are JAX's: grid sides 2,
3, 4 at q_max 64 and q_max 32, 64, 128 at grid 4 for the halo programs,
n 128, 256, 512 for the replicated one. The programs:

  * ``replicated-blend/ref`` — ``blend.predict_blended`` on one device;
  * ``sharded-blend/ref`` — the one-process halo program: every cell on
    one device, so its bytes grow with P by design (axis ``cells``);
  * ``mesh-blend/ref`` — one cell per rank (axis ``devices``): per-rank
    arg_bytes and flops must stay FLAT in P (COST-MEM-SCALING), measured
    on spawned gloo ranks (``meshprobe``), rank 0's record.

On the card the pass also records each rank's
``torch.cuda.max_memory_allocated`` over a request (after
``reset_peak_memory_stats``) at P = 4, 9 and 16, and holds its fitted
exponent to ``mesh-blend``'s device budget; those bytes are reported, not
gated against the CPU baseline (the allocator rounds, the CPU does not).

Kernel-lane caveat, stated rather than silently capped: a kernel dispatch
is one opaque launch (a ctypes call on the card), so its work is not in
the trace; the kernel lanes are recorded as skipped with this reason, and
the ref program bounds the math they implement.

Measurement (``measure_programs``) is kept apart from judgment (the pure
``fit_exponent`` / ``check_*``, JAX's), so the gates are unit-testable
without torch.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time

from repro_torch.analysis import Finding
from repro_torch.analysis import invariants as inv

M = 8
SHARDED_GRID_SIDES = (2, 3, 4)  # P = 4, 9, 16 cells / ranks, at q_max = ANCHOR_Q
SHARDED_Q_POINTS = (32, 64, 128)  # at grid side ANCHOR_GRID
ANCHOR_GRID = 4
ANCHOR_Q = 64
REPLICATED_N_POINTS = (128, 256, 512)

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "analysis_costs.json")
# shape-derived numbers move only when the program does; a quarter is far
# above any rounding and far below a real regression
DRIFT_TOLERANCE = 1.25

METRICS = ("flops", "bytes_accessed", "arg_bytes", "out_bytes", "temp_bytes")


# --------------------------------------------------------------------------
# Measurement (torch-touching; imports deferred)
# --------------------------------------------------------------------------


def scale_jobs(*, m: int = M) -> dict:
    """{program name: [(label, axis values, hlo job)]} of every scale point."""
    from repro_torch.analysis import hlo

    out = {}
    for program, axis in (("sharded-blend", "cells"), ("mesh-blend", "devices")):
        points = []
        for side in SHARDED_GRID_SIDES:
            points.append((f"grid={side}/q={ANCHOR_Q}", {axis: side * side},
                           hlo.probe_job((program, "ref"), grid_side=side, m=m,
                                         q_max=ANCHOR_Q, n_queries=0)))
        for q in SHARDED_Q_POINTS:
            job = hlo.probe_job((program, "ref"), grid_side=ANCHOR_GRID, m=m, q_max=q,
                                n_queries=0)
            lab = f"grid={ANCHOR_GRID}/q={q}"
            hit = next((p for p in points if p[0] == lab), None)
            if hit is None:
                points.append((lab, {"q_max": q}, job))
            else:
                hit[1]["q_max"] = q
        out[f"{program}/ref"] = points
    out["replicated-blend/ref"] = [
        (f"n={n}", {"n_queries": n},
         hlo.probe_job(("replicated-blend", "ref"), grid_side=ANCHOR_GRID, m=m,
                       q_max=ANCHOR_Q, n_queries=n))
        for n in REPLICATED_N_POINTS
    ]
    return out


def mesh_jobs(*, m: int = M) -> list:
    """The scale points the mesh program needs (for the CLI's one spawn)."""
    return [job for _, _, job in scale_jobs(m=m)["mesh-blend/ref"]]


def measure_programs(*, m: int = M, device: str = "cpu") -> dict:
    """Drive every ref program at its scale points; return per program
    ``{"points": {label: metrics}, "axes": {axis: {label: value}}}`` and,
    on the card, ``"cuda_peak_bytes": {label: [per rank]}``."""
    from repro_torch.analysis import hlo

    plan = scale_jobs(m=m)
    results = hlo.run_jobs([job for pts in plan.values() for _, _, job in pts], device)
    programs = {}
    for name, pts in plan.items():
        rec = {"points": {}, "axes": {}}
        peaks = {}
        for label, axes, job in pts:
            res = results[job]
            per_rank = res if isinstance(res, list) else [res]
            rec["points"][label] = dict(per_rank[0]["costs"])
            for axis, value in axes.items():
                rec["axes"].setdefault(axis, {})[label] = value
            if per_rank[0]["cuda_peak_bytes"] is not None:
                peaks[label] = [r["cuda_peak_bytes"] for r in per_rank]
        if peaks:
            rec["cuda_peak_bytes"] = peaks
        programs[name] = rec
    return programs


# --------------------------------------------------------------------------
# Judgment (pure; unit-testable without torch)
# --------------------------------------------------------------------------


def fit_exponent(xs, ys) -> float:
    """Least-squares slope of log(y) on log(x) — the scaling exponent."""
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError("need >= 2 (x, y) points to fit an exponent")
    lx = [math.log(float(x)) for x in xs]
    ly = [math.log(max(float(y), 1e-12)) for y in ys]
    n = len(lx)
    mx, my = sum(lx) / n, sum(ly) / n
    den = sum((a - mx) ** 2 for a in lx)
    if den == 0.0:
        raise ValueError("scale points must differ on the x axis")
    return sum((a - mx) * (b - my) for a, b in zip(lx, ly, strict=True)) / den


def compute_exponents(record: dict) -> dict:
    """Fitted exponent of every metric along every axis of one program's
    record: ``{"flops_vs_q_max": 1.0, "arg_bytes_vs_devices": 0.0, ...}``."""
    out = {}
    for axis, labels in record["axes"].items():
        xs = [labels[lab] for lab in labels]
        for metric in METRICS:
            ys = [record["points"][lab][metric] for lab in labels]
            out[f"{metric}_vs_{axis}"] = round(fit_exponent(xs, ys), 4)
    return out


def check_budget(name: str, record: dict, budget: "inv.CostBudget") -> list:
    """Apply one program's declarative cost budget to its measured record."""
    exps = record["exponents"]
    where = f"program:{name}"
    findings = []

    flop_key = f"flops_vs_{budget.scale_axis}"
    if exps.get(flop_key, 0.0) > budget.max_flop_exponent:
        findings.append(
            Finding(
                "costs",
                "COST-FLOP-SUPERLINEAR",
                where,
                f"flops scale as {budget.scale_axis}^{exps[flop_key]:.2f}, "
                f"budget is ^{budget.max_flop_exponent} — a quadratic "
                "(pairwise) term crept into the blend",
            )
        )
    if budget.max_device_exponent is not None:
        for metric in ("arg_bytes", "flops"):
            key = f"{metric}_vs_devices"
            if exps.get(key, 0.0) > budget.max_device_exponent:
                findings.append(
                    Finding(
                        "costs",
                        "COST-MEM-SCALING",
                        where,
                        f"per-device {metric} scale as devices^{exps[key]:.2f}, "
                        f"budget is ^{budget.max_device_exponent} — per-rank "
                        "state/work must stay FLAT as the mesh grows (the 1/P "
                        "residency claim; a rank holding the whole cache "
                        "looks exactly like this)",
                    )
                )
    anchor = record["points"].get(budget.anchor)
    if anchor is None:
        findings.append(
            Finding(
                "costs",
                "COST-BUDGET",
                where,
                f"anchor point {budget.anchor!r} missing from the measured "
                "scale points — the budget manifest and the pass disagree",
            )
        )
        return findings
    for metric, ceiling in (
        ("flops", budget.max_flops),
        ("bytes_accessed", budget.max_bytes_accessed),
        ("arg_bytes", budget.max_arg_bytes),
        ("temp_bytes", budget.max_temp_bytes),
    ):
        if anchor[metric] > ceiling:
            findings.append(
                Finding(
                    "costs",
                    "COST-BUDGET",
                    where,
                    f"{metric} = {anchor[metric]:.0f} at {budget.anchor} "
                    f"exceeds the absolute ceiling {ceiling:.0f}",
                )
            )
    return findings


def check_device_memory(name: str, record: dict, budget: "inv.CostBudget") -> list:
    """The card's per-rank peak CUDA memory over a request, fitted against
    the ranks: held to the program's device exponent (the 1/P claim, in
    the allocator's own bytes). No finding without a device budget or
    without CUDA numbers."""
    peaks = record.get("cuda_peak_bytes")
    axis = record["axes"].get("devices")
    if budget.max_device_exponent is None or not peaks or not axis:
        return []
    labels = [lab for lab in axis if lab in peaks]
    exp = fit_exponent([axis[lab] for lab in labels], [max(peaks[lab]) for lab in labels])
    record["cuda_peak_exponent"] = round(exp, 4)
    if exp > budget.max_device_exponent:
        return [Finding("costs", "COST-MEM-SCALING", f"program:{name}",
                        f"per-rank peak CUDA memory scales as devices^{exp:.2f}, budget is "
                        f"^{budget.max_device_exponent} — a rank's memory must stay FLAT "
                        "as the mesh grows")]
    return []


def check_baseline(name: str, record: dict, baseline_record: dict | None,
                   *, tolerance: float = DRIFT_TOLERANCE) -> list:
    """Diff one program's fresh points against the checked-in baseline.

    Increases beyond ``tolerance`` gate (COST-BASELINE-DRIFT); a point or
    metric the baseline has never seen gates too (COST-BASELINE-MISSING —
    run ``--update-baselines`` after an intentional change). Decreases
    never gate: a cheaper program only deserves a baseline refresh.
    """
    where = f"program:{name}"
    if baseline_record is None:
        return [
            Finding(
                "costs",
                "COST-BASELINE-MISSING",
                where,
                "no baseline for this program — run "
                "`python -m repro_torch.analysis --passes costs --device cpu "
                "--update-baselines` and commit "
                "src/repro_torch/analysis/analysis_costs.json",
            )
        ]
    findings = []
    base_points = baseline_record.get("points", {})
    for label, metrics in record["points"].items():
        base = base_points.get(label)
        if base is None:
            findings.append(
                Finding(
                    "costs",
                    "COST-BASELINE-MISSING",
                    where,
                    f"scale point {label!r} has no baseline — run "
                    "--update-baselines after an intentional change",
                )
            )
            continue
        for metric in METRICS:
            fresh, ref = float(metrics[metric]), float(base.get(metric, 0.0))
            if fresh > ref * tolerance and fresh - ref > 256:
                findings.append(
                    Finding(
                        "costs",
                        "COST-BASELINE-DRIFT",
                        where,
                        f"{metric} at {label}: {fresh:.0f} vs baseline "
                        f"{ref:.0f} (> {tolerance:.2f}x) — a cost "
                        "regression; if intentional, refresh with "
                        "--update-baselines",
                    )
                )
    return findings


def lane_cost_records(programs: dict) -> list:
    """Map every serving lane onto its program's cost record (or the
    explicit reason it has none) — the per-lane view the report ships."""
    records = []
    for lane in inv.LANES:
        name = "/".join(lane.program_key)
        budget = inv.COST_BUDGETS[lane.program]
        if name in programs:
            rec = programs[name]
            records.append(
                {
                    "lane": lane.name,
                    "program": name,
                    "anchor": budget.anchor,
                    "anchor_cost": rec["points"].get(budget.anchor),
                    "exponents": rec["exponents"],
                }
            )
        else:
            records.append(
                {
                    "lane": lane.name,
                    "program": name,
                    "skipped": (
                        "kernel lane not cost-modeled: a kernel dispatch is one "
                        "opaque launch (a ctypes call on the card), so its work is "
                        "not in the recorded trace; the ref program bounds the "
                        "same math"
                    ),
                }
            )
    return records


# --------------------------------------------------------------------------
# The pass
# --------------------------------------------------------------------------


def load_baseline(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def write_baseline(path: str, programs: dict, *, platform: str) -> None:
    import torch

    payload = {
        "_meta": {
            "platform": platform,
            "torch": torch.__version__.split("+")[0],
            "m": M,
            "tolerance": DRIFT_TOLERANCE,
            "note": "per-request costs of the port's ref programs, derived from "
            "the recorded ops' shapes; refresh with `python -m "
            "repro_torch.analysis --passes costs --device cpu "
            "--update-baselines` after an intentional change",
        },
        "programs": {
            name: {"points": rec["points"], "exponents": rec["exponents"]}
            for name, rec in programs.items()
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def run(
    *,
    m: int = M,
    baseline_path: str = DEFAULT_BASELINE,
    update_baselines: bool = False,
    device: str = "cpu",
) -> tuple:
    """The full pass. Returns (findings, report)."""
    t0 = time.time()
    platform = device.split(":")[0]
    findings: list = []
    programs = measure_programs(m=m, device=device)
    for name, rec in programs.items():
        rec["exponents"] = compute_exponents(rec)
        budget = inv.COST_BUDGETS[name.split("/")[0]]
        findings.extend(check_budget(name, rec, budget))
        findings.extend(check_device_memory(name, rec, budget))

    baseline = load_baseline(baseline_path)
    baseline_checked = False
    if update_baselines:
        write_baseline(baseline_path, programs, platform=platform)
    elif baseline is not None and baseline.get("_meta", {}).get("platform") != platform:
        # a baseline measured on another platform gates nothing here;
        # stated in the report rather than silently skipped
        pass
    else:
        baseline_checked = True
        base_programs = (baseline or {}).get("programs", {})
        for name, rec in programs.items():
            findings.extend(check_baseline(name, rec, base_programs.get(name)))

    report = {
        "programs": programs,
        "lanes": lane_cost_records(programs),
        "budgets": {name: dataclasses.asdict(b) for name, b in sorted(inv.COST_BUDGETS.items())},
        "baseline_path": baseline_path,
        "baseline_checked": baseline_checked,
        "baseline_updated": bool(update_baselines),
        "platform": platform,
        "m": m,
        "seconds": round(time.time() - t0, 3),
    }
    return findings, report
