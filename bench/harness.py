"""Run one cell of ``BENCHMARK.json`` once and build its result line.

Everything particular is found by name under the benchmark's directory:
the cell's configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``, which names the entry it drives), the entry
(``entries/<entry>.py``), the limits of its check (``limits/<cell>.json``)
and one reader per metric (``metrics/<metric>.py``, ``read(records)`` ->
a number, or None where it finds nothing to read).

An entry module exports ``setup(cfg, mix, limits, seed, device)``, which
returns a run with ``unit(k)`` (one unit of the window's work, returning
{"steps", "wall_s", ...}), ``timed_units()`` (a context for traced units,
within which a unit also returns ``device_ms``, its steps' time by CUDA
events, over ``device_steps`` of them), ``profile()`` (a record of
``profiles.reduce``, or None), ``failed_units()``, ``release()``,
``check()`` (-> {number: value}) and ``shape`` (a dict: the step's sizes,
and ``step_flops`` with ``peak``, a key of ``counts.PEAK_FLOP_PER_S``).
Nothing of it is read by key of one model family, so a cell of another
family comes in by new files alone.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """Of the loaded modules (or of ``names``), the top-level names,
    compared whole, that are JAX's own or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_json(bench_dir: str, kind: str, name: str) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def load_module(bench_dir: str, kind: str, name: str):
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: str, bench_dir: str, cell: str) -> dict | None:
    """The manifest and the cell's entry in it, its configuration, traffic
    mix and limits; None where the manifest has no such cell."""
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    spec = next((w for w in manifest["workloads"] if w["name"] == cell), None)
    if spec is None:
        return None
    config = next(c for c in manifest["configs"] if c["name"] == spec["config"])
    with open(os.path.join(root, config["file"]), encoding="utf-8") as f:
        cfg = json.load(f)
    return {"manifest": manifest, "spec": spec, "cfg": cfg,
            "mix": load_json(bench_dir, "traffic", spec["traffic"]),
            "limits": load_json(bench_dir, "limits", cell)}


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones (a metric without ``workloads`` is every cell's)."""
    metrics = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def run(root: str, bench_dir: str, cell: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log=print) -> dict | None:
    """One run; returns the result object, or None where it must not print
    one (the reason went to ``log``)."""
    found = load_cell(root, bench_dir, cell)
    if found is None:
        log(f"no workload {cell!r} in BENCHMARK.json")
        return None
    cfg, mix, limits = found["cfg"], found["mix"], found["limits"]
    entry = load_module(bench_dir, "entries", mix["entry"])
    readers = {m["name"]: (m, load_module(bench_dir, "metrics", m["name"]))
               for m in cell_metrics(found["manifest"], cell, trace)}

    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["allow_tf32"])
    t_entry = time.perf_counter()
    work = entry.setup(cfg, mix, limits, seed, device)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {t_entry - t_start:.3f} s to the entry (imports, the card), then "
        + ", ".join(f"{k} {v:.3f} s" for k, v in getattr(work, "setup_phases", {}).items()))

    units = []
    with work.timed_units() if trace else contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            units.append(work.unit(len(units)))
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    profile = work.profile() if trace else None
    failed = work.failed_units()
    work.release()
    numbers = work.check()

    records = {"setup_s": setup_s, "units": units, "profile": profile, "shape": work.shape,
               "platform": "gpu" if device.type == "cuda" else "cpu",
               "window": {"seconds": window_s, "steps": sum(u["steps"] for u in units),
                          "units": len(units)}}
    metrics = {}
    for name, (meta, reader) in readers.items():
        value = reader.read(records)
        if value is not None:
            metrics[name] = {"value": value, "unit": meta["unit"]}

    check = {k: {"value": numbers[k], "limit": v} for k, v in limits["limits"].items()}
    check["failed_fits"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    result = {"correct": correct, "attempted": len(units), "failed": failed, "metrics": metrics,
              "device": {"platform": records["platform"],
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if profile is not None:
        result["device"].update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        result["breakdown"] = {"device_ops": profile["top_device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["fits"] = [{k: v for k, v in u.items() if k != "steps"} for u in units]
    result["check"] = check
    return result
