"""Every reader of ``bench/metrics/`` on the records of a traced run on the
card by an entry of another model family: a shape with none of the GP's
sizes, units that time their steps under ``device_ms``/``device_steps`` or
not at all. Each reads its own number or None, and raises on none."""
from __future__ import annotations

import glob
import math
import os
import statistics

import pytest
from conftest import ROOT

from bench import counts, harness

BENCH = os.path.join(ROOT, "bench")
READERS = sorted(os.path.basename(p)[:-3]
                 for p in glob.glob(os.path.join(BENCH, "metrics", "*.py")))
FLOPS = 6 * 32 * 4096 * 1_000_000  # the stub's step: 6 FLOPs a parameter a token


def foreign(timed: bool, profiled: bool, shape: dict | None = None) -> dict:
    """Records of three units of 8 steps each; a profile of 8 steps whose
    kernels include one whose name the projection's reader looks for."""
    units = []
    for k in range(3):
        u = {"steps": 8, "wall_s": 0.5 + 0.01 * k, "tokens": 8 * 32 * 4096}
        if timed:
            u.update(device_ms=400.0 + k, device_steps=8)
        units.append(u)
    dev = [["gemm_bf16_kernel", 0.0, 0.004], ["lm_head_projection_kernel", 0.0045, 0.006],
           ["flash_fwd_kernel", 0.0058, 0.03]]
    profile = {"device_events": dev, "busy_s": 0.03, "window_s": 0.04, "items": 8,
               "top_device_ops": [], "idle_gaps": []} if profiled else None
    return {"setup_s": 12.5, "units": units, "profile": profile, "platform": "gpu",
            "shape": {"batch": 32, "seq_len": 4096, "step_flops": FLOPS, "peak": "bf16"}
            if shape is None else shape,
            "window": {"seconds": 1.53, "steps": 24, "units": 3}}


def read(name: str, records: dict):
    return harness.load_module(BENCH, "metrics", name).read(records)


def test_readers_cover_the_manifest():
    from test_harness_cells import manifest

    m = manifest()
    assert {x["name"] for x in m["end_to_end"] + m["per_layer"]} <= set(READERS)


def test_what_every_cell_reports_reads_a_number_for_another_family():
    """The metrics the manifest asks of every cell (no ``workloads`` list),
    end to end and per layer, all read a number from a traced run on the
    card by an entry that reports ``steps``, ``wall_s``, ``device_ms`` over
    ``device_steps``, a profile, ``step_flops`` and ``peak``; a metric of
    the GP's own kernels lists the cells that run them."""
    from test_harness_cells import manifest

    m = manifest()
    asked = [x["name"] for x in m["end_to_end"] + m["per_layer"] if "workloads" not in x]
    records = foreign(True, True)
    assert {n: read(n, records) is not None for n in asked} == {n: True for n in asked}
    assert "svgp_proj_roofline" not in asked


@pytest.mark.parametrize("timed,profiled", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_number_or_none(name, timed, profiled):
    value = read(name, foreign(timed, profiled))
    assert value is None or (isinstance(value, float) and math.isfinite(value)), value


def test_the_numbers_of_another_family():
    records = foreign(True, True)
    step_ms = 1203.0 / 24
    assert read("fit_step_ms", records) == pytest.approx(1e3 * 1.53 / 24)
    assert read("setup_s", records) == 12.5
    assert read("replay_step_ms", records) == pytest.approx(step_ms)
    assert read("capture_ms", records) == pytest.approx(statistics.median([100.0, 109.0, 118.0]))
    assert read("device_idle_pct", records) == pytest.approx(100 * (1 - 1e3 * 0.03 / 8 / step_ms))
    assert read("step_device_ops", records) == pytest.approx(3 / 8)
    assert read("step_mfu", records) == pytest.approx(
        100 * FLOPS / (1.53 / 24) / counts.PEAK_BF16_FLOP_PER_S)
    # a kernel of that name, but no projection's sizes to bound it by
    assert read("svgp_proj_roofline", records) is None
    untimed = foreign(False, True)
    assert [read(n, untimed) for n in ("replay_step_ms", "capture_ms", "device_idle_pct")] == \
        [None] * 3


@pytest.mark.parametrize("shape", [{}, {"step_flops": FLOPS}, {"peak": "bf16"},
                                   {"step_flops": FLOPS, "peak": "fp4"},
                                   {"P": 400, "B": 32, "m": 5, "d": 2}])
def test_step_mfu_without_flops_or_a_known_peak_reads_none(shape):
    assert read("step_mfu", foreign(True, True, shape)) is None


def test_step_mfu_on_the_cpu_reads_none():
    assert read("step_mfu", dict(foreign(True, True), platform="cpu")) is None
