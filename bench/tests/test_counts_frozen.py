"""The frozen counts (``bench/counts.py``): the projection's bound is
``chip_smoke.py``'s, the step's FLOPs are the sum of the terms ``PERF.md``
writes out, the peaks are the data sheet's, and the GP entry reports the
step's FLOPs and the FP32 peak at every cell's shape."""
from __future__ import annotations

import importlib.util
import os

import pytest
from conftest import ROOT

from bench import counts, harness

BENCH = os.path.join(ROOT, "bench")


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", [(400, 32, 5, 2), (400, 32, 20, 2), (6400, 32, 5, 2),
                                   (1, 65536, 5, 2), (1, 4096, 1024, 2), (3, 45, 65, 5)])
def test_projection_bound_is_chip_smokes(shape):
    ms, what = chip_smoke().projection_bound(*shape, project=True)
    seconds, ours = counts.projection_bound_s(*shape)
    assert seconds * 1e3 == pytest.approx(ms, rel=1e-12) and ours == what


def test_projection_bound_at_the_papers_shape():
    seconds, what = counts.projection_bound_s(400, 32, 5, 2)
    assert round(seconds * 1e6, 3) == 0.212 and what == "bytes"
    assert counts.projection_bytes(400, 32, 5, 2) == 710_400


def test_step_flops_term_by_term():
    P, B, m, d = 400, 32, 5, 2
    forward = (m * m * (3 * d + 3) + m) + m**3 // 3 + B * m * (3 * d + 3) + B * m * m \
        + 2 * B * m + B * m * m + 2 * B * m + B * m * (m + 1) + (2 * B * m + 2 * B) + 12 * B \
        + m**3 // 3 + 2 * m * m + (4 * m + 8)
    assert forward == counts.elbo_forward_flops(B, m, d) == 5_798
    assert counts.params_per_cell(m, d) == 44
    assert counts.step_flops(P, B, m, d) == P * (3 * 5_798 + 12 * 44) == 7_168_800
    assert counts.step_flops(400, 32, 20, 2) == 72_940_800
    assert counts.step_flops(6400, 32, 5, 2) == 16 * 7_168_800


def test_peaks_are_the_data_sheets():
    assert counts.PEAK_FP32_FLOP_PER_S == 67e12 and counts.PEAK_BF16_FLOP_PER_S == 989.4e12
    assert counts.PEAK_FLOP_PER_S == {"fp32": 67e12, "bf16": 989.4e12}


STEP_FLOPS = {"psvgp_e3sm.ne30_fit": 7_168_800, "psvgp_e3sm_m20.ne30_fit": 72_940_800,
              "psvgp_e3sm.ne120_fit": 114_700_800, "psvgp_e3sm_m20.ne120_fit": 1_167_052_800}


@pytest.mark.parametrize("cell", sorted(STEP_FLOPS))
def test_gp_entry_reports_the_step_flops(cell):
    found = harness.load_cell(ROOT, BENCH, cell)
    cfg, mix = found["cfg"], found["mix"]
    gx, gy = mix["grid"]
    P, B, m, d = gx * gy, cfg["batch_size"], cfg["num_inducing"], cfg["input_dim"]
    shape = harness.load_module(BENCH, "entries", mix["entry"]).step_shape(P, B, m, d)
    assert shape == {"P": P, "B": B, "m": m, "d": d,
                     "step_flops": counts.step_flops(P, B, m, d), "peak": "fp32"}
    assert shape["step_flops"] == STEP_FLOPS[cell]


def test_gp_entry_run_reports_its_shape(tmp_path):
    """A run set up on the CPU at the tiny cell reports what step_shape gives."""
    import torch
    from conftest import TINY_CELL, tiny_copy

    root = tiny_copy(str(tmp_path))
    found = harness.load_cell(root, os.path.join(root, "bench"), TINY_CELL)
    entry = harness.load_module(os.path.join(root, "bench"), "entries", found["mix"]["entry"])
    run = entry.setup(found["cfg"], found["mix"], found["limits"], 5, torch.device("cpu"))
    assert run.shape == entry.step_shape(9, 32, 5, 2)
