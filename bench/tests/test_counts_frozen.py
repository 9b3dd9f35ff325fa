"""The frozen counts (``bench/counts.py``): the projection's bound is
``chip_smoke.py``'s, and the step's FLOPs are the sum of the terms
``PERF.md`` writes out."""
from __future__ import annotations

import importlib.util
import os

import pytest
from conftest import ROOT

from bench import counts


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
