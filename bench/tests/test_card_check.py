"""On the card (``pytest -m cuda bench/tests``): at each cell's own size, the
check's drive of the program reads within the cell's limits and the TF32
control does not. Skips without a GPU."""
from __future__ import annotations

import os

import pytest
from conftest import ROOT

from bench import compare, harness
from bench.reference import psvgp as ref

CELLS = ("psvgp_e3sm.ne30_fit", "psvgp_e3sm_m20.ne30_fit", "psvgp_e3sm.ne120_fit",
         "psvgp_e3sm_m20.ne120_fit")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_outside_the_limits(card, cell):
    bench = os.path.join(ROOT, "bench")
    found = harness.load_cell(ROOT, bench, cell)
    cfg, mix, limits = found["cfg"], found["mix"], found["limits"]
    run = harness.load_module(bench, "entries", mix["entry"]).setup(cfg, mix, limits, 2**31 + 3,
                                                                  card)
    sound = ref.follow(run.x, run.y, cfg, mix, *run.check_seeds, run.steps, card)
    control = ref.follow(run.x, run.y, cfg, mix, *run.check_seeds, run.steps, card,
                         precision="tf32")
    read, wrong = compare.numbers(run.program, sound), compare.numbers(control, sound)
    assert all(read[k] <= v for k, v in limits["limits"].items()), read
    assert any(wrong[k] > v for k, v in limits["limits"].items()), wrong
