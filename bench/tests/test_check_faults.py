"""The check comes out false with the timed path broken underneath: the
harness runs the tiny cell on the CPU (its look for a chip skipped) with
each fault a one-chip training cell can have planted in the program, and
true with none."""
from __future__ import annotations

import pytest
from conftest import run_tiny, tiny_copy

from bench import faults


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench_copy")))


def test_sound_program_is_correct(root):
    result = run_tiny(root)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(root, fault):
    with faults.FAULTS[fault]():
        result = run_tiny(root)
    assert not result["correct"], result["check"]
    failing = [k for k, c in result["check"].items() if not c["value"] <= c["limit"]]
    assert failing, result["check"]


def test_faults_are_undone_on_exit(root):
    from repro_torch.core import psvgp
    from repro_torch.kernels import ops

    before = (psvgp.train_step, psvgp.gather_minibatch, ops.svgp_projection)
    for plant in faults.FAULTS.values():
        with plant():
            pass
    assert (psvgp.train_step, psvgp.gather_minibatch, ops.svgp_projection) == before
