"""The kernel wrappers' launch-counter registry (``kernels/launches.py``).

On the CPU, with a counter registered by the test: ``counter`` returns the
dict it registers and refuses an entry registered twice, ``reset`` zeroes
every counter and ``total`` sums them, a capture's launches come back out
and count a replay's, and every wrapper's ``LAUNCHES`` is in the registry.
The counting on the card is held by the ``cuda``-marked tests of
``test_torch_adam.py``, ``test_torch_scan.py`` and ``test_torch_trace.py``.
"""
from __future__ import annotations

import pytest

from repro_torch.kernels import adam, draws, launches, predict, rbf, svgp_proj


@pytest.fixture
def registry(monkeypatch):
    """The registry as it is, restored after the test."""
    monkeypatch.setattr(launches, "_COUNTERS", dict(launches._COUNTERS))


def test_counter_registers_its_dict_and_reset_zeroes_every_one(registry):
    mine = launches.counter({"test_a": 0, "test_b": 0})
    assert launches.counter({"test_c": 4}) == {"test_c": 4}
    mine["test_a"] += 2
    mine["test_b"] += 1
    predict.LAUNCHES["posterior_predict"] += 1
    counts = launches.counts()
    assert (counts["test_a"], counts["test_b"], counts["test_c"]) == (2, 1, 4)
    assert launches.total() == sum(counts.values())
    launches.reset()
    assert mine == {"test_a": 0, "test_b": 0} and predict.LAUNCHES["posterior_predict"] == 0
    assert launches.total() == 0
    with pytest.raises(ValueError, match="test_b"):
        launches.counter({"test_b": 0, "test_d": 0})
    assert "test_d" not in launches.counts()


def test_a_capture_counts_what_each_replay_launches(registry):
    mine = launches.counter({"test_once": 0, "test_twice": 0, "test_idle": 0})
    launches.reset()
    mine["test_once"] = 5
    before = launches.counts()
    mine["test_once"] += 1  # the wrapper's calls while a graph is captured
    mine["test_twice"] += 2
    captured = launches.captured_launches(before)
    assert captured == {"test_once": 1, "test_twice": 2}  # only the entries that launched
    assert launches.counts() == before
    launches.count_replays(captured, 10)
    assert mine == {"test_once": 15, "test_twice": 20, "test_idle": 0}


def test_every_wrapper_counter_is_registered():
    counts = launches.counts()
    for wrapper in (adam, draws, predict, rbf, svgp_proj):
        for name in wrapper.LAUNCHES:
            before = counts[name]
            wrapper.LAUNCHES[name] += 1
            assert launches.counts()[name] == before + 1
            wrapper.LAUNCHES[name] -= 1
