"""Shared fixtures of the benchmark's own tests (``python -m pytest bench/tests``)."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_CELL = "tiny.tiny_fit"
STUB_CELL = "stub_lm.stub_train"


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU lanes are far slower on torch's default thread pool."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no interpret mode)")
    return torch.device("cuda", 0)


def tiny_copy(dst: str, *, limits_of: str = "psvgp_e3sm.ne30_fit") -> str:
    """A copy of the benchmark (``BENCHMARK.json`` and ``bench/``) under
    ``dst`` with one more cell, ``tiny.tiny_fit``, added by new files and
    manifest entries alone: the paper's configuration with 8-step fits, a
    900-point field on 3 x 3 cells, and the limits of ``limits_of``."""
    shutil.copytree(os.path.join(ROOT, "bench"), os.path.join(dst, "bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    with open(os.path.join(ROOT, "bench", "configs", "psvgp_e3sm.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    cfg.update(name="tiny", iters=8)
    with open(os.path.join(ROOT, "bench", "traffic", "ne30_fit.json"), encoding="utf-8") as f:
        mix = json.load(f)
    mix.update(n_points=900, grid=[3, 3])
    files = {"bench/configs/tiny.json": cfg, "bench/traffic/tiny_fit.json": mix}
    with open(os.path.join(ROOT, "bench", "limits", f"{limits_of}.json"), encoding="utf-8") as f:
        files[f"bench/limits/{TINY_CELL}.json"] = json.load(f)
    for rel, body in files.items():
        with open(os.path.join(dst, rel), "w", encoding="utf-8") as f:
            json.dump(body, f)
    manifest["configs"].append({"name": "tiny", "source": "tests", "reduced": ["iters"],
                                "file": "bench/configs/tiny.json", "why": "a CPU dry pass"})
    manifest["workloads"].append({"name": TINY_CELL, "config": "tiny", "traffic": "tiny_fit",
                                  "chips": 1, "why": "a CPU dry pass"})
    with open(os.path.join(dst, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    return dst


def add_stub_family(root: str) -> str:
    """Add to the copy under ``root`` a cell of another model family,
    ``stub_lm.stub_train`` (``stub_entry.py`` as its entry), by new files
    and manifest entries alone; returns the cell's name."""
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)), "stub_entry.py"),
                os.path.join(root, "bench", "entries", "stub_lm.py"))
    files = {"bench/configs/stub_lm.json": {"name": "stub_lm", "vocab_size": 64, "hidden_size": 16,
                                            "intermediate_size": 32, "lr": 0.1, "peak": "bf16",
                                            "allow_tf32": False},
             "bench/traffic/stub_train.json": {"entry": "stub_lm", "batch": 4, "seq_len": 8,
                                               "steps_per_unit": 5},
             f"bench/limits/{STUB_CELL}.json": {"steps": 3, "limits": {"loss_gap": 1e-5}}}
    for rel, body in files.items():
        with open(os.path.join(root, rel), "w", encoding="utf-8") as f:
            json.dump(body, f)
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": "stub_lm", "source": "tests", "reduced": [],
                                "file": "bench/configs/stub_lm.json", "why": "another family"})
    manifest["workloads"].append({"name": STUB_CELL, "config": "stub_lm", "traffic": "stub_train",
                                  "chips": 1, "why": "another family on the CPU"})
    with open(os.path.join(root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    return STUB_CELL


def run_tiny(root: str, seed: int = 2**31 + 11, trace: bool = False, cell: str = TINY_CELL):
    """One run of the tiny cell (or ``cell``) on the CPU, the harness's look
    for a chip skipped."""
    import time

    import torch

    from bench import harness

    return harness.run(root, os.path.join(root, "bench"), cell, seed, 0.01, trace,
                       torch.device("cpu"), time.perf_counter())
