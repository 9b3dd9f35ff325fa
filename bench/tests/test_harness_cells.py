"""The harness: driven by data, held to the manifest's contract, and
refusing to print a result where it must not."""
from __future__ import annotations

import ast
import glob
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest
from conftest import ROOT, TINY_CELL, add_stub_family, run_tiny, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def digest(tree: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(tree, "**", "*"), recursive=True)):
        if os.path.isfile(path) and "__pycache__" not in path:
            with open(path, "rb") as f:
                out[os.path.relpath(path, tree)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_new_config_mix_cell_and_metric_need_no_edit(tmp_path):
    """A throwaway configuration, mix, limits, cell and per-layer metric,
    added by new files and manifest entries alone, are found by name; so is
    a cell of another model family, with an entry of its own."""
    root = tiny_copy(str(tmp_path))
    stub = add_stub_family(root)
    reader = os.path.join(root, "bench", "metrics", "fits_per_window.py")
    with open(reader, "w", encoding="utf-8") as f:
        f.write('def read(records):\n    return float(records["window"]["units"])\n')
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        m = json.load(f)
    m["per_layer"].append({"name": "fits_per_window", "unit": "fits", "better": "higher",
                           "source": "host_clock", "layer": "SGD loop, graph lane",
                           "moves": "fit_step_ms", "workloads": [TINY_CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(m, f)
    before = {k: v for k, v in digest(os.path.join(ROOT, "bench")).items()
              if not k.startswith("tests")}
    plain = run_tiny(root)
    traced = run_tiny(root, trace=True)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"fit_step_ms", "setup_s"}
    assert traced["metrics"]["fits_per_window"]["value"] >= 1
    assert {"replay_step_ms", "capture_ms"} <= set(traced["metrics"])
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "fits", "check"]
    assert list(traced)[-1] == "check"
    other = {trace: run_tiny(root, trace=trace, cell=stub) for trace in (False, True)}
    assert all(r["correct"] and r["failed"] == 0 for r in other.values()), other
    assert set(other[False]["metrics"]) == {"fit_step_ms", "setup_s"}
    # no CUDA events, device or card here: the host-timed steps are read,
    # the trace's device share and step_mfu are not
    assert set(other[True]["metrics"]) == {"replay_step_ms", "capture_ms"}
    assert other[True]["device"]["busy_s"] == 0.0
    copied = digest(os.path.join(root, "bench"))
    assert all(copied[k] == v for k, v in before.items())


def test_manifest_keeps_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["bench"] and m["command"] == ["python3", "bench/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    cells = len(m["workloads"])
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in m["workloads"]) <= 1
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in m["workloads"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        for rel in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.isfile(os.path.join(ROOT, "bench", rel)), rel
        with open(os.path.join(ROOT, "bench", "traffic", f"{w['traffic']}.json")) as f:
            entry = json.load(f)["entry"]
        assert os.path.isfile(os.path.join(ROOT, "bench", "entries", f"{entry}.py"))
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(ROOT, "bench", "metrics", f"{x['name']}.py"))
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["moves"] in e2e and "\n" not in x["layer"]
        assert set(x.get("workloads", [])) <= {w["name"] for w in m["workloads"]}
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    assert len(json.dumps(m)) <= 64 * 1024


def test_layers_are_perfs_layers():
    with open(os.path.join(ROOT, "PERF.md"), encoding="utf-8") as f:
        perf = f.read()
    for x in manifest()["per_layer"]:
        assert f"| {x['layer']} |" in perf, x["layer"]


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def imports(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "bench", "**", "*.py"),
                                               recursive=True)),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_a_reference_free_of_the_program(path):
    names = {n.split(".")[0] for n in imports(path)}
    assert not names & set(FORBIDDEN), path
    if os.sep + "reference" + os.sep in path:
        assert "repro_torch" not in names, path


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def test_a_run_loads_no_jax(tmp_path):
    """In a process where JAX and the JAX package cannot be imported, a
    whole traced run of the tiny cell works and leaves none of them loaded."""
    root = tiny_copy(str(tmp_path))
    code = BLOCKER + f"""
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}, {os.path.join(ROOT, 'bench', 'tests')!r}]
import torch; torch.set_num_threads(1)
from conftest import run_tiny
from bench import harness
r = run_tiny({root!r}, trace=True)
print(r["correct"], harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=False)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_forbidden_modules_compare_whole_names():
    from bench import harness

    assert harness.forbidden_modules(["repro_torch.core.psvgp", "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.core", "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]


def run_py(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "psvgp_e3sm.ne30_fit",
                           "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
                          check=False)


def test_run_refuses_without_a_card():
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_refuses_beside_only_its_own_files(tmp_path):
    tiny_copy(str(tmp_path))
    out = run_py(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
