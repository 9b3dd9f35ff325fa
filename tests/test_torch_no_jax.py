"""The port runs without JAX: no module of ``repro_torch``, no
``examples/*_torch.py`` twin and not ``chip_smoke.py`` imports ``jax``,
anything of the JAX package ``repro``, or ``msgpack`` (the machine with
the card has none).

Two checks: an AST scan of every import statement (``repro_torch`` is
allowed, ``repro`` / ``repro.*``, ``jax`` / ``jax.*`` and ``msgpack`` are
not), and a subprocess that makes ``jax``, ``repro`` and ``msgpack``
unimportable and then imports every module of the port, the example
twins and ``chip_smoke.py``. Plus ``chip_smoke.py``'s
refusals: without a CUDA device, and alone in a directory, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import ast
import glob
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")
EXAMPLE_TWINS = sorted(glob.glob(os.path.join(REPO, "examples", "*_torch.py")))


def _port_files() -> list[str]:
    out = []
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(out) + EXAMPLE_TWINS + [CHIP_SMOKE]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro", "msgpack")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import_statement(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_four_example_twins_are_checked():
    names = [os.path.basename(p) for p in EXAMPLE_TWINS]
    assert names == ["delta_sweep_torch.py", "e3sm_insitu_torch.py", "quickstart_torch.py",
                     "serve_demo_torch.py"]


def test_forbidden_rule_allows_the_port_itself():
    assert _forbidden("repro") and _forbidden("repro.core.routing") and _forbidden("jax.numpy")
    assert _forbidden("msgpack")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.core.routing")


def test_every_port_module_imports_with_jax_and_repro_unimportable():
    code = textwrap.dedent(
        """
        import importlib, importlib.util, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.modules["msgpack"] = None  # the card's machine has none
        sys.path.insert(0, "src")
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        for path in sys.argv[1:] + ["chip_smoke.py"]:
            spec = importlib.util.spec_from_file_location("m", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "msgpack")
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print(len(names))
        """
    )
    r = subprocess.run([sys.executable, "-c", code, *EXAMPLE_TWINS], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 50


def test_chip_smoke_refuses_without_cuda_and_alone(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    r = subprocess.run([sys.executable, CHIP_SMOKE], cwd=REPO, capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    shutil.copy(CHIP_SMOKE, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
