"""The port's source passes (``repro_torch.analysis``): ``ast`` (RR001-RR004)
and ``async`` (RR005-RR008), on the CPU with no GPU.

  * every known-bad fixture in tests/fixtures/torch_analysis/ is flagged
    by EXACTLY its rule, ``noqa`` suppresses it, and stripping the
    ``noqa`` brings it back;
  * the shipped port is clean under both passes: ``src/repro_torch``,
    ``chip_smoke.py`` and ``examples/*_torch.py``;
  * parity with the JAX package: the async rules on the JAX fixtures
    (tests/fixtures/analysis/bad_async_*.py, suppressed_async_ok.py) and
    RR004 on its bad_config.py give exactly the JAX pass's (rule, line)
    findings — those rules do not depend on the framework;
  * the CLI's exit codes 0, 1 and 2 in a subprocess, its report path
    (never the JAX lane's ANALYSIS.json), and that it imports no torch.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import astlint as jastlint
from repro.analysis import asynclint as jasynclint
from repro_torch.analysis import PASSES, Finding, astlint, asynclint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_analysis")
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
SHIPPED = ([os.path.join(REPO, "src", "repro_torch"), os.path.join(REPO, "chip_smoke.py")]
           + sorted(glob.glob(os.path.join(REPO, "examples", "*_torch.py"))))


def _fixture(rel, root=FIXTURES):
    path = os.path.join(root, rel)
    with open(path, encoding="utf-8") as f:
        return path, f.read()


def _rules(findings):
    return sorted({f.rule for f in findings})


def _lines(findings):
    return sorted((f.rule, int(f.where.rsplit(":", 1)[1])) for f in findings)


def test_finding_validates_and_the_passes_are_the_source_passes():
    # the source passes, among JAX's five in JAX's order
    assert PASSES == ("hlo", "ast", "contracts", "costs", "async")
    f = Finding("ast", "RR001", "x.py:3", "m")
    assert str(f) == "[RR001] x.py:3: m" and f.to_dict()["pass_name"] == "ast"
    with pytest.raises(ValueError):
        Finding("vibes", "RR001", "x.py:3", "m")  # no such pass
    with pytest.raises(ValueError):
        Finding("ast", "", "x.py:3", "m")


# --------------------------------------------------------------------------
# the port's fixtures: each caught by exactly its rule
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "rel,rule,count",
    [
        ("bad_import_cuda.py", "RR001", 1),
        ("bad_import_device.py", "RR001", 2),
        ("bad_import_kernel.py", "RR001", 2),
        ("bad_import_group.py", "RR001", 1),
        (os.path.join("repro_torch", "core", "routing.py"), "RR002", 1),
        (os.path.join("repro_torch", "launch", "serve_sharded.py"), "RR002", 1),
        (os.path.join("repro_torch", "kernels", "bad_f64.py"), "RR003", 2),
        ("bad_config.py", "RR004", 1),
    ],
)
def test_fixture_caught_by_exactly_the_expected_rule(rel, rule, count):
    path, source = _fixture(rel)
    findings = astlint.lint_source(path, source)
    assert _rules(findings) == [rule], findings
    assert len(findings) == count, findings
    assert asynclint.lint_source(path, source) == []


def test_async_fixture_caught_by_exactly_rr005():
    path, source = _fixture("bad_async_cuda_sync.py")
    findings = asynclint.lint_source(path, source)
    assert _lines(findings) == [("RR005", 8), ("RR005", 9)], findings
    assert astlint.lint_source(path, source) == []


@pytest.mark.parametrize("rel,lint,rules", [
    ("suppressed_ok.py", astlint, ["RR001", "RR004"]),
    ("suppressed_async_ok.py", asynclint, ["RR005"]),
])
def test_noqa_suppresses_and_stripping_it_brings_the_findings_back(rel, lint, rules):
    path, source = _fixture(rel)
    assert lint.lint_source(path, source) == []
    stripped = "\n".join(line.split("# repro: noqa-")[0] for line in source.splitlines())
    assert _rules(lint.lint_source(path, stripped)) == rules


def test_the_fixture_tree_is_dirty_end_to_end():
    findings, report = astlint.run(FIXTURES)
    assert _rules(findings) == ["RR001", "RR002", "RR003", "RR004"]
    assert report["findings_per_rule"] == {"RR001": 6, "RR002": 2, "RR003": 2, "RR004": 1}
    findings, _ = asynclint.run(FIXTURES)
    assert _rules(findings) == ["RR005"]


def test_rr001_skips_lazy_contexts_and_catches_default_args():
    lazy = textwrap.dedent(
        """
        import torch
        import torch.distributed as dist

        def f(x):
            return torch.zeros(3, device="cuda") + x.cuda()

        g = lambda: torch.cuda.synchronize()
        CPU = torch.zeros(3)
        HAVE = torch.cuda.is_available() and torch.cuda.device_count() > 0
        DIST = dist.is_available()

        class C:
            def m(self):
                return dist.init_process_group("gloo")
        """
    )
    assert astlint.lint_source("src/repro_torch/x.py", lazy) == []
    default = "import torch\ndef f(x=torch.ones(3, device='cuda')):\n    return x\n"
    assert _rules(astlint.lint_source("src/repro_torch/x.py", default)) == ["RR001"]
    in_class = "import torch\nclass C:\n    DEV = torch.cuda.current_device()\n"
    assert _rules(astlint.lint_source("src/repro_torch/x.py", in_class)) == ["RR001"]


def test_rr002_declared_function_cannot_silently_vanish():
    findings = astlint.lint_source("src/repro_torch/launch/serve_sharded.py",
                                   "import numpy as np\n")
    assert _rules(findings) == ["RR002"]
    assert len(findings) == 3 and all("not found" in f.message for f in findings)


def test_rr003_covers_the_hot_paths_and_excludes_the_plain_versions():
    source = "import torch\ndef f(x):\n    return x.double(), torch.double, 'float64'\n"
    assert len(astlint.lint_source("src/repro_torch/core/posterior.py", source)) == 3
    assert astlint.lint_source("src/repro_torch/kernels/ref.py", source) == []
    assert astlint.lint_source("src/repro_torch/core/metrics.py", source) == []


# --------------------------------------------------------------------------
# the shipped port is clean
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lint", [astlint, asynclint], ids=["ast", "async"])
def test_shipped_port_is_clean(lint):
    findings, report = lint.run(SHIPPED)
    assert findings == [], [str(f) for f in findings]
    assert report["files_scanned"] >= 55  # the package, chip_smoke.py, 4 example twins


def test_the_deliberate_float64_lines_are_marked_not_hidden():
    """RR003's exceptions in the port are per line, each with its reason,
    and stripping the marks brings every one back."""
    for rel in ("core/posterior.py", "core/blend.py"):
        path, source = _fixture(rel, os.path.join(REPO, "src", "repro_torch"))
        stripped = "\n".join(line.split("# repro: noqa-")[0] for line in source.splitlines())
        assert _rules(astlint.lint_source(path, stripped)) == ["RR003"], rel


# --------------------------------------------------------------------------
# parity with the JAX pass on the JAX fixtures
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["bad_async_rr005.py", "bad_async_rr006.py",
                                 "bad_async_net_rr006.py", "bad_async_rr007.py",
                                 "bad_async_rr008.py", "suppressed_async_ok.py"])
def test_async_rules_find_exactly_what_the_jax_pass_finds(rel):
    path, source = _fixture(rel, JAX_FIXTURES)
    want = _lines(jasynclint.lint_source(path, source))
    assert _lines(asynclint.lint_source(path, source)) == want
    stripped = "\n".join(line.split("# repro: noqa-")[0] for line in source.splitlines())
    assert _lines(asynclint.lint_source(path, stripped)) == _lines(
        jasynclint.lint_source(path, stripped))
    if rel != "suppressed_async_ok.py":
        assert want, rel


def test_rr004_finds_exactly_what_the_jax_pass_finds():
    path, source = _fixture("bad_config.py", JAX_FIXTURES)
    want = _lines(jastlint.lint_source(path, source))
    assert want == [("RR004", 6)]
    assert _lines(astlint.lint_source(path, source)) == want


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def _run_cli(*argv, code="from repro_torch.analysis.__main__ import main; sys.exit(main())"):
    env = dict(os.environ, PYTHONPATH="src", CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c", f"import sys; sys.argv[1:] = {list(argv)!r}; {code}"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )


def test_cli_clean_on_the_shipped_port_and_imports_no_torch(tmp_path):
    out = tmp_path / "report.json"
    roots = [a for p in SHIPPED for a in ("--root", os.path.relpath(p, REPO))]
    code = ("from repro_torch.analysis.__main__ import main; rc = main(); "
            "assert 'torch' not in sys.modules, 'the CLI imported torch'; sys.exit(rc)")
    r = _run_cli("--passes", "ast,async", *roots, "--out", str(out), code=code)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["total_findings"] == 0
    assert report["passes"]["ast"]["findings_per_rule"] == {f"RR00{i}": 0 for i in range(1, 5)}
    assert report["passes"]["async"]["rules"] == {f"RR00{i}": 0 for i in range(5, 9)}


def test_cli_exits_1_on_the_fixtures_and_writes_its_default_report(tmp_path):
    out = tmp_path / "ANALYSIS_TORCH.json"
    r = _run_cli("--passes", "ast,async", "--root", "tests/fixtures/torch_analysis",
                 "--out", str(out))
    assert r.returncode == 1, r.stdout[-2000:] + r.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["passes"]["ast"]["findings_per_rule"] == {
        "RR001": 6, "RR002": 2, "RR003": 2, "RR004": 1}
    assert report["passes"]["async"]["rules"]["RR005"] == 2


def test_cli_exits_2_on_an_unknown_pass_and_never_writes_the_jax_report(tmp_path):
    # a program pass on the default device, cuda, which this run hides
    assert _run_cli("--passes", "hlo").returncode == 2
    assert _run_cli("--passes", "vibes").returncode == 2
    jax_report = tmp_path / "ANALYSIS.json"
    r = _run_cli("--out", str(jax_report))
    assert r.returncode == 2 and not jax_report.exists()
    from repro_torch.analysis.__main__ import DEFAULT_OUT

    assert DEFAULT_OUT != "ANALYSIS.json"
