"""Pass ``ast`` — repo-rule source lint of the port: its failure modes, as rules.

The walker, the ``noqa`` escape hatch (``# repro: noqa-RRxxx`` on the
flagged line) and the diagnostics are the JAX package's
(``repro.analysis.astlint``); each rule's tables are aimed at the port:

  RR001  nothing at import time initializes CUDA, builds or loads a
         kernel, or joins a process group. The port's modules are
         imported by every test on a machine without a GPU and by every
         spawned rank of the mesh before it joins its group: a
         ``torch.cuda.*`` call, a tensor made with ``device=`` or moved
         with ``.cuda()`` / ``.to(...)``, ``kernels/build.py`` (built "at
         first use ... never at import"), a ``ctypes`` load or a
         ``torch.distributed`` call at module scope breaks them.
  RR002  the host-side routing path stays pure numpy: any ``torch``
         reference inside a declared routing function moves routing onto
         the device and stalls the pipelined loop's overlap window (and
         the mesh lane's ranks, which all route the same batches).
         Deleting a declared function is itself a finding.
  RR003  no bare float64 in the hot paths: the kernels and the serving
         path are float32 end to end (``torch.float64``, ``torch.double``,
         ``.double()``, numpy's ``float64``, the string "float64").
  RR004  frozen config dataclasses validate in ``__post_init__``.

Pure stdlib (``ast``): this pass never imports the code it checks.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis import Finding

RULES = ("RR001", "RR002", "RR003", "RR004")

NOQA_PREFIX = "# repro: noqa-"

# --- RR001: calls that touch the card, a kernel library or a process group
# when Python executes them at import. Dotted origins resolve through the
# file's imports.
_CUDA_ROOT = "torch.cuda."
_CUDA_LAZY = ("torch.cuda.is_available", "torch.cuda.device_count", "torch.cuda.is_initialized")
_DIST_ROOT = "torch.distributed."
_DIST_LAZY = ("torch.distributed.is_available", "torch.distributed.is_initialized")
_KERNEL_ROOTS = ("repro_torch.kernels.build.",)
_KERNEL_CALLS = (
    "ctypes.CDLL",
    "ctypes.cdll.LoadLibrary",
    "torch.ops.load_library",
    "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline",
)
# tensor methods that move a tensor to a device
_MOVE_METHODS = ("cuda", "to")

# --- RR002: declared pure-numpy routing path, keyed by path suffix.
# Dotted names descend into nested defs (closures) and class bodies.
PURE_NUMPY_FUNCTIONS = {
    "repro_torch/core/routing.py": (
        "owning_cells",
        "ceil_to",
        "halo_ids",
        "spill_assign",
        "min_spill_q_max",
        "build_routing_table",
        "halo_slot_on_grid",
        "make_halo_stacker",
        "scatter_results",
        "StreamingQMax",
        "TwoLevelQMax",
    ),
    # the route stages are the pipeline's host-side overlap window (and on
    # the mesh lane every rank runs them on the same batches)
    "repro_torch/launch/serve_sharded.py": (
        "make_router",
        "make_request_stages.route",
        "make_mesh_request_stages.route",
    ),
}

# --- RR003: files whose math must stay f32 end to end.
HOT_PATH_SUFFIXES = (
    "repro_torch/kernels/",
    "repro_torch/core/posterior.py",
    "repro_torch/core/blend.py",
    "repro_torch/core/routing.py",
    "repro_torch/launch/serve.py",
    "repro_torch/launch/serve_sharded.py",
    "repro_torch/api/server.py",
)
# Excluded on purpose: ``kernels/ref.py`` holds the kernels' plain versions
# and the tolerance scales. Its float64 is the design: ``row_products``
# sums every row in one fixed order in float64 and rounds once, which is
# what makes the CPU lanes bitwise across q_max; the scales that
# ``tolerance_ratio`` divides by are float64 so that they do not round
# like the values they bound. The CUDA kernels themselves are float32.
HOT_PATH_EXCLUDED = ("repro_torch/kernels/ref.py",)


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _suppressed(lines: list, lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(lines):
        return NOQA_PREFIX + rule in lines[lineno - 1]
    return False


def import_aliases(tree: ast.AST) -> dict:
    """Map of local name -> dotted origin for every absolute import:
    ``import torch.distributed as dist`` -> {"dist": "torch.distributed"};
    ``import torch`` -> {"torch": "torch"}; ``from torch import cuda`` ->
    {"cuda": "torch.cuda"}."""
    aliases: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node: ast.AST, aliases: dict):
    """Resolve an Attribute/Name chain to its dotted origin, or None when
    its root is not an imported name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name) or node.id not in aliases:
        return None
    parts.append(aliases[node.id])
    return ".".join(reversed(parts))


def _annotation_nodes(tree: ast.AST) -> set:
    """ids of every node inside a type annotation (skipped by RR002)."""
    out: set = set()

    def mark(sub):
        if sub is not None:
            for n in ast.walk(sub):
                out.add(id(n))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mark(node.returns)
            for arg in [
                *node.args.posonlyargs,
                *node.args.args,
                *node.args.kwonlyargs,
                node.args.vararg,
                node.args.kwarg,
            ]:
                if arg is not None:
                    mark(arg.annotation)
        elif isinstance(node, ast.AnnAssign):
            mark(node.annotation)
    return out


# --------------------------------------------------------------------------
# RR001 — nothing touches the card, a kernel or a group at import time
# --------------------------------------------------------------------------


def _import_time_statements(tree: ast.Module):
    """Module-scope and class-body statements plus function default args —
    everything Python EXECUTES at import. Function/method bodies are lazy
    and skipped; so are decorators."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            stack.extend(node.body)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from (d for d in node.args.defaults if d is not None)
            yield from (d for d in node.args.kw_defaults if d is not None)
        else:
            yield node


def _rr001_reason(node: ast.Call, aliases: dict):
    """Why this import-time call is a finding, or None."""
    dotted = _dotted(node.func, aliases)
    if dotted is not None:
        if dotted.startswith(_CUDA_ROOT) and dotted not in _CUDA_LAZY:
            return f"{dotted}(...) initializes CUDA"
        if dotted.startswith(_DIST_ROOT) and dotted not in _DIST_LAZY:
            return f"{dotted}(...) needs a process group"
        if dotted.startswith(_KERNEL_ROOTS) or dotted in _KERNEL_CALLS:
            return f"{dotted}(...) builds or loads a kernel library"
        if dotted.startswith("torch.") and any(kw.arg == "device" for kw in node.keywords):
            return f"{dotted}(..., device=...) creates a tensor on a device"
    if isinstance(node.func, ast.Attribute) and node.func.attr in _MOVE_METHODS:
        if dotted is None or not dotted.startswith("torch."):
            return f".{node.func.attr}(...) moves a tensor to a device"
    return None


def _check_rr001(path: str, tree: ast.Module, lines: list) -> list:
    aliases = import_aliases(tree)
    findings = []
    for stmt in _import_time_statements(tree):
        for node in _eager_calls(stmt):
            why = _rr001_reason(node, aliases)
            if why and not _suppressed(lines, node.lineno, "RR001"):
                findings.append(
                    Finding(
                        "ast",
                        "RR001",
                        f"{path}:{node.lineno}",
                        f"{why} at import time — the tests import every module "
                        "on a machine without a GPU and every spawned rank "
                        "imports them before it joins its group; move it "
                        "behind a function (first use)",
                    )
                )
    return findings


def _eager_calls(node: ast.AST):
    """Every call under ``node`` that runs when ``node`` runs: the bodies
    of nested defs and lambdas are lazy and skipped."""
    if isinstance(node, ast.Call):
        yield node
    for child in ast.iter_child_nodes(node):
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            yield from _eager_calls(child)


# --------------------------------------------------------------------------
# RR002 — declared routing functions stay pure numpy
# --------------------------------------------------------------------------


def _find_def(scope: ast.AST, dotted: str):
    node = scope
    for part in dotted.split("."):
        nxt = None
        for child in ast.walk(node):
            if (
                isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                and child.name == part
                and child is not node
            ):
                nxt = child
                break
        if nxt is None:
            return None
        node = nxt
    return node


def _torch_names(aliases: dict) -> dict:
    return {k: v for k, v in aliases.items() if v == "torch" or v.startswith("torch.")}


def _check_rr002(path: str, tree: ast.Module, lines: list, declared: tuple) -> list:
    module_names = _torch_names(import_aliases(tree))
    findings = []
    for name in declared:
        target = _find_def(tree, name)
        if target is None:
            findings.append(
                Finding(
                    "ast",
                    "RR002",
                    f"{path}:1",
                    f"declared pure-numpy routing function {name!r} not "
                    "found — update astlint.PURE_NUMPY_FUNCTIONS alongside "
                    "the rename/removal",
                )
            )
            continue
        # local imports inside the function count too
        local = dict(module_names)
        local.update(_torch_names(import_aliases(target)))
        if not local:
            continue
        ann = _annotation_nodes(target)
        for node in ast.walk(target):
            if id(node) in ann:
                continue
            if isinstance(node, ast.Name) and node.id in local:
                if not _suppressed(lines, node.lineno, "RR002"):
                    findings.append(
                        Finding(
                            "ast",
                            "RR002",
                            f"{path}:{node.lineno}",
                            f"torch reference {node.id!r} "
                            f"({local[node.id]}) inside routing-path "
                            f"function {name!r} — routing must stay "
                            "host-side numpy or the pipeline overlap "
                            "window collapses",
                        )
                    )
    return findings


# --------------------------------------------------------------------------
# RR003 — no bare float64 in hot paths
# --------------------------------------------------------------------------


_FLOAT64_ALIASES = ("torch.double", "numpy.double")


def _check_rr003(path: str, tree: ast.Module, lines: list) -> list:
    aliases = import_aliases(tree)
    findings = []

    def flag(lineno, what):
        if not _suppressed(lines, lineno, "RR003"):
            findings.append(
                Finding(
                    "ast",
                    "RR003",
                    f"{path}:{lineno}",
                    f"{what} in a serving/kernel hot path — the port's "
                    "kernels and serving path are float32 end to end "
                    "(halo and copy bytes double, the FP64 rate is a "
                    "fraction of FP32's)",
                )
            )

    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and (
                node.attr == "float64" or _dotted(node, aliases) in _FLOAT64_ALIASES):
            flag(node.lineno, f"{node.attr} dtype attribute")
        elif isinstance(node, ast.Name) and node.id == "float64":
            flag(node.lineno, "bare float64 name")
        elif isinstance(node, ast.Constant) and node.value == "float64":
            flag(node.lineno, 'dtype string "float64"')
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "double" and not node.args
              and _dotted(node.func, aliases) not in _FLOAT64_ALIASES):
            flag(node.lineno, ".double() cast")
    return findings


# --------------------------------------------------------------------------
# RR004 — frozen-config dataclasses validate in __post_init__
# --------------------------------------------------------------------------


def _is_frozen_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        fn = dec.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
        if name != "dataclass":
            continue
        for kw in dec.keywords:
            if (
                kw.arg == "frozen"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
            ):
                return True
    return False


def _check_rr004(path: str, tree: ast.Module, lines: list) -> list:
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and _is_frozen_dataclass(node)):
            continue
        has_post = any(
            isinstance(m, ast.FunctionDef) and m.name == "__post_init__"
            for m in node.body
        )
        if not has_post and not _suppressed(lines, node.lineno, "RR004"):
            findings.append(
                Finding(
                    "ast",
                    "RR004",
                    f"{path}:{node.lineno}",
                    f"frozen dataclass {node.name!r} has no __post_init__ "
                    "— frozen configs must validate at construction, not "
                    "mid-serve when the illegal combination finally bites",
                )
            )
    return findings


# --------------------------------------------------------------------------
# Running the pass
# --------------------------------------------------------------------------


def _hot_path(norm: str) -> bool:
    return (any(s in norm for s in HOT_PATH_SUFFIXES)
            and not any(norm.endswith(s) for s in HOT_PATH_EXCLUDED))


def lint_source(path: str, source: str, *, rules: tuple = RULES) -> list:
    """Lint one file's source. ``path`` keys the per-file rule config
    (suffix-matched), so fixtures can pose as any repo file."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("ast", "RR-PARSE", f"{path}:{e.lineno or 1}", str(e))]
    lines = source.splitlines()
    norm = _norm(path)
    findings = []
    if "RR001" in rules:
        findings.extend(_check_rr001(path, tree, lines))
    if "RR002" in rules:
        for suffix, declared in PURE_NUMPY_FUNCTIONS.items():
            if norm.endswith(suffix):
                findings.extend(_check_rr002(path, tree, lines, declared))
    if "RR003" in rules and _hot_path(norm):
        findings.extend(_check_rr003(path, tree, lines))
    if "RR004" in rules:
        findings.extend(_check_rr004(path, tree, lines))
    return findings


def python_files(roots) -> list:
    """Every .py file under ``roots`` (a path or a list of paths; a file
    root is itself), in a stable order."""
    if isinstance(roots, str):
        roots = [roots]
    files = []
    for root in roots:
        if os.path.isfile(root):
            files.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            files += [os.path.join(dirpath, fn) for fn in sorted(filenames) if fn.endswith(".py")]
    return files


def run(root="src/repro_torch", *, rules: tuple = RULES) -> tuple:
    """Lint every .py under ``root`` (a path or a list of paths); returns
    (findings, report)."""
    findings = []
    files = python_files(root)
    for path in files:
        with open(path, encoding="utf-8") as f:
            findings.extend(lint_source(path, f.read(), rules=rules))
    per_rule = {r: 0 for r in rules}
    for f in findings:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    report = {
        "root": root,
        "files_scanned": len(files),
        "rules": list(rules),
        "findings_per_rule": per_rule,
    }
    return findings, report
