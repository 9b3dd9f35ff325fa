"""Pass ``async`` — CFG-lite race lint for the port's asyncio serving layer.

The port's counterpart of ``repro.analysis.asynclint``, almost a copy:
the rules do not depend on the framework. ``api.FrontDoor`` puts an event
loop in front of the card: per-request ``asyncio.Future``s, a batching
engine task, and worker threads for everything that blocks (device
collects, dispatch-time q_max growth). That buys continuous batching —
and a class of hazards no other pass sees: a blocking call on the loop
stalls EVERY client at once; state shared between the loop and a worker
thread races; a dropped task or an unresolved future hangs a client
forever with no traceback anywhere.

The rules, over every source file (today ``api/frontdoor.py``,
``api/server.py``, ``launch/serve_sharded.py``, the ``net/`` transport
layer — and any async code a later PR adds):

  RR005  no blocking calls inside ``async def``: ``time.sleep``,
         ``Future.result()``, stdlib ``queue`` get/put/join, a CUDA
         synchronize (``torch.cuda.synchronize``, a stream's or an
         event's ``.synchronize()`` — the port's ``block_until_ready``),
         or a direct (un-executored) call of a device collect stage.
  RR006  every attribute written from both the event loop and a worker
         thread must be lock-guarded or declared (with its safety
         argument) in the per-class ``CONFINEMENT`` manifest below.
  RR007  ``create_task`` / ``ensure_future`` / ``run_in_executor``
         results must be stored or awaited.
  RR008  a function that delivers request futures (``set_result``) or an
         engine-shaped loop must keep its fallible work inside a ``try``
         whose handler rejects the futures (``set_exception``, possibly
         via a one-call helper).

Same contract as ``astlint``: ``# repro: noqa-RRxxx`` on the offending
line suppresses, the shipped tree must be clean, and every rule has a
known-bad fixture (tests/fixtures/torch_analysis/, and the JAX package's
tests/fixtures/analysis/, on which this pass finds exactly what the JAX
pass finds).
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis import Finding
from repro_torch.analysis.astlint import (  # noqa: F401 (NOQA_PREFIX: re-export)
    NOQA_PREFIX,
    _suppressed,
    python_files,
)

RULES = ("RR005", "RR006", "RR007", "RR008")

# --- RR005 configuration ---------------------------------------------------
# Dotted origins (resolved through import aliases) that block the thread.
BLOCKING_DOTTED = {
    "time.sleep": "time.sleep blocks the loop — use asyncio.sleep",
    "jax.block_until_ready": "a device sync on the loop thread stalls every "
    "client — collect in the worker pool",
    "torch.cuda.synchronize": "a CUDA synchronize on the loop thread stalls "
    "every client — collect in the worker pool",
}
# Method names that block no matter the receiver.
BLOCKING_ATTRS = {
    "result": "concurrent Future.result() blocks the loop — await the "
    "future (or wrap it with asyncio.wrap_future)",
    "block_until_ready": "a device sync on the loop thread stalls every "
    "client — collect in the worker pool",
    "synchronize": "a stream's or event's synchronize() on the loop thread "
    "stalls every client — collect in the worker pool",
}
# Direct calls of a device collect stage inside async code: the collect
# triple's third stage blocks on device results by contract and must go
# through run_in_executor (see FrontDoor._resolve).
COLLECT_ATTRS = ("collect", "_collect")
# Blocking stdlib-queue methods (asyncio.Queue's get/put are coroutines
# and are awaited; a known stdlib queue.Queue is blocking regardless).
QUEUE_BLOCKING_ATTRS = ("get", "put", "join")
STDLIB_QUEUE_TYPES = ("queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
                      "queue.PriorityQueue")

# --- RR006 configuration ---------------------------------------------------
# Per-class thread-confinement manifest, path-suffix keyed like astlint's
# per-file configs. Maps attribute -> the reason a dual-context write is
# safe; anything not listed (and not lock-guarded) is a finding.
CONFINEMENT: dict = {
    "repro_torch/api/frontdoor.py": {
        # No exemptions: FrontDoor's design is strict confinement — all
        # mutable state belongs to the event loop except the per-batch
        # counters, which the dispatch thread writes UNDER _stats_lock
        # (lock-guarded writes pass without a manifest entry).
        "FrontDoor": {},
    },
    "repro_torch/api/server.py": {
        # Server.swap flips the serving generation while the front door's
        # dispatch/collect threads are mid-stream. The design is a single
        # atomic reference handoff, not shared mutation:
        "Server": {
            "_active": (
                "written only under _swap_lock (Server.swap); readers never "
                "lock — the request_stages trampolines snapshot the "
                "reference EXACTLY ONCE per request (at route time) and "
                "thread the snapshotted context through submit/collect, so "
                "a request is served end-to-end by one model generation "
                "and the flip is a plain atomic reference store"
            ),
        },
    },
    "repro_torch/net/server.py": {
        # The HTTP endpoint is pure event-loop code: connection handlers
        # are loop tasks, the engine's threads live behind FrontDoor's
        # own (already-manifested) confinement, and NetServer never
        # hands a method to a worker — so its transport counters are
        # loop-confined by construction and need no exemptions.
        "NetServer": {},
    },
}
# A with-block on an attribute whose name contains this guards its body.
LOCK_NAME_HINT = "lock"
# Call names that hand a callable to another thread.
THREAD_HANDOFF_CALLS = ("run_in_executor", "submit", "Thread")
MUTATOR_METHODS = ("append", "extend", "insert", "add", "update", "pop",
                   "popleft", "remove", "clear", "setdefault")

# --- RR007 / RR008 configuration -------------------------------------------
TASK_SPAWN_CALLS = ("create_task", "ensure_future", "run_in_executor")
QUEUE_READ_ATTRS = ("get", "get_nowait")
# Call names the RR008 risk model treats as non-throwing plumbing. Keep
# tight: anything novel counts as fallible until listed.
SAFE_CALLS = frozenset({
    "set_result", "set_exception", "done", "cancel", "cancelled",
    "append", "len", "range", "isinstance", "zip", "enumerate", "list",
    "int", "float", "bool", "print", "time", "get_running_loop",
    "get_event_loop",
})


def _import_aliases(tree: ast.Module) -> dict:
    """Local name -> dotted origin for EVERY import (the generic sibling
    of ``astlint.jax_aliases``): ``from time import sleep`` ->
    {"sleep": "time.sleep"}; ``import queue as q`` -> {"q": "queue"}."""
    aliases: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    aliases[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node: ast.AST, aliases: dict) -> str | None:
    """Resolve an Attribute/Name chain through the alias map; unlike the
    astlint variant, an unaliased root still resolves (to itself) so
    ``self._queue.get`` names itself."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(aliases.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def _call_name(call: ast.Call) -> str | None:
    """Terminal name of a call: ``loop.create_task`` -> "create_task"."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _own_nodes(fn: ast.AST) -> list:
    """Every node of ``fn`` excluding nested function/class bodies (their
    code runs in a context of its own)."""
    out = []
    stack = [(fn, True)]
    while stack:
        node, is_root = stack.pop()
        if not is_root and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            continue
        out.append(node)
        for child in ast.iter_child_nodes(node):
            stack.append((child, False))
    return out


def _awaited_ids(nodes: list) -> set:
    """ids of every node under an ``await`` expression."""
    out: set = set()
    for node in nodes:
        if isinstance(node, ast.Await):
            for sub in ast.walk(node):
                out.add(id(sub))
    return out


def _stdlib_queues(tree: ast.Module, aliases: dict) -> set:
    """Dotted names bound to a blocking stdlib queue constructor —
    ``self._q = queue.Queue()`` yields {"self._q"}."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if _dotted(node.value.func, aliases) in STDLIB_QUEUE_TYPES:
                for tgt in node.targets:
                    d = _dotted(tgt, aliases)
                    if d:
                        out.add(d)
    return out


# --------------------------------------------------------------------------
# RR005 — blocking calls on the event loop
# --------------------------------------------------------------------------


def _check_rr005(path: str, tree: ast.Module, lines: list, aliases: dict) -> list:
    findings = []
    queues = _stdlib_queues(tree, aliases)
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        nodes = _own_nodes(fn)
        awaited = _awaited_ids(nodes)
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            why = None
            dotted = _dotted(node.func, aliases)
            name = _call_name(node)
            receiver = (
                _dotted(node.func.value, aliases)
                if isinstance(node.func, ast.Attribute)
                else None
            )
            if dotted in BLOCKING_DOTTED:
                why = BLOCKING_DOTTED[dotted]
            elif name in BLOCKING_ATTRS and isinstance(node.func, ast.Attribute):
                why = BLOCKING_ATTRS[name]
            elif name in COLLECT_ATTRS and isinstance(node.func, ast.Attribute):
                why = (
                    "direct call of a collect stage on the loop thread — "
                    "device syncs go through run_in_executor"
                )
            elif receiver in queues and name in QUEUE_BLOCKING_ATTRS:
                why = f"stdlib queue.{name}() blocks the loop — use asyncio.Queue"
            elif (
                name in QUEUE_BLOCKING_ATTRS
                and receiver is not None
                and "queue" in receiver.lower()
                and id(node) not in awaited
            ):
                why = (
                    f"un-awaited .{name}() on a queue inside async code — "
                    "either a blocking stdlib queue or a dropped coroutine"
                )
            if why and not _suppressed(lines, node.lineno, "RR005"):
                findings.append(
                    Finding(
                        "async",
                        "RR005",
                        f"{path}:{node.lineno}",
                        f"blocking call in `async def {fn.name}`: {why}",
                    )
                )
    return findings


# --------------------------------------------------------------------------
# RR006 — loop/worker dual writes without lock or declaration
# --------------------------------------------------------------------------


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _method_writes(method: ast.AST) -> list:
    """(attr, lineno, guarded) for every ``self.<attr>`` write in a
    method: assignments plus in-place mutator calls, with ``guarded``
    true inside ``with self.<something-lock>:``."""
    writes = []

    def visit(node, guarded):
        if isinstance(node, ast.With):
            has_lock = any(
                (_self_attr(item.context_expr) or "")
                .lower()
                .find(LOCK_NAME_HINT)
                >= 0
                for item in node.items
            )
            for child in ast.iter_child_nodes(node):
                visit(child, guarded or has_lock)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            if node is not method:
                return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr:
                    writes.append((attr, node.lineno, guarded))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in MUTATOR_METHODS:
                attr = _self_attr(node.func.value)
                if attr:
                    writes.append((attr, node.lineno, guarded))
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(method, False)
    return writes


def _context_methods(cls: ast.ClassDef) -> tuple:
    """(loop_methods, worker_methods) by name, each closed over direct
    ``self.<m>()`` calls. Loop context seeds from ``async def``; worker
    context seeds from methods handed to executors/threads."""
    methods = {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    calls: dict = {name: set() for name in methods}
    for name, node in methods.items():
        for sub in _own_nodes(node):
            if isinstance(sub, ast.Call):
                callee = _self_attr(sub.func)
                if callee in methods:
                    calls[name].add(callee)

    worker_seeds = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and _call_name(node) in THREAD_HANDOFF_CALLS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                attr = _self_attr(arg)
                if attr in methods and not isinstance(arg, ast.Call):
                    worker_seeds.add(attr)
    loop_seeds = {
        name for name, node in methods.items()
        if isinstance(node, ast.AsyncFunctionDef)
    }

    def closure(seeds):
        seen = set(seeds)
        frontier = list(seeds)
        while frontier:
            m = frontier.pop()
            for callee in calls.get(m, ()):
                if callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen

    return closure(loop_seeds), closure(worker_seeds)


def _confinement_for(path: str, cls_name: str) -> dict | None:
    norm = path.replace(os.sep, "/")
    for suffix, classes in CONFINEMENT.items():
        if norm.endswith(suffix) and cls_name in classes:
            return classes[cls_name]
    return None


def _check_rr006(path: str, tree: ast.Module, lines: list) -> list:
    findings = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        loop_methods, worker_methods = _context_methods(cls)
        if not worker_methods:
            continue
        declared = _confinement_for(path, cls.name) or {}
        methods = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # attr -> [(context, lineno, guarded)]
        by_attr: dict = {}
        for name, node in methods.items():
            contexts = []
            if name in loop_methods:
                contexts.append("loop")
            if name in worker_methods:
                contexts.append("worker")
            if not contexts:
                continue
            for attr, lineno, guarded in _method_writes(node):
                for ctx in contexts:
                    by_attr.setdefault(attr, []).append((ctx, lineno, guarded))
        for attr, writes in sorted(by_attr.items()):
            ctxs = {c for c, _, _ in writes}
            if len(ctxs) < 2 or attr in declared:
                continue
            unguarded = [(c, ln) for c, ln, g in writes if not g]
            if not unguarded:
                continue
            ctx, lineno = unguarded[0]
            if _suppressed(lines, lineno, "RR006"):
                continue
            findings.append(
                Finding(
                    "async",
                    "RR006",
                    f"{path}:{lineno}",
                    f"`self.{attr}` of class {cls.name} is written from both "
                    "the event loop and a worker thread without a lock — "
                    "guard every write with a lock, or declare the attribute "
                    "(with its safety argument) in asynclint.CONFINEMENT",
                )
            )
    return findings


# --------------------------------------------------------------------------
# RR007 — lost tasks
# --------------------------------------------------------------------------


def _check_rr007(path: str, tree: ast.Module, lines: list) -> list:
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
            continue
        call = node.value
        if _call_name(call) not in TASK_SPAWN_CALLS:
            continue
        if _suppressed(lines, node.lineno, "RR007"):
            continue
        findings.append(
            Finding(
                "async",
                "RR007",
                f"{path}:{node.lineno}",
                f"{_call_name(call)}(...) result neither stored nor awaited "
                "— the task's only reference is dropped: its exception "
                "vanishes and the task itself may be garbage-collected "
                "mid-flight",
            )
        )
    return findings


# --------------------------------------------------------------------------
# RR008 — orphanable request futures
# --------------------------------------------------------------------------


def _rejecting_methods(tree: ast.Module) -> set:
    """Names of functions whose body calls ``set_exception`` — one level
    of indirection for crash handlers (e.g. ``self._fail_requests``)."""
    out = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in _own_nodes(fn):
                if isinstance(sub, ast.Call) and _call_name(sub) == "set_exception":
                    out.add(fn.name)
                    break
    return out


def _handler_rejects(handler: ast.ExceptHandler, rejecting: set) -> bool:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Call):
            name = _call_name(sub)
            if name == "set_exception" or name in rejecting:
                return True
    return False


def _protected_ids(fn: ast.AST, rejecting: set) -> set:
    """ids of nodes covered by a try whose handler rejects futures."""
    out: set = set()
    for node in _own_nodes(fn):
        if isinstance(node, ast.Try) and any(
            _handler_rejects(h, rejecting) for h in node.handlers
        ):
            for sub in ast.walk(node):
                out.add(id(sub))
    return out


def _delivers_futures(fn: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call) and _call_name(n) == "set_result"
        for n in _own_nodes(fn)
    )


def _engine_shaped(fn: ast.AST) -> bool:
    if not isinstance(fn, ast.AsyncFunctionDef):
        return False
    nodes = _own_nodes(fn)
    spawns = any(
        isinstance(n, ast.Call) and _call_name(n) in TASK_SPAWN_CALLS for n in nodes
    )
    reads = any(
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr in QUEUE_READ_ATTRS
        for n in nodes
    )
    return spawns and reads


def _check_rr008(path: str, tree: ast.Module, lines: list) -> list:
    findings = []
    rejecting = _rejecting_methods(tree)
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in rejecting and not _delivers_futures(fn):
            continue  # rejection helpers are the remedy, not the hazard
        if not (_delivers_futures(fn) or _engine_shaped(fn)):
            continue
        protected = _protected_ids(fn, rejecting)
        for node in _own_nodes(fn):
            risky = isinstance(node, ast.Await) or (
                isinstance(node, ast.Call) and _call_name(node) not in SAFE_CALLS
            )
            if not risky or id(node) in protected:
                continue
            if _suppressed(lines, node.lineno, "RR008"):
                break
            findings.append(
                Finding(
                    "async",
                    "RR008",
                    f"{path}:{node.lineno}",
                    f"`{fn.name}` owns per-request futures but this "
                    "expression can raise outside any try/except that "
                    "rejects them (set_exception) — an exception here "
                    "orphans the futures and hangs their clients",
                )
            )
            break  # one finding per function: fix the structure, re-run
    return findings


# --------------------------------------------------------------------------
# Front door (mirrors astlint)
# --------------------------------------------------------------------------


def lint_source(path: str, source: str, *, rules: tuple = RULES) -> list:
    """Lint one file's source. ``path`` keys the confinement manifest
    (suffix-matched), so fixtures can pose as any repo file."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("async", "RR-PARSE", f"{path}:{e.lineno or 1}", str(e))]
    lines = source.splitlines()
    aliases = _import_aliases(tree)
    findings = []
    if "RR005" in rules:
        findings.extend(_check_rr005(path, tree, lines, aliases))
    if "RR006" in rules:
        findings.extend(_check_rr006(path, tree, lines))
    if "RR007" in rules:
        findings.extend(_check_rr007(path, tree, lines))
    if "RR008" in rules:
        findings.extend(_check_rr008(path, tree, lines))
    return findings


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
        "rules": {r: per_rule.get(r, 0) for r in sorted(per_rule)},
    }
    return findings, report
