"""Pass ``contracts`` — shape contracts on the serving entry points.

The port's counterpart of ``repro.analysis.contracts``. A
``@contract(...)`` decorator declares, next to the code, what shapes a
serving entry point consumes and produces (``"(S, Q)"``-style expressions
in the JAX package's grammar, symbols unified across a declaration) plus
named cross-stage invariants. The decorator only REGISTERS the declaration
and returns the function unchanged — nothing at run time. This pass checks
every declaration against the real code:

  * the host stages (routing, scatter) run for real on tiny numpy arrays;
  * the device stages run under ``torch._subclasses.FakeTensorMode`` on
    fake CPU tensors — no data is computed, and the kernel dispatch sees
    the CPU, so every lane takes its plain version (the kernels' shapes
    are the plain versions' by construction: ``chip_smoke.py`` holds them
    equal on the card). A fake tensor on "cuda" would reach a ctypes
    launch with no memory behind it, so the pass never makes one.

The targets are the port's counterparts of JAX's four:

  * ``predict_cached_slots``   (S, Q) outputs, f32, on every kernel lane;
  * ``make_sharded_blend``     the mesh program's in/out shapes on one
                               rank (P = 1), per backend, with a stub
                               ``HaloMesh`` whose shift returns zeros;
  * ``make_request_stages``    route's table/blocks agree with the policy
                               (q_max never re-rounded) AND with what the
                               halo program accepts, per policy kind;
  * ``scatter_results``        the exact inverse property: gather-by-table
                               then scatter restores request order.

A declaration is load-bearing twice over: deleting a ``@contract`` from an
expected target is itself a finding (``EXPECTED_TARGETS``), and every
shape expression is parsed and unified against reality — a stale string
fails the pass.

Import-light: stdlib and numpy at import time (the port's core modules
import it for the decorator); torch loads only inside harnesses.
"""
from __future__ import annotations

import dataclasses
import importlib
import re
import time

import numpy as np

from repro_torch.analysis import Finding

# --------------------------------------------------------------------------
# Declaration machinery (the JAX package's)
# --------------------------------------------------------------------------

_REGISTRY: dict = {}

# Every target that must carry a @contract. Removing a decorator (or
# renaming a target) without updating this list is a CONTRACT-MISSING
# finding — the declaration cannot silently rot away.
EXPECTED_TARGETS = (
    "repro_torch.core.posterior.predict_cached_slots",
    "repro_torch.core.routing.scatter_results",
    "repro_torch.launch.serve_sharded.make_sharded_blend",
    "repro_torch.launch.serve_sharded.make_request_stages",
)

# Named invariants a declaration may claim; the harnesses enforce exactly
# these. Declaring an unknown name is a finding (both sides stay in sync).
KNOWN_INVARIANTS = (
    "q_max-matches-policy",  # route never re-rounds the policy's q_max
    "q_max-aligned",  # table.q_max % pad_multiple == 0
    "scatter-is-gather-inverse",  # scatter(gather(x)) == x exactly
    "outputs-f32",  # serving math returns float32
)

BACKENDS = ("ref", "pallas", "fused")


@dataclasses.dataclass(frozen=True)
class ContractDecl:
    target: str  # "module.qualname"
    spec: dict  # shape expressions + invariant names, per target kind

    def __post_init__(self) -> None:
        if not self.target or "." not in self.target:
            raise ValueError(f"target must be module.qualname, got {self.target!r}")
        if not isinstance(self.spec, dict) or not self.spec:
            raise ValueError(f"empty contract spec for {self.target}")


def contract(**spec):
    """Declare a serving contract. Registers and returns ``fn`` unchanged."""

    def deco(fn):
        target = f"{fn.__module__}.{fn.__qualname__}"
        _REGISTRY[target] = ContractDecl(target=target, spec=spec)
        return fn

    return deco


# --------------------------------------------------------------------------
# Shape-expression parsing and unification (the JAX package's)
# --------------------------------------------------------------------------

_DIM_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def parse_shape(expr: str) -> tuple:
    """'(S, Q, 4)' -> ('S', 'Q', 4); '(N,)' -> ('N',)."""
    body = expr.strip()
    if not (body.startswith("(") and body.endswith(")")):
        raise ValueError(f"shape expression must be parenthesized: {expr!r}")
    parts = [p.strip() for p in body[1:-1].split(",") if p.strip()]
    dims = []
    for p in parts:
        if p.lstrip("-").isdigit():
            dims.append(int(p))
        elif _DIM_RE.match(p):
            dims.append(p)
        else:
            raise ValueError(f"bad dimension {p!r} in {expr!r}")
    return tuple(dims)


def unify(expr: str, shape: tuple, env: dict):
    """Unify a shape expression with an actual shape under ``env``.

    Literal dims must match exactly; symbolic dims bind on first use and
    must agree thereafter. Returns an error string, or None on success.
    ``env`` is updated in place so one declaration's symbols are shared
    across all its expressions.
    """
    dims = parse_shape(expr)
    if len(dims) != len(shape):
        return f"rank mismatch: {expr} vs actual {tuple(shape)}"
    for d, s in zip(dims, shape, strict=True):
        s = int(s)
        if isinstance(d, int):
            if d != s:
                return f"{expr} vs actual {tuple(shape)}: literal {d} != {s}"
        elif d in env:
            if env[d] != s:
                return (
                    f"{expr} vs actual {tuple(shape)}: {d}={env[d]} "
                    f"bound earlier, got {s}"
                )
        else:
            env[d] = s
    return None


def _check_invariant_names(decl: ContractDecl) -> list:
    bad = [
        n for n in decl.spec.get("invariants", ()) if n not in KNOWN_INVARIANTS
    ]
    if bad:
        return [
            Finding(
                "contracts",
                "CONTRACT-DECL",
                f"target:{decl.target}",
                f"declares unknown invariants {bad} — add the check to "
                "contracts.KNOWN_INVARIANTS (and a harness) or fix the "
                "declaration",
            )
        ]
    return []


# --------------------------------------------------------------------------
# Harnesses
# --------------------------------------------------------------------------


def _shape_finding(target: str, lane: str, err: str) -> Finding:
    return Finding(
        "contracts", "CONTRACT-SHAPE", f"target:{target}", f"[{lane}] {err}"
    )


def _trace_finding(target: str, lane: str, err: str) -> Finding:
    return Finding("contracts", "CONTRACT-TRACE", f"target:{target}", f"[{lane}] {err}")


def _fake_mode():
    """Fake CPU tensors; real constants (a halo program's index tables)
    may mix in."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _fake_cache(lead: tuple, m: int, d: int = 2):
    """A ``PosteriorCache`` of empty float32 leaves with leading axes
    ``lead`` — fake tensors when made inside :func:`_fake_mode`."""
    import torch

    from repro_torch.core import posterior
    from repro_torch.gp.covariances import CovarianceParams

    def f32(*shape):
        return torch.empty(lead + shape, dtype=torch.float32)

    return posterior.PosteriorCache(
        z=f32(m, d), w=f32(m, m), u=f32(m, m), c=f32(m),
        cov=CovarianceParams(log_lengthscale=f32(d), log_variance=f32()),
        log_beta=f32(),
    )


def _check_outputs(decl: ContractDecl, lane: str, outs, env: dict) -> list:
    import torch

    findings = []
    for expr, leaf in zip(decl.spec.get("returns", ()), outs, strict=True):
        err = unify(expr, tuple(leaf.shape), env)
        if err:
            findings.append(_shape_finding(decl.target, lane, err))
        if "outputs-f32" in decl.spec.get("invariants", ()) and leaf.dtype != torch.float32:
            findings.append(
                Finding(
                    "contracts",
                    "CONTRACT-DTYPE",
                    f"target:{decl.target}",
                    f"[{lane}] output dtype {leaf.dtype}, policy is f32",
                )
            )
    return findings


def harness_predict_cached_slots(decl: ContractDecl, *, m: int = 8) -> list:
    """The slot-stacked predict on every kernel lane, on fake tensors."""
    import torch

    from repro_torch.core import posterior
    from repro_torch.gp.covariances import rbf

    findings = _check_invariant_names(decl)
    S, Q, D = 9, 16, 2
    for backend in BACKENDS:
        try:
            with _fake_mode():
                cache = _fake_cache((), m, D)
                xslots = torch.empty((S, Q, D), dtype=torch.float32)
                out = posterior.predict_cached_slots(cache, rbf, xslots, backend=backend)
        except Exception as e:  # a lane that no longer traces is a finding
            findings.append(_trace_finding(decl.target, backend, f"fake trace failed: {e}"))
            continue
        env = {"S": S, "Q": Q, "D": D}
        err = unify(decl.spec.get("args", {}).get("xslots", "(S, Q, D)"), (S, Q, D), env)
        if err:
            findings.append(_shape_finding(decl.target, backend, err))
        findings.extend(_check_outputs(decl, backend, out, env))
    return findings


def harness_scatter_results(decl: ContractDecl) -> list:
    """The exact inverse property, on real tiny host arrays — no torch.

    Build a routing table for a small scattered batch, gather each query's
    padded-block coordinate via ``table.src_idx`` semantics (values[p, i]
    = original request index), scatter back, and require identity.
    """
    from repro_torch.core import partition, routing

    findings = _check_invariant_names(decl)
    rng = np.random.default_rng(0)
    pts_all = rng.uniform(0.0, 1.0, (137, 2)).astype(np.float32)
    grid = partition.make_grid(pts_all, gx=3, gy=3)
    for n, pad in ((137, 8), (41, 4), (9, 1)):
        pts = pts_all[:n]
        table = routing.build_routing_table(grid, pts, pad_multiple=pad)
        env = {"P": grid.num_partitions, "Q": table.q_max, "N": n}
        # values[p, i] = the request index routed there (padding rows -1)
        values = np.where(
            table.qmask > 0, table.src_idx.astype(np.float32), -1.0
        ).astype(np.float32)
        expr = decl.spec.get("args", {}).get("values")
        if expr:
            err = unify(expr, values.shape, env)
            if err:
                findings.append(_shape_finding(decl.target, f"n={n}", err))
        out = routing.scatter_results(table, values)
        err = unify(decl.spec.get("returns", "(N,)"), out.shape, env)
        if err:
            findings.append(_shape_finding(decl.target, f"n={n}", err))
            continue
        if "scatter-is-gather-inverse" in decl.spec.get("invariants", ()):
            if not np.array_equal(out, np.arange(n, dtype=np.float32)):
                findings.append(
                    Finding(
                        "contracts",
                        "CONTRACT-INVERSE",
                        f"target:{decl.target}",
                        f"[n={n} pad={pad}] scatter(gather(x)) != x — "
                        "src_idx no longer inverts the routing permutation",
                    )
                )
    return findings


class StubHaloMesh:
    """A ``HaloMesh``'s shape, rank and cell without a process group: its
    ``shift`` returns zeros of the shape it is given, so a mesh program
    can be built and traced for shapes alone."""

    axis_names = ("data", "model")

    def __init__(self, gx: int, gy: int, rank: int = 0):
        self.gx, self.gy, self.size, self.rank = gx, gy, gx * gy, rank
        self.shape = {"data": gy, "model": gx}
        self.cell = (rank % gx, rank // gx)

    def shift(self, a, dx: int, dy: int):
        import torch

        return torch.zeros_like(a)


def harness_make_sharded_blend(
    decl: ContractDecl, *, grid_side: int = 4, m: int = 8
) -> list:
    """Build the mesh program on a stub mesh for one interior rank and run
    both halves on fake tensors, per backend: hx (1, 9, Q, 2) through
    ``evaluate``, its evaluations and the corner tables through
    ``resolve``. P is 1: a rank's program holds its own cell."""
    import torch

    from repro_torch.analysis import hlo
    from repro_torch.gp.covariances import rbf
    from repro_torch.launch import serve_sharded as ss

    findings = _check_invariant_names(decl)
    grid = hlo.probe_grid(grid_side)
    mesh = StubHaloMesh(grid.gx, grid.gy, rank=grid.num_partitions // 2)
    P, Q = 1, 64
    shapes = {"hx": (P, 9, Q, 2), "corner_slot": (P, Q, 4), "corner_w": (P, Q, 4)}
    for backend in BACKENDS:
        try:
            program = ss.make_sharded_blend(mesh, mesh.axis_names, grid, rbf, backend=backend)
            with _fake_mode():
                cache = _fake_cache((P,), m)
                hx = torch.empty(shapes["hx"], dtype=torch.float32)
                cs = torch.empty(shapes["corner_slot"], dtype=torch.int64)
                cw = torch.empty(shapes["corner_w"], dtype=torch.float32)
                out = program.resolve(program.evaluate(cache, hx), cs, cw)
        except Exception as e:
            findings.append(_trace_finding(decl.target, backend, f"fake trace failed: {e}"))
            continue
        env = {"P": P, "Q": Q}
        for name, expr in decl.spec.get("args", {}).items():
            err = unify(expr, shapes[name], env)
            if err:
                findings.append(_shape_finding(decl.target, backend, err))
        findings.extend(_check_outputs(decl, backend, out, env))
    return findings


def harness_make_request_stages(
    decl: ContractDecl, *, grid_side: int = 4, m: int = 8
) -> list:
    """Route on real host data per policy kind; run the one-process halo
    program on fake tensors of the EXACT shapes route produced. This is the
    seam a ``pad_multiple`` bug once lived in (the JAX package's): the policy's
    q_max counters and the table's block shape must be the same number.
    The halo program is built for real (its index tables are real CPU
    tensors made from numpy, which fake mode cannot do)."""
    import torch

    from repro_torch.analysis import hlo
    from repro_torch.core import routing
    from repro_torch.gp.covariances import rbf
    from repro_torch.launch import serve_sharded as ss

    findings = _check_invariant_names(decl)
    grid = hlo.probe_grid(grid_side)
    P = grid.num_partitions
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    base = rng.uniform(0.0, 1.0, (500, 2)).astype(np.float32)
    # a hot cell for the two-level lane: q_max must dip under the peak
    hot = np.concatenate(
        [base, rng.uniform(0.30, 0.42, (900, 2)).astype(np.float32)]
    )
    # a fixed q_max sized to the grid: peak owning-cell bucket, rounded up
    ix, iy = routing.owning_cells(grid, base)
    peak = int(np.bincount(iy * grid.gx + ix, minlength=P).max())
    fixed = routing.ceil_to(peak, 8)
    lanes = (
        ("streaming", dict(policy=routing.StreamingQMax()), base),
        ("streaming/pad5", dict(policy=routing.StreamingQMax(pad_multiple=5)), base),
        ("two-level", dict(policy=routing.TwoLevelQMax()), hot),
        ("fixed-q_max", dict(q_max=fixed), base),
    )
    invs = decl.spec.get("invariants", ())
    blend_fns = {b: ss.make_halo_blend(grid, rbf, b, cpu) for b in BACKENDS}
    for lane, kw, q in lanes:
        route, _submit, _collect = ss.make_request_stages(
            grid, blend_fns["ref"], None, device=cpu, **kw
        )
        table, (hx, cs, cw) = route(q)
        env = {"P": P, "Q": table.q_max, "D": 2, "N": len(q)}
        spec = decl.spec.get("route", {})
        for expr, shape in (
            (spec.get("xq"), table.xq.shape),
            (spec.get("stacked"), hx.shape),
            (spec.get("corner_slot"), cs.shape),
            (spec.get("corner_w"), cw.shape),
        ):
            if expr:
                err = unify(expr, shape, env)
                if err:
                    findings.append(_shape_finding(decl.target, lane, err))
        policy = kw.get("policy")
        if "q_max-matches-policy" in invs and policy is not None:
            if table.q_max != policy.q_max:
                findings.append(
                    Finding(
                        "contracts",
                        "CONTRACT-DESYNC",
                        f"target:{decl.target}",
                        f"[{lane}] table.q_max={table.q_max} != "
                        f"policy.q_max={policy.q_max} — the table re-rounded "
                        "the policy's block size, so the policy's "
                        "growth/overflow counters describe shapes that are "
                        "never served (the pad_multiple bug class)",
                    )
                )
        if "q_max-aligned" in invs:
            pad = policy.pad_multiple if policy is not None else 8
            if kw.get("q_max") is None and table.q_max % pad != 0:
                findings.append(
                    Finding(
                        "contracts",
                        "CONTRACT-DESYNC",
                        f"target:{decl.target}",
                        f"[{lane}] table.q_max={table.q_max} not aligned to "
                        f"pad_multiple={pad}",
                    )
                )
        # the seam: the halo program must accept route's exact blocks
        for backend, blend_fn in blend_fns.items():
            try:
                with _fake_mode():
                    cache = _fake_cache((P,), m)
                    out = blend_fn(
                        cache,
                        torch.empty(hx.shape, dtype=torch.float32),
                        torch.empty(cs.shape, dtype=torch.int64),
                        torch.empty(cw.shape, dtype=torch.float32),
                    )
            except Exception as e:
                findings.append(_trace_finding(
                    decl.target, f"{lane}/{backend}", f"halo program rejects route's blocks: {e}"))
                continue
            for leaf in out:
                if tuple(leaf.shape) != (P, table.q_max):
                    findings.append(
                        _shape_finding(
                            decl.target,
                            f"{lane}/{backend}",
                            f"blend output {tuple(leaf.shape)} != "
                            f"(P={P}, q_max={table.q_max})",
                        )
                    )
    return findings


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

# target -> (harness, builds a mesh program)
_HARNESSES = {
    "repro_torch.core.posterior.predict_cached_slots": (
        harness_predict_cached_slots,
        False,
    ),
    "repro_torch.core.routing.scatter_results": (harness_scatter_results, False),
    "repro_torch.launch.serve_sharded.make_sharded_blend": (
        harness_make_sharded_blend,
        True,
    ),
    "repro_torch.launch.serve_sharded.make_request_stages": (
        harness_make_request_stages,
        True,
    ),
}


def run(
    *,
    targets: tuple = None,
    include_mesh: bool = True,
    grid_side: int = 4,
    m: int = 8,
) -> tuple:
    """Check every expected contract; returns (findings, report).

    ``targets`` restricts to a subset; ``include_mesh=False`` skips the
    harnesses of the halo programs. No process group and no device is
    needed: the mesh program is built on a stub mesh, and the device
    stages run on fake CPU tensors whatever device serves.
    """
    findings: list = []
    t0 = time.time()
    for target in EXPECTED_TARGETS:
        importlib.import_module(target.rsplit(".", 1)[0])
    checked = []
    skipped = []
    for target in EXPECTED_TARGETS:
        if targets is not None and target not in targets:
            continue
        harness, needs_mesh = _HARNESSES[target]
        if needs_mesh and not include_mesh:
            skipped.append(target)
            continue
        decl = _REGISTRY.get(target)
        if decl is None:
            findings.append(
                Finding(
                    "contracts",
                    "CONTRACT-MISSING",
                    f"target:{target}",
                    "expected @contract declaration is gone — restore it or "
                    "update contracts.EXPECTED_TARGETS",
                )
            )
            continue
        checked.append(target)
        if needs_mesh:
            findings.extend(harness(decl, grid_side=grid_side, m=m))
        else:
            findings.extend(harness(decl))
    report = {
        "targets_checked": checked,
        "targets_skipped": skipped,
        "device": "cpu (fake tensors)",
        "seconds": round(time.time() - t0, 3),
    }
    return findings, report
