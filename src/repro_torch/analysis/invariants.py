"""The declarative per-lane invariant manifest the ``hlo`` pass enforces.

The port's counterpart of ``repro.analysis.invariants``. Every serving
lane ``api.Server`` accepts carries a :class:`LaneInvariant`: which
program it runs, how many collectives, kernel dispatches and host copies
a request of that program may make, which collectives are forbidden
outright, and the dtype policy. The port has no program text: the ``hlo``
pass records each program's trace on a probe request (every aten op with
its output dtypes and devices, every kernel dispatch, every collective a
rank makes, every host copy) and holds it to this manifest. The claims:

  * the one-process program (every cell on one device) makes ZERO
    collectives — its reverse halo is an index gather on the device
    (``serve_sharded.make_halo_blend``). Its floor sits on what must be
    present instead: exactly one kernel dispatch a request on the
    ``pallas``/``fused`` lanes, and the reverse-halo gather (one index op
    for the mean and one for the variance) on every lane;
  * the mesh lane (``Server(group=...)``, one cell per rank) is
    HALO-SHAPED — exactly 4 shifts a request and rank (the JAX program's
    composed reverse halo; floor 4, budget 8) and exactly one all-gather,
    of the rank's result rows (2 x q_max float32). No all-reduce,
    reduce-scatter or all-to-all, and no collective whose payload is a
    cache leaf: the factors never move;
  * the replicated lane is mesh-free — ZERO collectives of any kind;
  * serving math is float32 — no f64 anywhere, with one declared
    exemption per ``ref`` lane: the plain lane sums every row in float64
    at the op sites :data:`F64_SITES` (so that the CPU lane is bitwise
    across q_max). No f64 may reach a lane's outputs, collective payloads
    or host copies, and the kernel lanes get no exemption;
  * host copies (device to host) are declared per lane and stage: the
    copy back in ``collect``, and on the mesh lane the copy of the
    evaluations to pinned memory in ``submit``. An ``.item()`` inside the
    request is never allowed.

Lanes that share a program (pipeline and router only change HOST-side
scheduling) point at the same ``program_key``; the pass drives each
distinct program once and applies every lane's invariant to its trace.

Stdlib-only: the manifest must be importable (and testable) without torch.
"""
from __future__ import annotations

import dataclasses

# Collective mnemonics, JAX's (StableHLO/HLO) names. The recorder names
# every collective a rank makes by these: a ``batch_isend_irecv`` (one
# shift of the halo) and a lone send/recv are "collective-permute".
COLLECTIVE_OPS = (
    "collective-permute",
    "all-gather",
    "all-reduce",
    "all-to-all",
    "reduce-scatter",
)

# Host-transfer kinds the recorder emits: a device-to-host copy, and a
# scalar read (``aten._local_scalar_dense``, i.e. ``.item()``), which
# blocks the host on the device wherever it runs.
HOST_TRANSFER_OPS = ("host-copy", "scalar-read")

# The factors-never-move claim: nothing may re-aggregate sharded state.
GATHERING_COLLECTIVES = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter")

# Composed reverse halo = 4 shifts; budget 8 leaves room for one more
# composed exchange, as in the JAX manifest.
PPERMUTE_BUDGET = 8

PROGRAMS = ("replicated-blend", "sharded-blend", "mesh-blend")

# Structural counts a lane may declare exactly, per request (and rank):
# collective-permute / all-gather (the mesh's shifts and its one gather of
# results), kernel (kernel dispatches), index-gather (``aten.index.Tensor``:
# the one-process program's reverse halo, one for the mean and one for the
# variance).
STRUCTURAL = ("collective-permute", "all-gather", "kernel", "index-gather")

# Request stages the recorder marks; host copies are declared per stage.
STAGES = ("route", "submit", "collect")

# The float64 op sites of the plain lane, "path:function" under src/. The
# plain lane sums every row over the inducing index in one fixed order in
# float64 and rounds once (``kernels/ref.py:row_products``/``row_sumsq``,
# and ``core/posterior.py:predict_cached``'s k** - q + s), so its answer
# does not depend on the batch around a row.
F64_SITES = (
    "repro_torch/kernels/ref.py:row_products",
    "repro_torch/kernels/ref.py:row_sumsq",
    "repro_torch/core/posterior.py:predict_cached",
)
F64_REASON = (
    "the plain lane sums every row in float64 in one fixed order and rounds "
    "once (so the CPU lane is bitwise across q_max); on the card it runs f64 "
    "arithmetic on the device"
)


@dataclasses.dataclass(frozen=True)
class LaneInvariant:
    """What one serving lane's program may do per request (and rank).

    Fields (JAX's, then the port's):
      name: stable lane id, e.g. "sharded/pipelined/two-level/fused".
      serve: the ServeConfig dict of the lane (validated against
        ``repro_torch.api.ServeConfig.from_dict`` by the pass, so manifest
        rot fails it).
      program: "replicated-blend" | "sharded-blend" (the one-process halo
        program) | "mesh-blend" (one cell per rank).
      backend: kernel lane ("ref"|"pallas"|"fused"); the replicated program
        has only "ref".
      max_collective_permute / min_collective_permute: shift budget and
        floor.
      forbidden_ops: collective mnemonics that must not appear at all.
      forbid_f64: the dtype policy (f64 only at ``f64_sites``).
      forbid_host_transfer: host transfers only as ``host_copies`` declares.
      exact: structural counts (keys of :data:`STRUCTURAL`) a request must
        show exactly: more is HLO-COLLECTIVE-BUDGET, fewer
        HLO-COLLECTIVE-MISSING.
      host_copies: one stage name (:data:`STAGES`) per device-to-host copy
        a request may make there.
      f64_sites: op sites ("path:function") where f64 is declared, with
        ``f64_reason``; ref lanes only.

    No lane's collective may carry a cache leaf.
    """

    name: str
    serve: dict
    program: str
    backend: str
    max_collective_permute: int
    forbidden_ops: tuple
    min_collective_permute: int = 0
    forbid_f64: bool = True
    forbid_host_transfer: bool = True
    exact: dict = dataclasses.field(default_factory=dict)
    host_copies: tuple = ()
    f64_sites: tuple = ()
    f64_reason: str = ""

    def __post_init__(self) -> None:
        if self.program not in PROGRAMS:
            raise ValueError(f"unknown program {self.program!r} for lane {self.name!r}")
        if self.backend not in ("ref", "pallas", "fused"):
            raise ValueError(f"unknown backend {self.backend!r} for lane {self.name!r}")
        if self.program == "replicated-blend" and self.backend != "ref":
            raise ValueError(f"replicated lanes have no kernel lane (lane {self.name!r})")
        if self.max_collective_permute < 0:
            raise ValueError(f"negative ppermute budget for lane {self.name!r}")
        if not 0 <= self.min_collective_permute <= self.max_collective_permute:
            raise ValueError(f"bad ppermute floor for lane {self.name!r}")
        unknown = set(self.forbidden_ops) - set(COLLECTIVE_OPS)
        if unknown:
            raise ValueError(f"unknown forbidden ops {sorted(unknown)} for lane {self.name!r}")
        bad = {k: v for k, v in self.exact.items()
               if k not in STRUCTURAL or not isinstance(v, int) or v < 0}
        if bad:
            raise ValueError(f"bad exact counts {bad} for lane {self.name!r}")
        if set(self.exact) & set(self.forbidden_ops):
            raise ValueError(f"lane {self.name!r} both forbids and requires "
                             f"{sorted(set(self.exact) & set(self.forbidden_ops))}")
        if not set(self.host_copies) <= set(STAGES):
            raise ValueError(f"unknown host-copy stages {self.host_copies} for lane {self.name!r}")
        if self.f64_sites:
            # the exemption must not spread: only the plain lane sums in f64
            if self.backend != "ref":
                raise ValueError(f"f64 sites on the {self.backend!r} kernel lane {self.name!r}")
            if not self.f64_reason:
                raise ValueError(f"f64 sites without a reason on lane {self.name!r}")
            malformed = [s for s in self.f64_sites if s.count(":") != 1 or s.endswith(":")]
            if malformed:
                raise ValueError(f"f64 sites must be 'path:function', got {malformed}")

    @property
    def program_key(self) -> tuple:
        """(program, backend): lanes sharing it share one recorded trace."""
        return (self.program, self.backend)


def _ref_f64(backend: str) -> dict:
    return {"f64_sites": F64_SITES, "f64_reason": F64_REASON} if backend == "ref" else {}


def _halo_lanes(program: str, prefix: str) -> list:
    lanes = []
    for pipeline in ("serial", "pipelined"):
        for router in ("single", "two-level"):
            for backend in ("ref", "pallas", "fused"):
                lanes.append(_halo_lane(
                    f"{prefix}/{pipeline}/{router}/{backend}", program, backend,
                    {"mode": "sharded", "pipeline": pipeline, "router": router,
                     "backend": backend},
                ))
    return lanes


def _halo_lane(name: str, program: str, backend: str, serve: dict) -> LaneInvariant:
    kernel = int(backend != "ref")
    if program == "sharded-blend":
        # one device holds every cell: no collectives at all; the floor is
        # the kernel dispatch and the reverse-halo gather
        return LaneInvariant(
            name=name, serve=serve, program=program, backend=backend,
            max_collective_permute=0, forbidden_ops=COLLECTIVE_OPS,
            exact={"kernel": kernel, "index-gather": 2},
            host_copies=("collect", "collect"), **_ref_f64(backend),
        )
    return LaneInvariant(
        name=name, serve=serve, program=program, backend=backend,
        max_collective_permute=PPERMUTE_BUDGET, min_collective_permute=4,
        forbidden_ops=("all-reduce", "all-to-all", "reduce-scatter"),
        exact={"collective-permute": 4, "all-gather": 1, "kernel": kernel},
        host_copies=("submit", "collect"), **_ref_f64(backend),
    )


LANES: tuple = (
    (
        LaneInvariant(
            name="replicated/serial/single/ref",
            serve={"mode": "replicated", "backend": "ref"},
            program="replicated-blend",
            backend="ref",
            max_collective_permute=0,
            forbidden_ops=COLLECTIVE_OPS,
            exact={"kernel": 0},
            host_copies=("collect", "collect"),
            **_ref_f64("ref"),
        ),
    )
    + tuple(_halo_lanes("sharded-blend", "sharded"))
    # the fixed-q_max whole-stream-prepass lane (sharded single-router)
    + (_halo_lane("sharded/serial/single/ref/fixed-q_max", "sharded-blend", "ref",
                  {"mode": "sharded", "backend": "ref", "q_max": 64}),)
    + tuple(_halo_lanes("mesh-blend", "mesh"))
)


# --------------------------------------------------------------------------
# Cost budgets (the ``costs`` pass)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostBudget:
    """The cost envelope of one program, measured from its recorded trace.

    The costs pass drives each ``ref`` program at several scale points,
    derives five metrics from the recorded ops' shapes (``costs.METRICS``),
    fits log-log scaling exponents, and enforces:

      * COST-FLOP-SUPERLINEAR — flops (near-)linear in ``scale_axis``;
      * COST-MEM-SCALING — on the mesh, per-rank argument bytes and flops
        FLAT as the mesh grows (``max_device_exponent``, the 1/P residency
        claim). The one-process program holds every cell on one device,
        so its bytes grow with P by design and it declares no device
        exponent;
      * COST-BUDGET — absolute ceilings at the ``anchor`` scale point
        (~2.5-3x headroom over the measured program).

    Stdlib-only, like the lane manifest above.
    """

    program: str
    scale_axis: str  # axis the flop exponent is fitted against
    anchor: str  # point label the absolute ceilings apply at
    max_flop_exponent: float
    max_flops: float
    max_bytes_accessed: float
    max_arg_bytes: int
    max_temp_bytes: int
    max_device_exponent: float | None = None  # the mesh only: vs ranks

    def __post_init__(self) -> None:
        if self.program not in PROGRAMS:
            raise ValueError(f"unknown program {self.program!r} in cost budget")
        if not 1.0 <= self.max_flop_exponent < 2.0:
            # linear is the claim; an allowance at or past quadratic
            # would make the rule vacuous
            raise ValueError(f"flop exponent budget must be in [1, 2) for {self.program!r}")
        if self.max_device_exponent is not None and not 0.0 <= self.max_device_exponent < 1.0:
            raise ValueError(f"device exponent budget must be in [0, 1) for {self.program!r}")
        for field in ("max_flops", "max_bytes_accessed", "max_arg_bytes", "max_temp_bytes"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be positive for {self.program!r}")


COST_BUDGETS: dict = {
    # blend.predict_blended over the whole cache, one device; scale points
    # sweep n_queries (grid 4, m 8). Measured at n=256 (the committed
    # analysis_costs.json): 0.28 Mflop, 7.9 MB accessed, 12.0 KB args,
    # 0.34 MB peak live outputs.
    "replicated-blend": CostBudget(
        program="replicated-blend",
        scale_axis="n_queries",
        anchor="n=256",
        max_flop_exponent=1.3,
        max_flops=8.0e5,
        max_bytes_accessed=2.4e7,
        max_arg_bytes=36864,
        max_temp_bytes=1048576,
    ),
    # the one-process halo program: every cell on one device, so its bytes
    # and flops grow with P by design (no device exponent); scale points
    # sweep the grid side and q_max. Measured at (grid=4, q=64): 2.3 Mflop,
    # 36.8 MB accessed, 0.13 MB args, 1.6 MB peak live outputs.
    "sharded-blend": CostBudget(
        program="sharded-blend",
        scale_axis="q_max",
        anchor="grid=4/q=64",
        max_flop_exponent=1.3,
        max_flops=6.9e6,
        max_bytes_accessed=1.1e8,
        max_arg_bytes=393216,
        max_temp_bytes=4718592,
    ),
    # the mesh lane, one cell per rank: per-rank costs FLAT in P (the 1/P
    # residency claim). Measured on a rank at (grid=4, q=64): 0.14 Mflop,
    # 2.4 MB accessed, 8.1 KB args, 97 KB peak live outputs.
    "mesh-blend": CostBudget(
        program="mesh-blend",
        scale_axis="q_max",
        anchor="grid=4/q=64",
        max_flop_exponent=1.3,
        max_flops=4.3e5,
        max_bytes_accessed=7.1e6,
        max_arg_bytes=24576,
        max_temp_bytes=294912,
        max_device_exponent=0.3,
    ),
}
