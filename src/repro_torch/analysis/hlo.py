"""Pass ``hlo`` — the per-lane invariant checker, on recorded traces.

The JAX package's pass of this name lowers every serving lane to StableHLO
and walks the text. The port runs eager PyTorch, with its collectives on
gloo from host code, so it has no program text; what it checks instead is
a **trace** of one probe request through the lane's real request stages
(``serve_sharded.make_request_stages`` / ``make_mesh_request_stages`` /
``make_replicated_stages``), recorded by :class:`Recorder`:

  * every aten op, by a ``torch.utils._python_dispatch.TorchDispatchMode``
    over the stages, with its stage, output dtypes and devices, and the
    source site ("path:function") that issued it;
  * every kernel dispatch: the calls into ``kernels/ops.py``'s dispatching
    entries, counted by ``kernels/launches.py``'s registry on the card (a
    ctypes launch is invisible to a dispatch mode) and by the calls on the
    CPU, where the entry runs the kernel's plain version. Either way the
    ops inside an entry are the kernel's and are not recorded one by one;
  * every collective the rank makes: ``torch.distributed``'s functions
    are wrapped for the pass's duration (a ``batch_isend_irecv`` is one
    shift, "collective-permute"), and a c10d op that reaches the dispatch
    mode outside them (a direct ``dist.isend``) is recorded as well, with
    its payload's dtype and shape and whether it carries a cache leaf;
  * host transfers: an op that makes a CPU tensor from a CUDA one
    ("host-copy", by stage) and ``aten._local_scalar_dense`` ("scalar-read",
    an ``.item()``). On the CPU only the second can show; the card's run
    sees the first.

:func:`check_text` applies one lane's invariant (``invariants.LANES``) to
a trace text, with JAX's rule ids: HLO-COLLECTIVE-BUDGET and
HLO-COLLECTIVE-MISSING (shifts over the budget / under the floor, and any
declared structural count — shifts, all-gathers, kernel dispatches, the
reverse-halo gather — above / below its declaration), HLO-FORBIDDEN-OP (a
forbidden or unknown collective, or a collective carrying a cache leaf),
HLO-DTYPE-F64 (f64 outside the lane's declared op sites, or in an input,
output, payload or host copy), HLO-HOST-TRANSFER and HLO-MANIFEST.

Each distinct program (``LaneInvariant.program_key``) is driven once on a
small probe with JAX's sizes (grid 4, m 8, q_max 64; the replicated
program on 256 queries): one unrecorded warm-up request, then one
recorded request. The mesh lane's probe runs on every rank of a spawned
gloo group (``meshprobe``), and each rank's trace is checked.
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import Finding
from repro_torch.analysis import invariants as inv

DEFAULT_GRID_SIDE = 4
DEFAULT_M = 8
DEFAULT_Q_MAX = 64
DEFAULT_N_QUERIES = 256

# c10d ops as the dispatch mode sees them -> JAX's collective mnemonics
_C10D_KINDS = {
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
# torch.distributed functions the recorder wraps -> mnemonic
_DIST_KINDS = {
    "batch_isend_irecv": "collective-permute",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
# the dispatching kernel entries of kernels/ops.py
KERNEL_ENTRIES = ("posterior_predict", "posterior_predict_slots",
                  "posterior_predict_slots_stacked", "rbf_cross_cov", "svgp_projection")
# ops that move no bytes: allocations without a value
_EMPTY_OPS = ("empty", "empty_like", "empty_strided")
_COPY_OPS = ("_to_copy", "copy_", "_copy_from", "_copy_from_and_resize")
_REDUCTIONS_BY_NAME = ("sum", "mean", "amax", "amin", "prod", "max", "min", "norm")
_ANALYSIS_DIR = os.sep + os.path.join("repro_torch", "analysis") + os.sep
# what a trace counts besides collectives
TALLIES = ("kernel", "index-gather", *inv.HOST_TRANSFER_OPS)


# --------------------------------------------------------------------------
# The recorder
# --------------------------------------------------------------------------


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _desc(t) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(str(s) for s in t.shape)}]"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def op_site() -> str:
    """The innermost frame outside torch and this package that issued the
    current op: "repro_torch/<path>:<function>" for the port's code, else
    "<file>:<function>"."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if (os.sep + "torch" + os.sep not in fn and _ANALYSIS_DIR not in fn
                and "contextlib" not in fn and not fn.startswith("<")):
            norm = fn.replace(os.sep, "/")
            i = norm.rfind("/repro_torch/")
            where = norm[i + 1:] if i >= 0 else os.path.basename(norm)
            return f"{where}:{f.f_code.co_name}"
        f = f.f_back
    return "?:?"


class Recorder:
    """One request's trace and shape-derived costs. Use :func:`recording`.

    ``lines`` is the trace (one line per op, kernel dispatch, collective,
    host transfer, input and output); ``stage`` is set by the caller
    between the request's stages. Cost tallies (submit and collect stages,
    the device work of a request): ``flops`` (product ops by the formulas
    of ``torch.utils.flop_counter.FlopCounterMode``, one per output
    element for pointwise ops, one per input element for reductions),
    ``bytes_accessed`` (every op's input and output bytes; views,
    allocations and cross-device copies excluded) and ``peak_bytes`` (the
    peak of the live op outputs, freed as Python frees them).
    """

    def __init__(self, cache_leaves=()):
        self.lines: list = []
        self.stage = "route"
        self.suppress = 0
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.cache_leaves = list(cache_leaves)

    # -- lines ---------------------------------------------------------------

    def emit(self, kind: str, name: str, **fields) -> None:
        rest = " ".join(f"{k.replace('_', '-')}={v}" for k, v in fields.items())
        self.lines.append(f"{kind} {name} {rest}".rstrip())

    def text(self, header: str = "") -> str:
        return "\n".join(([header] if header else []) + self.lines) + "\n"

    # -- costs ---------------------------------------------------------------

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _cost(self, func, args, kwargs, out, ins: list, outs: list) -> None:
        from torch.utils.flop_counter import flop_registry

        name = func.overloadpacket.__name__
        if func.is_view or name in _EMPTY_OPS:
            return
        if name in _COPY_OPS and {t.device.type for t in ins} != {t.device.type for t in outs}:
            return  # a copy between devices: a transfer, not device work
        packet = func.overloadpacket
        tags = {str(t) for t in func.tags}  # by name: torch versions differ in their tags
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif "Tag.pointwise" in tags:
            self.flops += sum(t.numel() for t in outs)
        elif "Tag.reduction" in tags or name in _REDUCTIONS_BY_NAME:
            self.flops += sum(t.numel() for t in ins)
        self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if not name.endswith("_") and "out" not in kwargs:  # in place: no new output
            for t in outs:
                n = _nbytes(t)
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- what the dispatch mode sees ----------------------------------------

    def on_op(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "c10d":
            kind = _C10D_KINDS.get(name, f"c10d.{name}")
            self.collective(kind, _tensors((args, kwargs)), via=f"c10d.{name}")
            return
        full = str(func)
        site = op_site()
        if name == "_local_scalar_dense":
            self.emit("scalar-read", full, stage=self.stage, site=site)
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name == "copy_" and ins:  # an in-place copy writes its first argument
            outs = [ins[0]]
            ins = ins[1:]
        dtypes = ",".join(sorted({str(t.dtype).removeprefix("torch.") for t in outs})) or "-"
        devs = ",".join(sorted({t.device.type for t in outs})) or "-"
        self.emit("op", full, stage=self.stage, out=dtypes, dev=devs, site=site)
        if any(t.device.type == "cuda" for t in ins) and any(t.device.type == "cpu" for t in outs):
            self.emit("host-copy", full, stage=self.stage, out=dtypes, site=site)
        if self.stage in ("submit", "collect"):  # the request's device work
            self._cost(func, args, kwargs, out, ins, outs)

    def collective(self, kind: str, payload: list, *, via: str) -> None:
        self.suppress += 1  # the comparisons below are not the lane's ops
        try:
            leaf = any(
                t is c or (t.shape == c.shape and t.dtype == c.dtype and torch.equal(
                    t.detach().cpu(), c.detach().cpu()))
                for t in payload for c in self.cache_leaves
            )
        finally:
            self.suppress -= 1
        shapes = ",".join(dict.fromkeys(_desc(t) for t in payload)) or "-"
        devs = ",".join(sorted({t.device.type for t in payload})) or "-"
        self.emit("collective", kind, stage=self.stage, payload=shapes, dev=devs,
                  cache_leaf="yes" if leaf else "no", via=via, site=op_site())

    def kernel(self, name: str, n: int, outs: list) -> None:
        dtypes = ",".join(str(t.dtype).removeprefix("torch.") for t in outs) or "-"
        devs = ",".join(sorted({t.device.type for t in outs})) or "-"
        self.emit("kernel", name, n=n, stage=self.stage, out=dtypes, dev=devs, site=op_site())

    def io(self, kind: str, arrays) -> None:
        """Record the request's inputs (the routed blocks) or the device
        program's outputs: dtype and shape of each."""
        for i, a in enumerate(arrays):
            dt = str(a.dtype).removeprefix("torch.")
            dev = "host" if isinstance(a, np.ndarray) else a.device.type
            self.emit(kind, str(i), dtype=f"{dt}[{','.join(str(s) for s in a.shape)}]", dev=dev)


_ACTIVE: list = []  # the recorder of the request being recorded (a stack)


class _Mode(TorchDispatchMode):
    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.rec.suppress:
            self.rec.on_op(func, args, kwargs, out)
        return out


def _wrap_kernel(name: str, fn):
    def entry(*args, **kwargs):
        from repro_torch.kernels import launches

        rec = _ACTIVE[-1] if _ACTIVE else None
        if rec is None:
            return fn(*args, **kwargs)
        before = launches.total()
        rec.suppress += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            rec.suppress -= 1
        on_cuda = any(t.device.type == "cuda" for t in _tensors((args, kwargs)))
        n = launches.total() - before if on_cuda else 1
        rec.kernel(name, n, _tensors(out))
        return out

    return entry


def _wrap_dist(kind: str, fn):
    def collective(*args, **kwargs):
        rec = _ACTIVE[-1] if _ACTIVE else None
        if rec is None or rec.suppress:
            return fn(*args, **kwargs)
        if kind == "collective-permute":
            payload = [op.tensor for p2p in args[:1] for op in p2p]
        else:
            payload = _tensors((args, kwargs))
        rec.collective(kind, payload, via=f"dist.{fn.__name__}")
        rec.suppress += 1
        try:
            return fn(*args, **kwargs)
        finally:
            rec.suppress -= 1

    return collective


@contextlib.contextmanager
def recording(cache_leaves=()):
    """Record the ops, kernel dispatches and collectives of the code run
    inside: wraps ``kernels/ops.py``'s entries and ``torch.distributed``'s
    collectives for the duration, and enters the dispatch mode. Yields the
    :class:`Recorder`."""
    import torch.distributed as dist

    from repro_torch.kernels import ops as kops

    rec = Recorder(cache_leaves)
    saved = []
    for name in KERNEL_ENTRIES:
        saved.append((kops, name, getattr(kops, name)))
        setattr(kops, name, _wrap_kernel(name, getattr(kops, name)))
    for name, kind in _DIST_KINDS.items():
        if hasattr(dist, name):
            saved.append((dist, name, getattr(dist, name)))
            setattr(dist, name, _wrap_dist(kind, getattr(dist, name)))
    _ACTIVE.append(rec)
    try:
        with _Mode(rec):
            yield rec
    finally:
        _ACTIVE.pop()
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


# --------------------------------------------------------------------------
# Trace-text checks (pure functions of the text)
# --------------------------------------------------------------------------


def parse_line(line: str) -> tuple:
    """'kind name k=v ...' -> (kind, name, {k: v})."""
    parts = line.split()
    fields = dict(p.split("=", 1) for p in parts[2:] if "=" in p)
    return parts[0], (parts[1] if len(parts) > 1 else ""), fields


def count_structure(text: str) -> dict:
    """The tallies of a trace: collectives by mnemonic (JAX's five always
    present), kernel dispatches, index gathers (``aten.index.Tensor``: the
    one-process program's reverse halo), host copies and scalar reads, and
    the f64 ops by name."""
    counts = {op: 0 for op in inv.COLLECTIVE_OPS}
    counts.update(dict.fromkeys(TALLIES, 0))
    f64_ops: collections.Counter = collections.Counter()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        kind, name, f = parse_line(line)
        if kind == "collective":
            counts[name] = counts.get(name, 0) + 1
        elif kind == "kernel":
            counts["kernel"] += int(f.get("n", 1))
        elif kind == "op":
            if name == "aten.index.Tensor":
                counts["index-gather"] += 1
            if "float64" in f.get("out", ""):
                f64_ops[name] += 1
        elif kind in inv.HOST_TRANSFER_OPS:
            counts[kind] += 1
    counts["f64-ops"] = dict(sorted(f64_ops.items()))
    return counts


def _mesh_header(text: str) -> dict:
    for line in text.splitlines():
        if line.startswith("# halo-mesh "):
            return {k: int(v) for k, v in (p.split("=") for p in line.split()[2:])}
    return {}


def check_text(lane: "inv.LaneInvariant", text: str) -> tuple:
    """Apply one lane's invariant to a recorded trace text.

    Returns (findings, counts): ``counts`` (:func:`count_structure`) is the
    per-lane tally the report records, so a CI diff sees drift even while
    every budget still holds.
    """
    where = f"lane:{lane.name}"
    findings = []

    def finding(rule: str, msg: str) -> None:
        findings.append(Finding("hlo", rule, where, msg))

    counts = count_structure(text)
    ncp = counts["collective-permute"]
    if ncp > lane.max_collective_permute:
        finding("HLO-COLLECTIVE-BUDGET",
                f"{ncp} shifts (collective-permutes) a request exceed the lane budget of "
                f"{lane.max_collective_permute} (the composed reverse halo is 4 — a per-slot "
                "exchange crept back in?)")
    if ncp < lane.min_collective_permute:
        finding("HLO-COLLECTIVE-MISSING",
                f"only {ncp} shifts a request, expected >= {lane.min_collective_permute} — the "
                "halo exchange is gone (or the recorder stopped seeing it)")
    for key, want in lane.exact.items():
        got = counts.get(key, 0)
        if got > want:
            finding("HLO-COLLECTIVE-BUDGET",
                    f"{got} {key} a request, the lane declares exactly {want}")
        elif got < want:
            finding("HLO-COLLECTIVE-MISSING",
                    f"{got} {key} a request, the lane declares exactly {want} — it vanished "
                    "from the program (or the recorder stopped seeing it)")
    mesh = _mesh_header(text)
    for key, stat in (("collective-permute", "shifts"), ("all-gather", "gathers")):
        if stat in mesh and counts[key] < mesh[stat]:
            finding("HLO-COLLECTIVE-MISSING",
                    f"HaloMesh counted {mesh[stat]} {stat} but the recorder saw {counts[key]} "
                    f"{key} — the recorder's collective matching rotted")
    for op in sorted(set(counts) - set(inv.COLLECTIVE_OPS) - set(TALLIES) - {"f64-ops"}):
        finding("HLO-FORBIDDEN-OP", f"unknown collective {op!r} appears {counts[op]}x")
    for op in lane.forbidden_ops:
        if counts.get(op, 0):
            finding("HLO-FORBIDDEN-OP",
                    f"forbidden op {op!r} appears {counts[op]}x — halo serving must never "
                    "re-aggregate the cache factors"
                    if op in inv.GATHERING_COLLECTIVES
                    else f"forbidden op {op!r} appears {counts[op]}x")
    host_allowed = collections.Counter(lane.host_copies)
    host_seen: collections.Counter = collections.Counter()
    f64_sites = set(lane.f64_sites)
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        kind, name, f = parse_line(line)
        if kind == "collective" and f.get("cache-leaf") == "yes":
            finding("HLO-FORBIDDEN-OP",
                    f"{name} at {f.get('site')} carries a cache leaf ({f.get('payload')}) — "
                    "the factors never move")
        if lane.forbid_f64:
            shown = f.get("out", "") + f.get("payload", "") + f.get("dtype", "")
            exempt = kind == "op" and f.get("site") in f64_sites
            if "float64" in shown and not exempt:
                finding("HLO-DTYPE-F64",
                        f"f64 in {kind} {name} at {f.get('site', f.get('stage', '?'))} — the "
                        "serving dtype policy is float32 (f64 only at the lane's declared "
                        f"op sites {sorted(f64_sites) or '(none)'})")
        if kind == "host-copy":
            host_seen[f.get("stage")] += 1
        elif kind == "scalar-read" and lane.forbid_host_transfer:
            finding("HLO-HOST-TRANSFER",
                    f"{name} (.item()) in stage {f.get('stage')} at {f.get('site')} — a host "
                    "read blocks the request on the device")
    if lane.forbid_host_transfer:
        extra = host_seen - host_allowed
        if extra:
            finding("HLO-HOST-TRANSFER",
                    f"device-to-host copies beyond the lane's declared ones: "
                    f"{dict(sorted(extra.items()))} (declared {dict(sorted(host_allowed.items()))})")
    return findings, counts


# --------------------------------------------------------------------------
# Probe programs: real stages, small random caches
# --------------------------------------------------------------------------


def probe_grid(side: int = DEFAULT_GRID_SIDE):
    """A unit-square partition grid with ``side**2`` cells."""
    from repro_torch.core.partition import PartitionGrid

    edges = np.linspace(0.0, 1.0, side + 1)
    return PartitionGrid(gx=side, gy=side, x_edges=edges, y_edges=edges, wrap_x=False)


def probe_cache(num_partitions: int, m: int, device, *, d: int = 2, seed: int = 0):
    """A P-stacked ``PosteriorCache`` of random float32 leaves (the same on
    every rank for one seed): finite, well-scaled values; no training."""
    from repro_torch.core import posterior
    from repro_torch.gp.covariances import CovarianceParams

    rng = np.random.default_rng(seed)
    P = num_partitions

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    tri = np.tril(rng.normal(0.0, 0.3, (P, m, m)))
    return posterior.PosteriorCache(
        z=t(rng.uniform(0.0, 1.0, (P, m, d))),
        w=t(tri + np.eye(m)),
        u=t(np.tril(rng.normal(0.0, 0.1, (P, m, m)))),
        c=t(rng.normal(0.0, 1.0, (P, m))),
        cov=CovarianceParams(t(np.full((P, d), np.log(0.3))), t(np.zeros(P))),
        log_beta=t(np.full(P, 2.0)),
    )


def probe_queries(grid, n: int, *, seed: int = 0) -> np.ndarray:
    """``n`` points dealt round-robin over the cells, each uniform inside
    its cell: a cell holds ceil(n / P) points at most."""
    rng = np.random.default_rng(seed)
    P = grid.num_partitions
    cell = np.arange(n) % P
    ix, iy = cell % grid.gx, cell // grid.gx
    x0, x1 = grid.x_edges[ix], grid.x_edges[ix + 1]
    y0, y1 = grid.y_edges[iy], grid.y_edges[iy + 1]
    u = rng.uniform(0.05, 0.95, (n, 2))
    return np.stack([x0 + u[:, 0] * (x1 - x0), y0 + u[:, 1] * (y1 - y0)], 1).astype(np.float32)


def resident_bytes(tensors) -> int:
    """Bytes of the distinct storages ``tensors`` keep alive: a view of a
    larger tensor counts that tensor whole."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[(t.device.type, s.data_ptr())] = s.nbytes()
    return sum(seen.values())


def program_stages(program: str, backend: str, *, grid, m: int, q_max: int, device,
                   group=None):
    """(route, submit, collect, cache leaves on this device or rank, mesh,
    outputs) of one program, built by the real builders with a
    :func:`probe_cache`. ``outputs`` holds the device program's last
    (mean, var): the blend's, per rank on the mesh. ``group`` is the mesh
    lane's process group (``mesh-blend`` only)."""
    from repro_torch.core import posterior
    from repro_torch.gp.covariances import rbf
    from repro_torch.launch import serve_sharded as ss

    outputs: list = []

    def capture(fn):
        def device_program(*args, **kwargs):
            out = fn(*args, **kwargs)
            outputs[:] = list(out)
            return out

        return device_program

    cache = probe_cache(grid.num_partitions, m, device)
    if program == "replicated-blend":
        route, submit, collect = ss.make_replicated_stages(cache, rbf, grid)
        return route, capture(submit), collect, posterior.cache_leaves(cache), None, outputs
    if program == "sharded-blend":
        blend_fn = capture(ss.make_halo_blend(grid, rbf, backend, device))
        stages = ss.make_request_stages(grid, blend_fn, cache, device=device, q_max=q_max)
        return (*stages, posterior.cache_leaves(cache), None, outputs)
    if program == "mesh-blend":
        mesh = ss.mesh_for_grid(grid, group)
        local = ss.shard_cache(cache, mesh)  # what Server(group=...) serves from
        del cache
        prog = ss.make_sharded_blend(mesh, mesh.axis_names, grid, rbf, backend=backend)
        prog = prog._replace(resolve=capture(prog.resolve))
        stages = ss.make_mesh_request_stages(grid, prog, local, mesh, device=device, q_max=q_max)
        return (*stages, posterior.cache_leaves(local), mesh, outputs)
    raise ValueError(f"unknown program {program!r}")


def drive_program(program: str, backend: str, *, grid_side: int, m: int, q_max: int,
                  n_queries: int, device="cpu", group=None) -> dict:
    """Serve one warm-up request, then record one request through the
    program's real stages. Returns {"trace", "costs", "cuda_peak_bytes",
    "mesh_stats"}: the trace text (:class:`Recorder`), the five
    shape-derived cost metrics of ``costs.METRICS`` and, on the card, the
    peak CUDA memory allocated over the request (after a reset)."""
    device = torch.device(device)
    grid = probe_grid(grid_side)
    if program != "replicated-blend" and -(-n_queries // grid.num_partitions) > q_max:
        raise ValueError(f"{n_queries} probe queries overflow q_max {q_max} on {grid_side}^2 cells")
    route, submit, collect, leaves, mesh, outputs = program_stages(
        program, backend, grid=grid, m=m, q_max=q_max, device=device, group=group)
    q = probe_queries(grid, n_queries)
    collect(submit(route(q)))  # warm-up, not recorded
    if mesh is not None:
        mesh.reset_stats()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with recording(leaves) as rec:
        routed = route(q)
        blocks = routed[1] if isinstance(routed, tuple) else (routed,)
        rec.io("input", blocks)
        rec.stage = "submit"
        pending = submit(routed)
        rec.stage = "collect"
        collect(pending)
        rec.io("output", outputs)
    if cuda:
        torch.cuda.synchronize(device)
    header = (f"# program {program}/{backend} device={device.type} grid={grid_side} m={m} "
              f"q_max={q_max} n_queries={n_queries}"
              + (f" rank={mesh.rank}" if mesh is not None else ""))
    if mesh is not None:
        header += f"\n# halo-mesh shifts={mesh.shifts} gathers={mesh.gathers}"
    arg_bytes = resident_bytes(leaves) + sum(int(np.asarray(b).nbytes) for b in blocks)
    return {
        "trace": rec.text(header),
        "costs": {
            "flops": float(rec.flops),
            "bytes_accessed": float(rec.bytes_accessed),
            "arg_bytes": int(arg_bytes),
            "out_bytes": int(sum(_nbytes(t) for t in outputs)),
            "temp_bytes": int(rec.peak_bytes),
        },
        "cuda_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else None,
        "mesh_stats": None if mesh is None else {"shifts": mesh.shifts, "gathers": mesh.gathers},
    }


# --------------------------------------------------------------------------
# The pass
# --------------------------------------------------------------------------


def probe_job(key: tuple, *, grid_side: int, m: int, q_max: int, n_queries: int) -> tuple:
    """The probe point of one program key: (program, backend, side, q_max,
    n_queries, m). The halo programs take half-full blocks."""
    program, backend = key
    if program == "replicated-blend":
        return (program, backend, grid_side, q_max, n_queries, m)
    return (program, backend, grid_side, q_max, grid_side * grid_side * q_max // 2, m)


def run_jobs(jobs: list, device: str) -> dict:
    """job -> result (:func:`drive_program`; for the mesh, a list of every
    rank's result). One-process programs run here; every mesh job of the
    list runs in ONE spawn of ranks (``meshprobe``)."""
    from repro_torch.analysis import meshprobe

    out = {}
    mesh_jobs = [j for j in jobs if j[0] == "mesh-blend"]
    if mesh_jobs:
        out.update(meshprobe.results(mesh_jobs, device))
    for job in jobs:
        if job[0] != "mesh-blend":
            program, backend, side, q, n, m = job
            out[job] = drive_program(program, backend, grid_side=side, m=m, q_max=q,
                                     n_queries=n, device=device)
    return out


def run(
    *,
    grid_side: int = DEFAULT_GRID_SIDE,
    m: int = DEFAULT_M,
    q_max: int = DEFAULT_Q_MAX,
    n_queries: int = DEFAULT_N_QUERIES,
    lanes: tuple = None,
    device: str = "cpu",
) -> tuple:
    """The full pass: drive every distinct program once, apply every lane
    (on the mesh, to every rank's trace). Returns (findings, report)."""
    from repro_torch.api.config import ServeConfig

    lanes = inv.LANES if lanes is None else lanes
    findings: list = []
    lane_records = []
    t0 = time.time()
    valid = []
    for lane in lanes:
        # manifest rot: the lane's serve dict must still be a ServeConfig
        try:
            ServeConfig.from_dict(lane.serve)
        except (ValueError, TypeError) as e:
            findings.append(Finding("hlo", "HLO-MANIFEST", f"lane:{lane.name}",
                                    f"lane serve dict no longer parses as a ServeConfig: {e}"))
            continue
        valid.append(lane)
    jobs = {lane.program_key: probe_job(lane.program_key, grid_side=grid_side, m=m,
                                        q_max=q_max, n_queries=n_queries) for lane in valid}
    results = run_jobs(sorted(set(jobs.values())), device) if jobs else {}
    for lane in valid:
        res = results[jobs[lane.program_key]]
        per_rank = res if isinstance(res, list) else [res]
        lane_findings, counts = [], None
        for r in per_rank:
            fs, c = check_text(lane, r["trace"])
            lane_findings.extend(f for f in fs if f not in lane_findings)
            counts = counts or c
        findings.extend(lane_findings)
        rec = {
            "lane": lane.name,
            "program": "/".join(lane.program_key),
            "serve_config": lane.serve,
            "collectives": {op: n for op, n in counts.items()
                            if op not in TALLIES and op != "f64-ops"},
            "kernel_dispatches": counts["kernel"],
            "host_copies": counts["host-copy"],
            "index_gathers": counts["index-gather"],
            "f64_ops": counts["f64-ops"],
            "max_collective_permute": lane.max_collective_permute,
            "exact": lane.exact,
            "violations": len(lane_findings),
        }
        if isinstance(res, list):
            rec["ranks"] = len(res)
            rec["mesh_stats"] = res[0]["mesh_stats"]
        lane_records.append(rec)
    traces = {"/".join(k): (results[j][0] if isinstance(results[j], list) else results[j])["trace"]
              for k, j in jobs.items()}
    report = {
        "lanes": lane_records,
        "programs_recorded": sorted(traces),
        "traces": traces,
        "grid_side": grid_side,
        "m": m,
        "q_max": q_max,
        "device": device,
        "seconds": round(time.time() - t0, 3),
    }
    return findings, report
