"""Multi-pod dry-run (port of ``repro.launch.dryrun``).

Shows that EVERY (architecture x input shape) combination runs on the
production meshes — 16x16 single pod and 2x16x16 multi-pod — with the
sharding rules, without allocating anything: the port's own steps
(``runtime.steps``) run eagerly on fake tensors (``FakeTensorMode``), every
parameter, optimizer moment, cache leaf and input a DTensor shard, over a
fake process group of 256 or 512 ranks (``torch.testing._internal.
distributed.fake_pg``) that moves no data. A 76B model traces on a laptop.

Per combination it records one device's :class:`hlo_analysis.Trace`: its
memory (arguments, outputs, temps, peak), FLOPs and bytes, and the
collective bytes by kind — the inputs to a roofline — with the same keys
as the JAX package's records. ``compile_s`` holds the trace's seconds;
``collective_sites`` (the port's own key) gives each model line's
collective bytes by kind, what two records are compared by
(``scripts/dryrun_diff.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out out.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --psvgp [--multi-pod] [--comm gather]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import math
import sys
import time
import traceback

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get, swa_variant
from repro_torch.configs.shapes import InputShape, input_specs_for
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import MeshSpec, device_mesh, make_production_mesh, trace_mesh
from repro_torch.sharding import batch_pspec, cache_pspecs, data_axes, state_pspecs
from repro_torch.sharding.rules import fold_spec, map_specs


def _data_shardable(n: int, mesh) -> bool:
    return n % math.prod(mesh.shape[a] for a in data_axes(mesh)) == 0


def resolve_config(arch: str, shape_name: str):
    """Apply the long_500k SWA variant where the assignment requires it."""
    cfg = get(arch)
    if shape_name == "long_500k":
        cfg = swa_variant(cfg)
    return cfg


def fake_world(size: int) -> None:
    """Make the default process group a fake one of ``size`` ranks (this
    process rank 0), re-initialised when its size differs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=size, store=FakeStore())


@contextlib.contextmanager
def _quiet_dtensor():
    """DTensor warns on each multi-axis redistribution; the trace records
    them instead."""
    logger = logging.getLogger("torch.distributed.tensor")
    level = logger.level
    logger.setLevel(logging.ERROR)
    try:
        yield
    finally:
        logger.setLevel(level)


def trace_combo(cfg, shape: str | InputShape, mesh: MeshSpec, fsdp: bool = False,
                microbatches: int = 1) -> hlo_analysis.Trace:
    """Trace one (config, shape) on ``mesh``: one device's record. ``shape``
    names one of ``INPUT_SHAPES`` or is an ``InputShape`` of its own."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import transformer
    from repro_torch.optim.adam import AdamState
    from repro_torch.runtime.steps import (
        TrainState,
        init_train_state,
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )
    from repro_torch.sharding.dtensor import distribute

    sh = shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]
    fake_world(mesh.size)
    dmesh = device_mesh(trace_mesh(mesh))

    def fold(specs):  # the production mesh's specs on the trace's mesh
        return map_specs(functools.partial(fold_spec, mesh=mesh), specs)

    trace = hlo_analysis.Trace()
    with _quiet_dtensor(), hlo_analysis.fake_tracing(trace), implicit_replication():
        state = init_train_state(torch.Generator().manual_seed(0), cfg)
        pspecs = fold(state_pspecs(state, mesh, fsdp=fsdp))
        bspec = fold(batch_pspec(mesh)) if _data_shardable(sh.global_batch, mesh) else ()
        params = distribute(state.params, pspecs.params, dmesh)
        if sh.kind == "train":
            specs = input_specs_for(cfg, sh)
            batch = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in specs.items()}
            batch = distribute(batch, {k: bspec if v.ndim >= 2 else () for k, v in specs.items()},
                               dmesh)
            opt = AdamState(step=0, mu=distribute(state.opt.mu, pspecs.params, dmesh),
                            nu=distribute(state.opt.nu, pspecs.params, dmesh))
            args = (TrainState(params, opt, 0), batch)
            step = make_train_step(cfg, microbatches=microbatches)
            kwargs = {}
        elif sh.kind == "prefill":
            specs = input_specs_for(cfg, sh)
            names = [k for k in ("tokens", "frames", "patches") if k in specs]
            inputs = distribute({k: torch.empty(specs[k].shape, dtype=specs[k].dtype)
                                 for k in names}, dict.fromkeys(names, bspec), dmesh)
            step = make_prefill_step(cfg, cache_len=sh.seq_len)
            args, kwargs = (params,), inputs
        else:  # decode
            serve_cfg = dataclasses.replace(cfg, remat=False)
            cache = transformer.init_cache(serve_cfg, sh.global_batch, sh.seq_len,
                                           transformer.torch_dtype(serve_cfg.dtype),
                                           device="meta")
            cspecs = fold(cache_pspecs(cache, mesh, shard_seq=(sh.global_batch == 1)))
            cache = distribute(cache, cspecs, dmesh)
            tokens = distribute(torch.empty((sh.global_batch, 1), dtype=torch.int32), bspec,
                                dmesh)
            pos = torch.zeros((), dtype=torch.int64)
            step = make_decode_step(cfg)
            args, kwargs = (params, cache, pos, tokens), {}
        del state
        trace.add_arguments((args, kwargs))
        trace.suppress -= 1
        out = step(*args, **kwargs)
        trace.add_outputs(out)
    return trace


def _depth_variants(cfg):
    """Reduced-depth configs with 1 and 2 periods (same prelude and
    remainder) for the period extrapolation: (c2 - c1) = one period's
    cost."""
    prelude = 1 if (cfg.moe is not None and cfg.moe.first_layer_dense) else 0
    rem = (cfg.num_layers - prelude) % cfg.period
    n1 = prelude + cfg.period + rem
    n2 = n1 + cfg.period
    return dataclasses.replace(cfg, num_layers=n1), dataclasses.replace(cfg, num_layers=n2)


def _record_terms(terms: hlo_analysis.RooflineTerms) -> dict:
    return {
        "flops_per_device": terms.flops_per_device,
        "hlo_bytes_per_device": terms.bytes_per_device,
        "collective_bytes_per_device": terms.collective_bytes_per_device,
        "collective_breakdown": terms.collective_breakdown,
        "roofline_s": {
            "compute": terms.compute_s,
            "memory": terms.memory_s,
            "collective": terms.collective_s,
        },
        "dominant": terms.dominant,
    }


def _counts(trace: hlo_analysis.Trace) -> dict:
    sites = {key: n for key, (_, n) in trace.collective_sites().items()}
    return {"flops": trace.flops, "bytes": trace.bytes_accessed,
            "collectives": hlo_analysis.collective_bytes(trace), "memory": trace.memory(),
            "sites": sites}


def _extrapolate(c1: dict, c2: dict, k: float) -> dict:
    """c1 + k (c2 - c1), leaf by leaf (a collective kind missing from one
    counts 0 there; never below c1's, as JAX's breakdown)."""
    def ex(a, b):
        return a + k * (b - a)

    out = {"flops": ex(c1["flops"], c2["flops"]), "bytes": ex(c1["bytes"], c2["bytes"])}
    kinds = set(c1["collectives"]) | set(c2["collectives"])

    def bytes_of(a, b, keys):
        return {key: max(int(ex(a.get(key, 0), b.get(key, 0))), a.get(key, 0)) for key in keys}

    out["collectives"] = bytes_of(c1["collectives"], c2["collectives"], kinds)
    out["memory"] = {key: int(ex(c1["memory"][key], c2["memory"][key])) for key in c1["memory"]}
    out["sites"] = bytes_of(c1["sites"], c2["sites"], set(c1["sites"]) | set(c2["sites"]))
    return out


def _sites(sites: dict) -> dict:
    """(site, kind) -> bytes as the record's ``collective_sites``: site ->
    kind -> collective bytes a device."""
    out: dict = {}
    for (site, kind), n in sorted(sites.items()):
        out.setdefault(site, {})[kind] = n
    return out


# sequence lengths a time-loop architecture (xLSTM) is traced at, as
# multiples of the mLSTM's 64-token chunk; see ``dryrun_one``
SEQ_POINTS = (64, 128)


def dryrun_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    verbose: bool = True,
    extrapolate: bool = True,
    cfg_override=None,
    fsdp: bool = False,
    microbatches: int = 1,
    q_chunk: int = 0,
):
    """Trace one (arch, shape, mesh); return the analysis record.

    The eager trace counts every period, so it needs no extrapolation for
    exactness (XLA's cost analysis counts a while body once, so the JAX
    package's must extrapolate). With ``extrapolate`` the FLOPs, bytes and
    collectives come from the 1- and 2-period variants, total = c1 +
    (n_periods - 1) * (c2 - c1), exact because every period is identical
    work: it saves time. Memory comes from the full-depth trace, as JAX's.

    The xLSTM blocks step through time in Python (the sLSTM one position
    at a time), so a trace of thousands of positions takes many minutes:
    with ``extrapolate`` a train or prefill shape of such an architecture
    is traced at the depth variants and at ``SEQ_POINTS`` positions, and
    every count is taken linear in the sequence length between them (the
    blocks' work and activations are per position or per chunk), and the
    memory too, from full-depth traces at the two lengths; the record's
    ``trace_extrapolated`` says which.
    """
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = cfg_override if cfg_override is not None else resolve_config(arch, shape_name)
    if q_chunk:
        cfg = dataclasses.replace(cfg, attn_q_chunk=q_chunk)
    sh = INPUT_SHAPES[shape_name]
    if sh.kind != "train":
        # FSDP weight-gathers per decode step would wreck serving latency;
        # microbatching only applies to gradient steps.
        fsdp, microbatches = False, 1
    t0 = time.time()

    prelude = 1 if (cfg.moe is not None and cfg.moe.first_layer_dense) else 0
    n_periods = (cfg.num_layers - prelude) // cfg.period
    by_seq = extrapolate and hlo_analysis.has_time_while_loops(cfg) and sh.kind != "decode"

    def measured(at: InputShape) -> dict:
        if not (extrapolate and n_periods > 1):
            return _counts(trace_combo(cfg, at, mesh, fsdp=fsdp, microbatches=microbatches))
        # the variants run microbatches=1, as JAX's metric variants do
        c1, c2 = (_counts(trace_combo(c, at, mesh, fsdp=fsdp)) for c in _depth_variants(cfg))
        out = _extrapolate(c1, c2, n_periods - 1)
        # a peak is not a sum over periods (a remat step holds one period's
        # activations at a time): the full depth's own
        out["memory"] = trace_combo(cfg, at, mesh, fsdp=fsdp, microbatches=microbatches).memory()
        return out

    if by_seq:
        s1, s2 = SEQ_POINTS
        counts = _extrapolate(measured(sh._replace(seq_len=s1)), measured(sh._replace(seq_len=s2)),
                              (sh.seq_len - s1) / (s2 - s1))
        how = f"seq({s1},{s2})" + ("+periods" if n_periods > 1 else "")
    else:
        counts = measured(sh)
        how = "periods" if (extrapolate and n_periods > 1) else None
    terms = hlo_analysis.terms_from(counts["flops"], counts["bytes"], counts["collectives"])
    mem = counts["memory"]
    flops_source = "trace+period-extrapolated" if how else "trace"

    if hlo_analysis.has_time_while_loops(cfg):
        # mlstm/slstm scan over TIME: the analytical count, as JAX's
        total = hlo_analysis.analytical_flops_recurrent(cfg, sh.seq_len, sh.global_batch,
                                                        sh.kind)
        flops = total / mesh.size
        terms = terms._replace(flops_per_device=flops,
                               compute_s=flops / hlo_analysis.PEAK_FLOPS)
        flops_source = "analytical(time-scan)"

    if sh.kind == "train":
        mflops = hlo_analysis.model_flops_train(cfg, sh.seq_len, sh.global_batch)
    elif sh.kind == "prefill":
        mflops = hlo_analysis.model_flops_train(cfg, sh.seq_len, sh.global_batch) / 3.0
    else:
        mflops = hlo_analysis.model_flops_decode(cfg, sh.global_batch)
    chips = mesh.size
    total_flops = terms.flops_per_device * chips

    rec = {
        "arch": arch,
        "config_name": cfg.name,
        "shape": shape_name,
        "kind": sh.kind,
        "fsdp": fsdp,
        "microbatches": microbatches,
        "q_chunk": q_chunk,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "compile_s": round(time.time() - t0, 1),
        "bytes_per_device": mem,
        **_record_terms(terms),
        "flops_source": flops_source,
        "trace_extrapolated": how,
        "collective_sites": _sites(counts["sites"]),
        "model_flops": mflops,
        "useful_compute_ratio": mflops / total_flops if total_flops else 0.0,
    }
    if verbose:
        print(json.dumps(rec, indent=2))
    return rec


N_MAX = 224  # the paper's max partition size (222), padded to sublane x8


def _psvgp_setup(mesh: MeshSpec, comm: str, device, exp=None):
    """(grid, PSVGPConfig, record label) of ``exp``'s grid (the dry-run
    grid of ``mesh`` when None)."""
    import numpy as np
    import torch

    from repro_torch.configs.psvgp_e3sm import DRYRUN_MULTI_POD, DRYRUN_SINGLE_POD
    from repro_torch.core.partition import make_grid

    if exp is None:
        exp = DRYRUN_MULTI_POD if "pod" in mesh.axis_names else DRYRUN_SINGLE_POD
    gx, gy = exp.grid
    grid = make_grid(np.zeros((1, 2), np.float32), gx, gy, bounds=(0.0, 10.0, 0.0, 10.0))
    cfg = exp.psvgp(comm=comm, use_pallas=torch.device(device).type == "cuda")
    return grid, cfg, f"grid{gx}x{gy}-m{cfg.svgp.num_inducing}-B{cfg.batch_size}"


def _cells_state(cfg, n_cells: int, device, seed: int = 0):
    """A state of ``n_cells`` cells and their data (x, y, mask), seeded:
    points uniform on the cell, y zeros, every row valid."""
    import torch

    from repro_torch.core import svgp
    from repro_torch.core.psvgp import PSVGPState
    from repro_torch.optim.adam import adam_init

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n_cells, N_MAX, 2), generator=gen, device=device)
    mask = torch.ones((n_cells, N_MAX), device=device)
    params = svgp.init_svgp_params(gen, cfg.svgp, x, mask)
    return PSVGPState(params, adam_init(params), 0), x, torch.zeros_like(mask), mask


def psvgp_rank_trace(mesh: MeshSpec, device="cpu", exp=None) -> hlo_analysis.Trace:
    """Rank 0's SPMD step (``core.psvgp_spmd.make_spmd_step``), one cell of
    the dry-run grid, traced on real tensors on ``device`` over a fake
    group of ``mesh.size`` ranks (:func:`fake_world`). The
    grid's rows are the mesh's row axes together (pod x data multi-pod), as
    the halo mesh lays them. The step's draws are injected: direction 1
    (east), which rank 0 (cell (0, 0)) receives, and rows 0..B-1."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.psvgp_spmd import make_spmd_step
    from repro_torch.gp.covariances import make_covariance
    from repro_torch.launch.serve_sharded import HaloMesh

    grid, cfg, _ = _psvgp_setup(mesh, "ppermute", device, exp)
    fake_world(mesh.size)
    halo = HaloMesh(dist.group.WORLD, grid.gx, grid.gy)
    p_dir = torch.full((5,), 0.2, device=device)
    step = make_spmd_step(halo, halo.axis_names, grid, cfg,
                          make_covariance(cfg.svgp.covariance), p_dir)
    state, x, y, mask = _cells_state(cfg, 1, device)
    probs = torch.full((1, 5), 0.2, device=device)
    n_eff = torch.full((1,), float(N_MAX), device=device)
    draws = (torch.tensor(1), torch.arange(cfg.batch_size))
    trace = hlo_analysis.Trace()
    trace.add_arguments((state, x, y, mask, probs, n_eff))
    with hlo_analysis.real_tracing(trace):
        out = step(state, 0, x, y, mask, probs, n_eff, draws=draws)
    trace.add_outputs(out)
    return trace


def psvgp_gather_trace(mesh: MeshSpec, exp=None) -> hlo_analysis.Trace:
    """The one-program ``psvgp.train_step_gather`` on fake tensors, every
    leaf sharded on its partition axis over all mesh axes (one partition a
    device), as the JAX package's pjit specs: traced on one mesh axis of
    all the devices, the same layout and groups."""
    import torch
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core import psvgp
    from repro_torch.core.neighbors import neighbor_table
    from repro_torch.core.sampler import slot_distribution
    from repro_torch.gp.covariances import make_covariance
    from repro_torch.optim.adam import tree_map
    from repro_torch.sharding.dtensor import distribute

    grid, cfg, _ = _psvgp_setup(mesh, "gather", "cpu", exp)
    fake_world(mesh.size)
    # every mesh axis over the one partition axis: one axis of all devices
    cells = MeshSpec(("cells",), (mesh.size,))
    dmesh = device_mesh(cells)
    P_ = grid.num_partitions
    lead = ("cells",)
    trace = hlo_analysis.Trace()
    with _quiet_dtensor(), hlo_analysis.fake_tracing(trace), implicit_replication():
        state, x, y, mask = _cells_state(cfg, P_, "cpu")
        tbl = torch.as_tensor(neighbor_table(grid))
        dist_ = slot_distribution(torch.zeros((P_,), dtype=torch.long), tbl, cfg.delta)

        def shard(tree):
            return distribute(tree, tree_map(lambda _: lead, tree), dmesh)

        state = psvgp.PSVGPState(shard(state.params),
                                 state.opt._replace(mu=shard(state.opt.mu),
                                                    nu=shard(state.opt.nu)), 0)
        x, y, mask = shard((x, y, mask))
        dist_ = shard(dist_)
        args = (state, 0, x, y, mask, dist_)
        trace.add_arguments(args)
        trace.suppress -= 1
        new_state, loss = psvgp.train_step_gather(*args, cfg=cfg,
                                                  cov_fn=make_covariance(cfg.svgp.covariance))
        # the loss replicated, as JAX's out_shardings ask: the mean's pending
        # average over the cells is all-reduced
        out = (new_state, loss.redistribute(dmesh, [Replicate()]))
        trace.add_outputs(out)
    return trace


def dryrun_psvgp(*, multi_pod: bool = False, comm: str = "ppermute", verbose: bool = True):
    """Trace the PSVGP train step on the production mesh.

    One partition per device: 16x16 grid single-pod, 16x32 multi-pod (the
    32 rows are pod x data). ``ppermute``: rank 0's SPMD step on real
    tensors over the fake group (:func:`psvgp_rank_trace`); ``gather``: the
    one-program gather step on fake tensors (:func:`psvgp_gather_trace`)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    _, _, label = _psvgp_setup(mesh, comm, "cpu")
    trace = psvgp_rank_trace(mesh) if comm == "ppermute" else psvgp_gather_trace(mesh)
    rec = {
        "arch": "psvgp-e3sm",
        "config_name": f"psvgp-{comm}",
        "shape": label,
        "kind": "train",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh.size,
        "compile_s": round(time.time() - t0, 1),
        "bytes_per_device": trace.memory(),
        **_record_terms(hlo_analysis.roofline(trace)),
    }
    if verbose:
        print(json.dumps(rec, indent=2))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=[a.replace("_", "-").replace("-0-", "-0.") for a in ARCH_IDS]
                    + ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="every (arch x shape)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fsdp", action="store_true", help="ZeRO-3 weight/opt sharding over data axes")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation chunks (train shapes)")
    ap.add_argument("--q-chunk", type=int, default=0,
                    help="query-chunked attention block size (0=off)")
    ap.add_argument("--psvgp", action="store_true", help="dry-run the paper's PSVGP step")
    ap.add_argument("--comm", default="ppermute", choices=["ppermute", "gather"])
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args()

    records, failures = [], []
    t0 = time.time()

    def emit(rec):
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    if args.psvgp:
        emit(dryrun_psvgp(multi_pod=args.multi_pod, comm=args.comm))
    elif args.all:
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                try:
                    emit(dryrun_one(arch, shape, multi_pod=args.multi_pod, fsdp=args.fsdp,
                                    microbatches=args.microbatches, q_chunk=args.q_chunk))
                except Exception as e:  # noqa: BLE001 — report all failures at end
                    traceback.print_exc()
                    failures.append((arch, shape, repr(e)))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all / --psvgp)")
        emit(dryrun_one(args.arch, args.shape, multi_pod=args.multi_pod, fsdp=args.fsdp,
                        microbatches=args.microbatches, q_chunk=args.q_chunk))

    print(f"\n{len(records)} dry-runs OK, {len(failures)} failed in {time.time() - t0:.1f} s")
    for f in failures:
        print("FAILED:", f)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
