#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python chip_smoke.py [--out report.json]

Phases, each printed as it runs; any failure exits non-zero:

  1. card     the card's name and power limit (nvidia-smi); TF32 off.
  2. build    nvcc builds the kernels from src/repro_torch/kernels/csrc/
              (one nvcc per source, in parallel) and reports the registers
              and spills of every template instance.
  3. kernels  each CUDA kernel against its plain PyTorch version on the
              card. Prediction: at the serving path's shape (the paper's
              400-cell artifact, 9 halo slots, q_max 32, m 5) and at
              ragged/odd shapes (m in {1, 10, 17, 64}, Q not a multiple of
              128, d up to 4) and one cell's 65,536 rows, plus row
              independence. Training: the
              ELBO projection and K(X, Z) at the training step's shape
              (400 cells x 32 rows, m 5, on the artifact's factors), at
              every m in {1, 10, 17, 64} x B in {1, 33, 200} (P = 1, d up
              to 4) and at B = 65,536 with m = 64; then the gradient of the
              autograd Function against plain-version autograd.
  4. serving  Server.from_artifact(the committed JAX-trained artifact,
              ServeConfig(mode="sharded")) on the card: answers against the
              JAX answers stored beside it, the kernel's launch count over
              the run, serial == pipelined and submit_many == solo submit
              bitwise; the two-level router on a zipf stream; the "pallas"
              lane; the replicated lane against the JAX replicated answers.
  5. training api.fit at the paper's configuration (48,602 points, 20 x 20
              cells, m 5, delta 0.125, batch 32, lr 0.05, 2,500 steps) on
              the card: one projection launch per step, in-sample RMSPE and
              boundary RMSD inside the band of the JAX package's seeds,
              save -> load -> serve bitwise, a ppermute fit, a warm refit,
              refit(scratch) == fit bitwise.
  6. times    the launch floor (a one-element add_ through the same CUDA
              graph); every kernel, its plain version and its bound at its
              path's shape and at a 65,536-row batch (the slots kernel also
              at one cell's 65,536 rows); p50/p95 latency and
              points/s of a stream of 4,096-point requests, the host stages
              of a request; ms per training step and fit seconds; the
              device's busy share of a request and of a training step
              (torch.profiler).

Tolerances (``repro_torch.kernels.ref.tolerance_ratio``): float32 rounding
scaled by the magnitude of the terms each output sums — prediction: per
row |d mean| <= 1e-5 max(1, sum_j |k_j c_j|), |d var| <= 1e-5 max(1,
||Wk||^2 + ||Uk||^2) (fitted c_j cancel); projection: |d knm| <= 1e-5
sigma^2, |d lk_t| <= 1e-5 max(1, sum_j |k_j W_ij|), |d q_diag| <= 1e-5
max(1, q_diag); gradients: |d g| <= 1e-5 max(1, max |g|) per leaf.

The last two lines of standard output are the kernel table and the
device record, each one JSON object. Exits non-zero without printing
them when no CUDA device is available, or when the port's sources are
not beside this file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "psvgp_e3sm")

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and the FP32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
N_HALF = 2048


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_report(log: str) -> dict:
    """{kernel<template args>: [registers, spill bytes]} of every instance
    in nvcc's ``-Xptxas -v`` output (``build.build_log``)."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = re.search(r"([a-z_]+_kernel)I(.*?)EEv", entry.group(1))
            name = (f"{kernel.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', kernel.group(2) + 'E'))}>"
                    if kernel else entry.group(1))
            out[name] = [None, 0]
        elif name is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out[name][1] = int(spill.group(1)) + int(spill.group(2))
            if regs:
                out[name][0] = int(regs.group(1))
    return out


def predict_flops_per_row(m: int, d: int) -> int:
    """Operations of one query row: scale x (d); per inducing point the
    explicit difference, square and sum (3d), -0.5 r2, exp, * var (3); the
    mean (2m); two m x m projections and their squared norms (4m^2 + 4m);
    var - q + s (2)."""
    return d + m * (3 * d + 3) + 2 * m + 4 * m * m + 4 * m + 2


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    """(ms, what bounds it): bytes over the HBM rate against operations over
    the FP32 rate, the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def bound(P: int, S: int, Q: int, m: int, d: int) -> tuple[float, str]:
    """Least time (ms) for one predict launch: each input read once (queries
    and P cells' factors), each output written once."""
    rows = P * S * Q
    nbytes = 4 * (rows * d + P * (m * d + 2 * m * m + m + d + 1) + 2 * rows)
    return _bound(nbytes, rows * predict_flops_per_row(m, d))


def projection_bound(P: int, B: int, m: int, d: int, project: bool) -> tuple[float, str]:
    """Least time (ms) for one launch of the projection (``project``) or the
    K(X, Z) kernel: x and the P cells' z, log l, log sigma^2 (and W) read
    once; knm (and lk_t, q_diag) written once. Operations per row: scale x
    (d); per inducing point the difference, square and sum (3d), -0.5 r2,
    exp, * sigma^2 (3); then lk_t = knm W^T (2m^2) and q_diag (2m)."""
    rows = P * B
    nbytes = 4 * (rows * d + P * (m * d + d + 1 + (m * m if project else 0))
                  + rows * m * (2 if project else 1) + (rows if project else 0))
    flops = rows * (d + m * (3 * d + 3) + ((2 * m * m + 2 * m) if project else 0))
    return _bound(nbytes, flops)


def device_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed between CUDA events (no host launch gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def device_busy(torch, prof, n: int) -> tuple[float, dict]:
    """(busy us, {top device op: us per item}) of a torch.profiler window of
    ``n`` items: the union of every kernel and copy it saw on the card."""
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    per_name: dict = {}
    for e in sorted(on_card, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        name = e.name if len(e.name) <= 40 else e.name[:37] + "..."
        per_name[name] = per_name.get(name, 0.0) + (b - a) / n
    return busy_us, dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:6])


def check_training_kernels(torch, dev, fitted, x_main, errors: dict) -> None:
    """Phase 3, training half: the projection and K(X, Z) kernels against
    their plain versions at the training step's shape (``x_main`` (400, 32,
    2) against the factors of the artifact ``fitted``), at every ragged
    (m, B) pair and at one large batch; then the autograd Function's
    gradient."""
    from repro_torch.core import posterior
    from repro_torch.kernels import ops, rbf, ref, svgp_proj

    cache = fitted.cache

    rng = np.random.default_rng(5)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def random_case(B, m, d):
        z = t(rng.uniform(0, 2, (1, m, d)))
        log_l = t(np.log(rng.uniform(0.3, 1.5, (1, d))))
        log_v = t(rng.normal(0, 0.5, 1))
        w = t(np.tril(rng.normal(0, 1, (1, m, m))) / np.sqrt(m))
        return t(rng.uniform(0, 2, (1, B, d))), z, log_l, log_v, w

    def compare(name, args):
        got = svgp_proj.svgp_projection(*args)
        want = ref.svgp_projection(*args)
        knm_s, lk_s, q_s = ref.svgp_projection_scales(*args)
        ratios = (ref.tolerance_ratio(got[0], want[0], knm_s, floor=0.0),
                  ref.tolerance_ratio(got[1], want[1], lk_s),
                  ref.tolerance_ratio(got[2], want[2], q_s))
        knm = rbf.rbf_cross_cov(*args[:4])
        r_rbf = ref.tolerance_ratio(knm, ref.rbf_cross_cov(*args[:4]), knm_s, floor=0.0)
        check(all(bool(torch.isfinite(g).all()) for g in (*got, knm)), f"{name}: non-finite output")
        check(max(ratios) <= 1, f"{name}: projection kernel disagrees with its plain version")
        check(r_rbf <= 1, f"{name}: rbf_cross_cov kernel disagrees with its plain version")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want, strict=True))
        err_rbf = float((knm - want[0]).abs().max())
        print(f"[kernels] {name}: projection max|d|={err:.3e}, tol ratios knm {ratios[0]:.3f} "
              f"lk_t {ratios[1]:.3f} q_diag {ratios[2]:.3f}; rbf_cross_cov max|d|={err_rbf:.3e} "
              f"ratio {r_rbf:.3f}")
        return err, err_rbf

    main_args = (x_main, cache.z, cache.cov.log_lengthscale, cache.cov.log_variance, cache.w)
    errors["svgp_projection"], errors["rbf_cross_cov"] = compare(
        "training step P=400 B=32 m=5 d=2 (artifact)", main_args)
    for i, (m, B) in enumerate((m, B) for m in (1, 10, 17, 64) for B in (1, 33, 200)):
        d = 1 + i % 4
        compare(f"P=1 B={B} m={m} d={d}", random_case(B, m, d))
    compare("P=1 B=65536 m=64 d=2", random_case(65536, 64, 2))

    # the gradient: the Function (kernel forward, plain recompute backward)
    # against autograd through the plain version, on the Cholesky factor of
    # the artifact's Kmm
    lmm = posterior.kmm_chol(fitted.params, fitted.cov_fn, fitted.config.jitter)
    args = [*main_args[:4], lmm]
    cot = [t(rng.normal(size=s)) for s in ((400, 32, 5), (400, 32, 5), (400, 32))]
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = svgp_proj.LAUNCHES["svgp_projection"]
    got = torch.autograd.grad(ops.svgp_projection(*leaves), leaves, cot)
    check(svgp_proj.LAUNCHES["svgp_projection"] == before + 1,
          "the Function's forward and backward launched the kernel other than once")
    plain = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ops.svgp_projection_ref(*plain), plain, cot)
    worst = 0.0
    for name, g, w in zip(("x", "z", "log_l", "log_v", "lmm"), got, want, strict=True):
        ratio = float((g - w).abs().max()) / (1e-5 * max(1.0, float(w.abs().max())))
        worst = max(worst, ratio)
        check(bool(torch.isfinite(g).all()) and ratio <= 1, f"gradient wrt {name} disagrees")
    print(f"[kernels] gradient of the projection Function vs plain autograd "
          f"(P=400 B=32 m=5): worst tol ratio {worst:.3f}; one launch, none in the backward")


def train_quality(torch, fitted, data, label: str) -> tuple[float, float]:
    """In-sample RMSPE and boundary RMSD (23 probes per edge) of a model on
    the points ``data`` it was fitted to, printed with ``label``."""
    from repro_torch.core import metrics, neighbors, partition

    pdata = partition.partition_data(data.x, data.y, fitted.grid, device=fitted.device)
    probes = neighbors.boundary_probes(fitted.grid, 23)
    rmspe = float(metrics.rmspe(fitted.static, fitted.state, pdata, cache=fitted.cache))
    rmsd = float(metrics.boundary_rmsd(fitted.static, fitted.state, probes, cache=fitted.cache))
    check(np.isfinite(rmspe) and np.isfinite(rmsd), f"{label}: non-finite metrics")
    print(f"[training] {label}: RMSPE {rmspe:.5f}, boundary RMSD {rmsd:.5f} "
          f"({len(probes.left)} edges x 23 probes)")
    return rmspe, rmsd


def train_slice(torch, dev, card: str, report: dict, ds):
    """Phase 5: the paper's model trained on ``ds`` on the card through
    ``api.fit``, counted, scored, saved, loaded, served and refitted.
    Returns the fitted model."""
    from repro_torch import api
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.core import psvgp
    from repro_torch.data.spatial import e3sm_like_field
    from repro_torch.kernels import predict, rbf, svgp_proj

    cfg = api.FitConfig(grid=20, m=5, delta=0.125, train_iters=2500, batch_size=32,
                        learning_rate=0.05, seed=0)
    next_slice = e3sm_like_field(n=48602, seed=1)

    # the main path, counted; every step's host time recorded (no extra
    # synchronization: a host-bound step's enqueue time is its time)
    step_ms: list = []
    inner = psvgp.train_step

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    for counter in (svgp_proj, rbf, predict):
        counter.reset_launches()
    psvgp.train_step = timed_step
    try:
        t0 = time.perf_counter()
        fitted = api.fit(cfg, ds)
        fit_wall = time.perf_counter() - t0
    finally:
        psvgp.train_step = inner
    launches = {**svgp_proj.LAUNCHES, **rbf.LAUNCHES, **predict.LAUNCHES}
    report["launches_training_path"] = launches
    print(f"[training] api.fit (grid 20, m 5, delta 0.125, B 32, lr 0.05, 2,500 steps) on "
          f"{fitted.device}: launches {launches}")
    check(fitted.device.type == "cuda" and fitted.static.cfg.svgp.use_pallas,
          "api.fit did not train on the kernel lane of the card")
    check(launches["svgp_projection"] == cfg.train_iters,
          f"projection launches {launches['svgp_projection']} != {cfg.train_iters} steps")
    rmspe, rmsd = train_quality(torch, fitted, ds, "port-trained, seed 0")
    report["training_quality"] = {"rmspe": rmspe, "boundary_rmsd": rmsd}
    check(0.052 <= rmspe <= 0.068, f"RMSPE {rmspe:.5f} outside [0.052, 0.068]")
    check(0.054 <= rmsd <= 0.076, f"boundary RMSD {rmsd:.5f} outside [0.054, 0.076]")
    jax_rmspe, jax_rmsd = train_quality(
        torch, api.FittedPSVGP.load(FIXTURE, device=dev), ds, "JAX-trained artifact, seed 0")
    report["jax_artifact_quality"] = {"rmspe": jax_rmspe, "boundary_rmsd": jax_rmsd}

    # save -> load -> serve, bitwise against the in-memory model
    lo = [fitted.grid.x_edges[0], fitted.grid.y_edges[0]]
    hi = [fitted.grid.x_edges[-1], fitted.grid.y_edges[-1]]
    q = np.random.default_rng(7).uniform(lo, hi, (4096, 2)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        loaded = api.FittedPSVGP.load(fitted.save(os.path.join(tmp, "artifact")))
    served = [api.Server(f, api.ServeConfig(mode="sharded")) for f in (fitted, loaded)]
    check(all(s.backend == "fused" for s in served), "the auto lane did not resolve to fused")
    (m0, v0), (m1, v1) = (s.submit(q) for s in served)
    check(np.isfinite(m0).all() and np.isfinite(v0).all() and (v0 > 0).all(),
          "the trained model serves non-finite or non-positive answers")
    check(np.array_equal(m0, m1) and np.array_equal(v0, v1),
          "save -> load -> serve differs from the in-memory model")
    print("[training] save -> load -> serve 4,096 points (sharded, fused): bitwise equal "
          "to the in-memory model")

    # the other comm mode, a warm in-situ step, and the golden property
    pp = api.fit(dataclasses.replace(cfg, comm="ppermute", train_iters=500), ds)
    report["ppermute_quality"] = dict(zip(("rmspe", "boundary_rmsd"),
                                          train_quality(torch, pp, ds, "ppermute, 500 steps")))
    warm = api.refit(fitted, next_slice, api.RefitConfig(train_iters=50))
    check(warm.state.step == cfg.train_iters + 50, "the warm refit did not continue the stream")
    report["warm_refit_quality"] = dict(zip(("rmspe", "boundary_rmsd"), train_quality(
        torch, warm, next_slice, "warm refit, 50 steps on the next slice (seed 1)")))
    budget = dataclasses.replace(cfg, train_iters=200)
    fresh = api.fit(budget, next_slice)
    scratch = api.refit(api.fit(budget, ds), next_slice,
                        api.RefitConfig(train_iters=200, init="scratch"))
    leaves = [flatten({"params": f.state.params, "mu": f.state.opt.mu, "nu": f.state.opt.nu})
              for f in (fresh, scratch)]
    check(all(np.array_equal(leaves[0][k], leaves[1][k]) for k in leaves[0]),
          "refit(scratch) != fit")
    print("[training] refit(init='scratch') == fit, bitwise (params and Adam moments, "
          "200 steps)")

    report["fit_seconds"] = fitted.train_seconds
    report["fit_wall_seconds"] = fit_wall
    report["step_ms_p50"] = float(np.median(step_ms))
    report["step_ms_p95"] = float(np.percentile(step_ms, 95))
    print(f"[times] [{card}] training: {fitted.train_seconds:.3f} s for 2,500 steps to a "
          f"synchronize ({fit_wall:.3f} s for api.fit with partitioning); step p50 "
          f"{report['step_ms_p50']:.4f} ms, p95 {report['step_ms_p95']:.4f} ms (host clock)")
    return fitted


def training_times(torch, dev, card: str, cache, x_main, fitted, ds, report: dict) -> list:
    """Phase 6, training half: device time of the projection and K(X, Z)
    kernels at the training step's shape and at 65,536 rows (one cell's
    factors), with their plain versions and bounds; the device's busy share
    of a training step in a profiler window of 20 steps."""
    from repro_torch.core import partition, psvgp
    from repro_torch.kernels import rbf, ref, svgp_proj

    grid = fitted.grid
    big = torch.as_tensor(np.random.default_rng(2).uniform(
        [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]],
        (1, 65536, 2)).astype(np.float32), device=dev)
    rows = []
    for label, x, factors in (
        ("main", x_main, (cache.z, cache.cov.log_lengthscale, cache.cov.log_variance, cache.w)),
        ("65,536 rows", big, (cache.z[:1], cache.cov.log_lengthscale[:1],
                              cache.cov.log_variance[:1], cache.w[:1])),
    ):
        P, B, d = x.shape
        m = factors[0].shape[1]
        for name, kernel, plain, project in (
            ("svgp_projection", svgp_proj.svgp_projection, ref.svgp_projection, True),
            ("rbf_cross_cov", rbf.rbf_cross_cov, ref.rbf_cross_cov, False),
        ):
            args = (x, *factors) if project else (x, *factors[:3])
            k_ms = device_ms(torch, lambda k=kernel, a=args: k(*a))
            p_ms = device_ms(torch, lambda f=plain, a=args: f(*a))
            b_ms, b_by = projection_bound(P, B, m, d, project)
            rows.append((name, label, (P, B), k_ms, p_ms, b_ms, b_by))
            print(f"[times] [{card}] {name} {label} (P, B)={(P, B)} m={m}: kernel "
                  f"{k_ms:.6f} ms, plain {p_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), "
                  f"floor {report['floor_ms']:.6f} ms")

    pdata = partition.partition_data(ds.x, ds.y, fitted.grid, device=dev)
    state = fitted.state
    for _ in range(3):
        state, _loss = psvgp.train_step(fitted.static, state, pdata)
    torch.cuda.synchronize()
    # host synchronizations inside one step (CUDA's sync debug mode warns
    # at each): the step is meant to read nothing back
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _loss = psvgp.train_step(fitted.static, state, pdata)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message).lower()]
    report["train_step_host_syncs"] = len(syncs)
    print(f"[times] training step host synchronizations: {len(syncs)}"
          + (f" (first: {syncs[0][:120]})" if syncs else ""))
    n = 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _loss = psvgp.train_step(fitted.static, state, pdata)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_name = device_busy(torch, prof, n)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    report["train_host_us_per_step"] = {e.key: e.self_cpu_time_total / n for e in host}
    report["train_device_ops_per_step"] = sum(
        1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) / n
    print(f"[times] [{card}] training step: {report['train_device_ops_per_step']:.1f} device "
          "ops per step; top host ops by self time, us per step: "
          + ", ".join(f"{k} {v:.1f}" for k, v in report["train_host_us_per_step"].items()))
    if busy_us > 0:
        report["train_device_busy_share"] = busy_us / window_us
        report["train_device_us_per_step"] = per_name
        print(f"[times] [{card}] training step: device busy {busy_us / n:.1f} us of "
              f"{window_us / n:.1f} us per step (share {busy_us / window_us:.4f}); top device "
              "ops, us per step: " + ", ".join(f"{k} {v:.1f}" for k, v in per_name.items()))
    else:
        report["train_device_busy_share"] = None
        print(f"[times] [{card}] training step device busy share: not measured "
              "(torch.profiler saw no device activity)")
    return rows


def run(report: dict) -> None:
    import torch

    from repro_torch import api
    from repro_torch.core import partition, routing
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.data.spatial import e3sm_like_field, zipf_query_stream
    from repro_torch.kernels import build, ops, predict, rbf, ref

    dev = torch.device("cuda")
    card = card_line()
    report["card"] = card
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {report['build_s']:.2f} s ({build.NVCC_FLAGS[1]})")
    report["ptxas"] = ptxas_report(build.build_log)
    for family in sorted({k.split("<")[0] for k in report["ptxas"]}):
        insts = sorted((tuple(int(a) for a in k[len(family) + 1:-1].split(",")), r, sp)
                       for k, (r, sp) in report["ptxas"].items() if k.startswith(family + "<"))
        print(f"[build] {family}<MMAX,KD,...> registers (+spill bytes): "
              + ", ".join(f"{args} {r}" + (f"+{sp}" if sp else "") for args, r, sp in insts))

    # -- 3. kernels against their plain versions ---------------------------
    fitted = api.FittedPSVGP.load(FIXTURE, device=dev)
    grid, cache = fitted.grid, fitted.cache
    refz = np.load(os.path.join(FIXTURE, "reference.npz"))
    queries = refz["queries"]
    table = routing.build_routing_table(grid, queries, q_max=32)
    hx_main = torch.as_tensor(routing.make_halo_stacker(grid)(table.xq), device=dev)
    leaves = (cache.z, cache.cov.log_lengthscale, cache.cov.log_variance,
              cache.w, cache.u, cache.c)
    rng = np.random.default_rng(0)
    errors = {}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def random_case(P, m, d):
        """Seeded factors of P cells; W, U, c of unit scale."""
        z = t(rng.uniform(0, 2, (P, m, d)))
        log_l = t(np.log(rng.uniform(0.3, 1.5, (P, d))))
        log_v = t(rng.normal(0, 0.5, P))
        w = t(rng.normal(0, 1, (P, m, m)) / np.sqrt(m))
        u = t(rng.normal(0, 1, (P, m, m)) / np.sqrt(m))
        c = t(rng.normal(0, 1, (P, m)))
        return z, log_l, log_v, w, u, c

    def compare(name, got, want, scales):
        rm = ref.tolerance_ratio(got[0], want[0], scales[0])
        rv = ref.tolerance_ratio(got[1], want[1], scales[1])
        err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        print(f"[kernels] {name}: max|d|={err:.3e}, tol ratio mean {rm:.3f} var {rv:.3f}")
        check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
              f"{name}: non-finite output")
        check(rm <= 1 and rv <= 1, f"{name}: kernel disagrees with its plain version")
        return err

    # the slots kernel (cell axis): main path shape, then ragged cases
    got = predict.posterior_predict_slots(hx_main, *leaves)
    want = ref.posterior_predict_slots_stacked(hx_main, *leaves)
    scales = ref.posterior_predict_scales(
        hx_main, *(a[:, None] for a in leaves)
    )
    errors["posterior_predict_slots"] = compare(
        "slots P=400 S=9 Q=32 m=5 d=2 (artifact)", got, want, scales)
    for P, S, Q, m, d in ((3, 9, 77, 1, 2), (5, 9, 200, 10, 2), (2, 4, 333, 17, 3),
                          (2, 9, 129, 64, 4), (1, 1, 1, 5, 1), (1, 1, 65536, 5, 2)):
        args = random_case(P, m, d)
        hx = t(rng.uniform(0, 2, (P, S, Q, d)))
        got = predict.posterior_predict_slots(hx, *args)
        want = ref.posterior_predict_slots_stacked(hx, *args)
        scales = ref.posterior_predict_scales(hx, *(a[:, None] for a in args))
        compare(f"slots P={P} S={S} Q={Q} m={m} d={d}", got, want, scales)

    # the single-block kernel ("pallas" lane): the main path's per-cell
    # blocks (9 * 32 rows of each cell), then ragged cases
    err = 0.0
    for p in range(grid.num_partitions):
        one = [a[p] for a in leaves]
        x = hx_main[p].reshape(-1, 2)
        got = predict.posterior_predict(x, *one)
        want = ref.posterior_predict(x, *one)
        scales = ref.posterior_predict_scales(x, *one)
        check(ref.tolerance_ratio(got[0], want[0], scales[0]) <= 1
              and ref.tolerance_ratio(got[1], want[1], scales[1]) <= 1,
              f"single-block kernel disagrees on cell {p}")
        err = max(err, float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    errors["posterior_predict"] = err
    print(f"[kernels] single-block Q=288 m=5 d=2 (artifact, all 400 cells): max|d|={err:.3e}")
    for Q, m, d in ((1, 1, 2), (1000, 10, 2), (517, 17, 2), (130, 64, 4)):
        args = [a[0] for a in random_case(1, m, d)]
        x = t(rng.uniform(0, 2, (Q, d)))
        got = predict.posterior_predict(x, *args)
        want = ref.posterior_predict(x, *args)
        compare(f"single-block Q={Q} m={m} d={d}", got, want,
                ref.posterior_predict_scales(x, *args))

    # row independence: the masked contract two-level routing relies on
    S, Q, m, d = 9, 200, 10, 2
    args = [a[0] for a in random_case(1, m, d)]
    hx = t(rng.uniform(0, 2, (S, Q, d)))
    qmask = t(rng.uniform(size=(S, Q)) < 0.6)
    base = ops.posterior_predict_slots(hx, *args)
    junk = torch.where(qmask[..., None] > 0, hx, torch.full_like(hx, 1e4))
    junk[0, :7] = torch.where(qmask[0, :7, None] > 0, hx[0, :7], float("nan"))
    again = ops.posterior_predict_slots(junk, *args)
    valid = qmask > 0
    check(all(torch.equal(b[valid], a[valid]) for b, a in zip(base, again, strict=True)),
          "row independence: junk in masked rows changed a valid row")
    masked = ref.posterior_predict_slots_masked(hx, qmask, *args)
    compare("row independence: kernel * qmask vs masked oracle",
            (base[0] * qmask, base[1] * qmask), masked,
            ref.posterior_predict_scales(hx, *args))
    print("[kernels] row independence: valid rows bitwise unchanged under junk masked rows")

    # the training kernels, on a training step's rows (the first 32 stored
    # rows of every cell of the paper's data) against the artifact's factors
    ds = e3sm_like_field(n=48602, seed=0)
    x_train = partition.partition_data(ds.x, ds.y, grid, device=dev).x[:, :32].contiguous()
    check_training_kernels(torch, dev, fitted, x_train, errors)

    # -- 4. the slice: a JAX-trained artifact served on the card ------------
    mean_scale, var_scale = blend_error_scales(cache, grid, queries)

    def vs_jax(name, mean, var, kind):
        rm = ref.tolerance_ratio(torch.as_tensor(mean), torch.as_tensor(refz[f"{kind}_mean"]),
                                 mean_scale.cpu())
        rv = ref.tolerance_ratio(torch.as_tensor(var), torch.as_tensor(refz[f"{kind}_var"]),
                                 var_scale.cpu())
        print(f"[slice] {name} vs JAX {kind}: tol ratio mean {rm:.3f} var {rv:.3f}")
        check(np.isfinite(mean).all() and np.isfinite(var).all() and mean.shape == (2 * N_HALF,),
              f"{name}: bad output")
        check(rm <= 1 and rv <= 1, f"{name}: disagrees with the JAX reference")

    def golden(server, requests, name):
        """serial == pipelined and submit_many == solo submit, bitwise."""
        out = {}
        for pipeline in ("serial", "pipelined"):
            cfg = api.ServeConfig(**{**server.config.to_dict(), "pipeline": pipeline})
            s = api.Server(fitted, cfg)
            res = []
            s.stream(requests, on_result=lambda i, r, res=res: res.append(r))
            out[pipeline] = res
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(out["serial"], out["pipelined"], strict=True))
        check(same, f"{name}: pipelined != serial")
        small = [q[:n] for q, n in zip(requests, (1, 7, 64, 33, 5, 128, 2, 19), strict=False)]
        many = server.submit_many(small)
        solo = [server.submit(q) for q in small]
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(many, solo, strict=True))
        check(same, f"{name}: submit_many != solo submit")
        print(f"[slice] {name}: pipelined == serial and submit_many == solo submit, bitwise")
        return out["serial"]

    server = api.Server.from_artifact(FIXTURE, api.ServeConfig(mode="sharded"))
    check(server.backend == "fused" and server.device.type == "cuda",
          f"auto lane resolved to {server.backend} on {server.device}")
    predict.reset_launches()
    mean, var = server.submit(queries)  # the main path, counted
    launches = dict(predict.LAUNCHES)
    report["launches_main_path"] = launches
    print(f"[slice] main path (sharded, fused, q_max={server.policy.q_max}): launches {launches}")
    check(launches["posterior_predict_slots"] >= 1, "the main path never launched the slots kernel")
    vs_jax("sharded fused", mean, var, "routed")
    rmspe = float(np.sqrt(np.mean((mean[N_HALF:] - refz["y_train"]) ** 2)))
    report["rmspe_train_points"] = rmspe
    print(f"[slice] RMSPE on the 2,048 training points (information): {rmspe:.5f}")
    stream = [queries[i:i + 512] for i in range(0, 2 * N_HALF, 512)]
    golden(server, stream, "single-level fused")

    zipf = zipf_query_stream(grid, 4096, 6, alpha=1.1, seed=3)
    two = api.Server(fitted, api.ServeConfig(mode="sharded", router="two-level"))
    m2, v2 = two.submit(queries)
    vs_jax("two-level fused", m2, v2, "routed")
    two_out = golden(two, zipf, "two-level fused (zipf 1.1)")
    one = api.Server(fitted, api.ServeConfig(mode="sharded"))
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(two_out, [one.submit(q) for q in zipf], strict=True))
    check(same, "two-level != single-level on the zipf stream")
    print(f"[slice] two-level == single-level bitwise on the zipf stream "
          f"(spilled {two.stats()['spilled']} queries)")

    pallas = api.Server(fitted, api.ServeConfig(mode="sharded", backend="pallas"))
    predict.reset_launches()
    mp, vp = pallas.submit(queries)  # the "pallas" lane's path, counted
    launches_pallas = dict(predict.LAUNCHES)
    report["launches_pallas_path"] = launches_pallas
    print(f"[slice] pallas lane: launches {launches_pallas}")
    check(launches_pallas["posterior_predict"] >= 1, "the pallas lane never launched its kernel")
    vs_jax("sharded pallas", mp, vp, "routed")
    golden(pallas, stream, "single-level pallas")

    rep_m, rep_v = fitted.predict(queries)
    vs_jax("replicated", rep_m.cpu().numpy(), rep_v.cpu().numpy(), "replicated")

    # -- 5. training on the card ----------------------------------------------
    trained = train_slice(torch, dev, card, report, ds)
    rbf.reset_launches()
    ops.rbf_cross_cov(x_train, cache.z, cache.cov.log_lengthscale, cache.cov.log_variance)
    report["launches_rbf_path"] = dict(rbf.LAUNCHES)
    print(f"[kernels] ops.rbf_cross_cov (the one entry that reaches it, as in the JAX "
          f"package): launches {report['launches_rbf_path']}")
    check(report["launches_rbf_path"]["rbf_cross_cov"] == 1, "ops.rbf_cross_cov did not launch")

    # -- 6. times ------------------------------------------------------------
    # the launch floor: the least device time of any launch through the
    # same graph, beside every kernel row
    one = torch.zeros(1, device=dev)
    report["floor_ms"] = device_ms(torch, lambda: one.add_(1.0))
    print(f"[times] [{card}] launch floor (one-element add_): {report['floor_ms']:.6f} ms")
    rows = []
    big = np.random.default_rng(1).uniform(
        [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]], (65536, 2)
    ).astype(np.float32)
    big_table = routing.build_routing_table(grid, big)
    hx_big = torch.as_tensor(routing.make_halo_stacker(grid)(big_table.xq), device=dev)
    x_big = torch.as_tensor(big, device=dev)
    cell0 = [a[:1] for a in leaves]
    for label, hx, factors in (("main", hx_main, leaves), ("65,536 queries", hx_big, leaves),
                               ("one cell, 65,536 rows", x_big[None, None], cell0)):
        P, S, Q, d = hx.shape
        k_ms = device_ms(torch, lambda hx=hx, f=factors: predict.posterior_predict_slots(hx, *f))
        p_ms = device_ms(torch, lambda hx=hx, f=factors: ref.posterior_predict_slots_stacked(hx, *f))
        b_ms, b_by = bound(P, S, Q, 5, d)
        rows.append(("posterior_predict_slots", label, (P, S, Q), k_ms, p_ms, b_ms, b_by))
    x_main = hx_main[0].reshape(-1, 2).contiguous()
    one_cell = [a[0] for a in leaves]
    for label, x in (("main", x_main), ("65,536 queries", x_big)):
        k_ms = device_ms(torch, lambda x=x: predict.posterior_predict(x, *one_cell))
        p_ms = device_ms(torch, lambda x=x: ref.posterior_predict(x, *one_cell))
        b_ms, b_by = bound(1, 1, x.shape[0], 5, 2)
        rows.append(("posterior_predict", label, (1, 1, x.shape[0]), k_ms, p_ms, b_ms, b_by))
    for name, label, shape, k_ms, p_ms, b_ms, b_by in rows:
        print(f"[times] [{card}] {name} {label} (P, S, Q)={shape}: kernel {k_ms:.6f} ms, "
              f"plain {p_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), "
              f"floor {report['floor_ms']:.6f} ms")

    reqs = [
        np.random.default_rng(10 + i).uniform(
            [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]], (4096, 2)
        ).astype(np.float32)
        for i in range(200)
    ]
    report["stream"] = {}
    for pipeline in ("serial", "pipelined"):
        rec = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline=pipeline)).stream(reqs)
        lat = rec["latency_ms"]
        report["stream"][pipeline] = rec
        print(f"[times] [{card}] stream of 200 x 4,096-point requests, sharded fused "
              f"{pipeline}: p50 {lat['p50_ms']:.4f} ms, p95 {lat['p95_ms']:.4f} ms, "
              f"{rec['points_per_s']:.1f} points/s (q_max {rec['qmax_policy']['q_max']})")

    # where a request's time goes: host route, copy + device program (timed
    # to its end with a synchronize), copy back + scatter
    serial = api.Server(fitted, api.ServeConfig(mode="sharded"))
    serial.submit(reqs[0])
    route, submit, collect = serial.request_stages()
    spans = {"route": [], "submit_and_device": [], "collect": []}
    for q in reqs:
        t0 = time.perf_counter()
        routed = route(q)
        t1 = time.perf_counter()
        pending = submit(routed)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        collect(pending)
        t3 = time.perf_counter()
        for key, span in zip(spans, (t1 - t0, t2 - t1, t3 - t2), strict=True):
            spans[key].append(1e3 * span)
    report["stages_ms_p50"] = {k: float(np.median(v)) for k, v in spans.items()}
    print(f"[times] [{card}] 4,096-point request stages, p50 ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in report["stages_ms_p50"].items()))

    # the device's busy share of a window of serial requests: the union of
    # every kernel and copy torch.profiler saw on the card, over the window's
    # host time (which the profiler's own host cost lengthens a little)
    window = reqs[:20]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in window:
            serial.submit(q)
        window_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_name = device_busy(torch, prof, len(window))
    if busy_us > 0:
        report["device_busy_share"] = busy_us / window_us
        report["device_us_per_request"] = per_name
        print(f"[times] [{card}] device busy {busy_us / len(window):.1f} us of "
              f"{window_us / len(window):.1f} us per 4,096-point request "
              f"(share {report['device_busy_share']:.4f}); top device ops, us per request: "
              + ", ".join(f"{k} {v:.1f}" for k, v in report["device_us_per_request"].items()))
    else:
        report["device_busy_share"] = None
        print(f"[times] [{card}] device busy share: not measured "
              "(torch.profiler saw no device activity)")
    rows += training_times(torch, dev, card, cache, x_train, trained, ds, report)
    report["times"] = [
        {"name": n, "shape": list(s), "label": lab, "ms": k, "plain_ms": p,
         "bound_ms": b, "bound_by": by, "floor_ms": report["floor_ms"]}
        for n, lab, s, k, p, b, by in rows
    ]

    def main_row(name):
        return next(r for r in rows if r[0] == name and r[1] == "main")

    kernels = []
    for name, source, replaces, launch_key in (
        ("posterior_predict_slots", "predict.cu", "src/repro/kernels/predict.py:160",
         "launches_main_path"),
        ("posterior_predict", "predict.cu", "src/repro/kernels/predict.py:81",
         "launches_pallas_path"),
        ("svgp_projection", "svgp_proj.cu", "src/repro/kernels/svgp_proj.py:47",
         "launches_training_path"),
        ("rbf_cross_cov", "svgp_proj.cu", "src/repro/kernels/rbf.py:46", "launches_rbf_path"),
    ):
        _, _, _, k_ms, p_ms, b_ms, b_by = main_row(name)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces,
            "launches": report[launch_key][name],
            "max_abs_err": errors[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    report["kernels"] = kernels
    report["device"] = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full report as JSON here")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are not beside this file ({SRC})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    report: dict = {}
    try:
        run(report)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({"kernels": report["kernels"]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": report["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
