#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python chip_smoke.py [--out report.json] [--seed N]

Phases, each printed as it runs; any failure exits non-zero:

  1. card     the card's name and power limit (nvidia-smi); TF32 off.
  2. build    nvcc builds the kernels from src/repro_torch/kernels/csrc/
              (one nvcc per source, in parallel) and reports the registers
              and spills of every template instance.
  3. kernels  each CUDA kernel against its plain PyTorch version on the
              card. Prediction: at the serving path's shape (the paper's
              400-cell artifact, 9 halo slots, q_max 32, m 5; the
              single-block entry as the "pallas" lane's one launch over
              the 400 cells, bitwise the 400 per-cell launches) and at
              ragged/odd shapes (m in {1, 10, 17, 64}, Q not a multiple of
              128, d up to 4) and one cell's 65,536 rows, plus row
              independence. Training: the ELBO projection and K(X, Z) at
              the training step's shape (400 cells x 32 rows, m 5, on the
              artifact's factors), at the SPMD rank's (1 x 32, cell 0's
              factors), at every m in {1, 10, 17, 64} x B in
              {1, 33, 200} (P = 1, d up to 4) and at B = 65,536 with m = 64;
              then the gradient of the autograd Function against
              plain-version autograd; the Adam kernel bitwise the plain
              formula at the benchmark cells' (P, N) = (400, 44),
              (400, 464), (6,400, 44), t in {1, 2,500}, host and device
              counters, out of place and in place. Wide: every entry at m in {65, 128,
              256, 1,024, 2,048} and d in {5, 8} with ragged Q and B (the
              wide body), K(X, Z)'s knm bitwise the projection's, and the
              gradient at m = 128.
  4. serving  Server.from_artifact(the committed JAX-trained artifact,
              ServeConfig(mode="sharded")) on the card: answers against the
              JAX answers stored beside it, the kernel's launch count over
              the run, serial == pipelined and submit_many == solo submit
              bitwise; the two-level router on a zipf stream; the "pallas"
              lane (exactly one launch a request); the replicated lane
              against the JAX replicated answers.
  5. training api.fit at the paper's configuration (48,602 points, 20 x 20
              cells, m 5, delta 0.125, batch 32, lr 0.05, 2,500 steps) on
              the card: one projection, one Adam and one draws launch per
              step (the counters zeroed before the fit), in-sample RMSPE and
              boundary RMSD inside the band of the JAX package's seeds,
              save -> load -> serve bitwise, a ppermute fit, a warm refit,
              refit(scratch) == fit bitwise. The same 2,500-step fit through
              psvgp.fit(use_scan=True), the CUDA graph lane: bitwise the
              eager fit on every leaf, one projection launch a step, in the
              band; a 150-step warm refit through it bitwise the
              uninterrupted 2,650 steps and the eager refit; fit seconds,
              replayed step ms (device clock), capture ms. Then a wide model: api.fit at
              grid 4, m 128 (300 steps), one projection and one draws
              launch a step (the draws' streaming body: ~3,000 rows a cell),
              RMSPE within 15% of the same fit through the plain projection
              on the card (and the same pair at jitter 1e-3), served on the
              "fused" and "pallas" lanes within tolerance of backend="ref"
              on the card.
  6. times    the launch floor (a one-element add_ through the same CUDA
              graph); every kernel, its plain version, its bound and share
              at its path's shape and at a 65,536-row batch (the slots
              kernel also at one cell's 65,536 rows; the projection also
              at the SPMD rank's 1 x 32; the Adam kernel in place at the
              three cells' shapes; the draws kernel at the ne30 and ne120
              cells' (P, n_max) and at phase 5b's grid-4 partition's (its
              streaming body), bitwise its plain twin over 64 steps
              first, beside the plain composition), and at the wide
              shapes beside torch.bmm of the same m x m products; p50/p95
              latency and points/s of a stream of 4,096-point requests (the
              "pallas" lane's p50 too), the host stages of a request; ms per
              training step and fit seconds; the device's busy share of a
              request (either lane) and of a training step (torch.profiler),
              eager and replayed from its CUDA graph (host syncs, device ops
              and projection kernels per replay).
  7. lifecycle the paper's in-situ loop on the 2,500-step model: three
              warm refits of 150 steps on new slices (e3sm_like_field,
              seed 100 + t), each saved with save_step and swapped in from
              on_result of a live pipelined stream of 4,096-point
              requests — every answer bitwise that of a Server on the
              version live when it was routed, one projection launch per
              refit step and one slots launch per routed request, the
              stored steps serving bitwise their in-memory versions; then
              api.FrontDoor (64 clients x 16 requests of 1-64 points,
              bitwise solo submit; a shed lane), the HTTP front door
              (NetServer on 127.0.0.1:0: sync and async clients bitwise
              Server.submit, 413/400/400/429, a swap under wire load),
              gp/exact.py against the SVGP at Z = X, and a train-state
              resume bitwise the uninterrupted fit.
  8. entry    the port's entry points and example twins, each a subprocess
              on the card at full width: python -m repro_torch.api.smoke;
              python -m repro_torch.launch.serve --gp [--sharded] and
              python -m repro_torch.launch.serve_sharded (two-level router,
              zipf 1.1) on the committed 400-cell artifact with 50 requests
              of 4,096 points; examples/delta_sweep_torch.py at its defaults
              (the Fig. 4 sweep, both comm modes); examples/
              e3sm_insitu_torch.py --sim-steps 3. Any non-zero exit fails.
  9. mesh     the halo mesh: a 4 x 4 model (m 5, 150 steps) served by 16
              spawned ranks over gloo, all on the card, one cell each (the
              spawn phase 10 shares: each rank serves, then trains), 20
              uniform 4,096-point requests serial and pipelined: bitwise the
              one-process halo program, one slots launch a rank a request
              (wrapper and torch.profiler), cache bytes a rank total / 16;
              p50 per request and the exchange's share of it.
 10. spmd     SPMD training (psvgp_spmd.make_spmd_step): 16 spawned ranks
              over gloo on the one card, one cell each of a 4 x 4 grid on
              e3sm_like_field(1,944) (a cell's ~121 points, as in the
              paper's 20 x 20 run), the paper's width (m 5, B 32, delta
              0.125, lr 0.05), 300 steps: one projection launch a rank a
              step (wrapper; torch.profiler on rank 0), one hop a step
              where d != 0, the first 5 steps' received batches bitwise
              the one-process step's, the gathered state against the
              one-process eager psvgp.fit(comm="ppermute") from the same
              init (bitwise, or — where a library op rounds a cell
              differently alone, which a batch-invariance probe names —
              within 2e-4 after 2 steps and RMSPE / boundary RMSD within
              10%); step p50/p95 per rank, the exchange's and the loss
              all-reduce's shares, rank 0's device busy share, the
              one-process step's p50.
 11. analysis the analysis package's program passes on the card: python -m
              repro_torch.analysis --passes hlo,contracts,costs --device
              cuda (the mesh probes on one spawn of 16 ranks on the card);
              exit 0 with no finding, 1 kernel launch a request on every
              "pallas"/"fused" lane, 4 shifts and 1 all-gather a mesh
              request, per-rank peak CUDA memory at P = 4, 9, 16 within the
              mesh's device-exponent budget, and api.Server(group=) at
              m 128, built as the torchrun CLI builds it from an artifact
              (serve_sharded.build_server), answering every query with
              cache bytes total / P a rank and its resident CUDA bytes
              flat in P (the same budget); prints the host copies a request
              and the f64 ops the ref lanes run on the card.
 12. lm       the dense LM substrate at full width: qwen3-0.6b (28 layers,
              d_model 1,024, GQA 16/8, vocab 152,064 padded) initialised on
              the card from a torch.Generator seeded by --seed (596,180,992
              parameters, fp32), bf16 activations. Prefill(128) + 8 decode
              steps against the uncached forward, batch 4, in fp32 (max
              |d logits| <= 2e-4) and bf16 (<= 2 x the bf16 forward's gap
              to the fp32 one); launch.serve.generate (batch 4, prompt 128,
              32 tokens, greedy): prefill and decode ms and tok/s, peak
              CUDA memory, the host's share of a decode step
              (torch.profiler); 8 AdamW steps on one 8 x 256 batch (lr 1e-3)
              finite and falling; the same step twice, bitwise or not; 20
              steps of synthetic_token_batches through launch.train's step:
              ms p50/p95 on CUDA events, tok/s, peak memory, model FLOPs a
              token and their share of the dense bf16 peak, the device's
              busy share of a step (torch.profiler); then python -m
              repro_torch.launch.serve --arch, python -m
              repro_torch.launch.train --arch and examples/lm_train_torch.py
              --full as subprocesses at full width. The LM path runs no
              kernel of this repo (the JAX package's runs no Pallas kernel).
 13. moe-mla  MoE and MLA at the published width, random from --seed, the
              depth cut by dataclasses.replace(cfg, num_layers=n):
              deepseek-moe-16b at 4 of 28 layers (2,267,039,744
              parameters), qwen3-moe-30b-a3b served at 4 of 48
              (3,115,338,752) and trained at 2 (1,869,097,472),
              minicpm3-4b served at its full 62 (4,262,025,728) and
              trained at 12 (1,128,278,528). Each: prefill(128) + 8
              decode steps against the uncached forward, batch 4, in fp32
              (<= 2e-4 x max(1, max|logits|)) and bf16 (<= 2 x the bf16
              forward's gap to fp32), MoE at capacity E/K; the prefill's
              dropped share at the published capacity 1.25;
              launch.serve.generate (4 x 128, 16 tokens): prefill and
              decode tok/s, the decode step's host share, peak memory;
              8 AdamW steps on one 8 x 256 batch falling (aux > 0 with
              MoE; the same MoE step twice compared), 5 timed steps on
              CUDA events, tok/s, peak memory. Then one deepseek-width MoE
              layer on 2 spawned gloo ranks, 32 experts each, against the
              local path (<= 2e-5 x max(1, max|out|), aux equal, 1
              all-reduce a forward), and launch.serve --arch and
              launch.train --arch of the three and of phase 14's and
              phase 15's two at --smoke, all at once.
 14. xlstm-vlm xLSTM and the vision stub at the published width, random
              from --seed: xlstm-350m uncut (24 layers, 5 mLSTM : 1
              sLSTM, 590,423,200 parameters) and internvl2-76b served at 4
              of 80 layers (5,617,295,360; 256 seeded patches of 3,200
              prepended, a cache of 256 + 128 + 16 positions). Each:
              prefill(128) + 8 decode steps against the uncached forward,
              batch 4, fp32 and bf16 (phase 13's bounds);
              launch.serve.generate (4 x 128, 16 tokens): tok/s, the
              decode step's host share, peak memory. xlstm-350m: 8 AdamW
              steps on one 8 x 256 batch falling (remat), 5 timed steps on
              CUDA events, peak memory. internvl2-76b is not trained at
              its published width here (~92 GB at one layer).
 15. rglru-encdec RG-LRU and the encoder-decoder at the published width,
              random from --seed, the card holding under 1 GiB at the
              start: recurrentgemma-2b served at its 26 layers
              (3,549,795,840 parameters) and trained at 4
              (1,659,432,960; the functional AdamW would need ~106 GB at
              26); whisper-base uncut (100,167,680; 1,500 seeded stub
              frames x 512 through the encoder at the prefill, none in
              decode). Each: phase 14's cache gates, serve numbers, 8
              AdamW steps on one 8 x 256 batch falling (whisper's batches
              with their frames), 5 timed steps on CUDA events, peak
              memory.
 16. dryrun   the dry-run (repro_torch.launch.dryrun: the port's steps on
              fake tensors, every leaf a DTensor shard over a fake process
              group of 256 or 512 ranks, on the host): the JAX package's
              tests/test_dryrun.py cases (qwen3-0.6b train_4k,
              recurrentgemma-2b long_500k, whisper-base decode_32k,
              deepseek-moe-16b prefill_32k on 2 x 16 x 16, and --psvgp)
              as concurrent subprocesses, each record held to that test's
              asserts; then the tracer's accounting against phase 12's
              steps on the card: qwen3-0.6b's 8 x 256 train step and batch-4
              decode step traced on a 1 x 1 mesh, their FLOPs equal to
              FlopCounterMode on the real step and their argument bytes to
              the real inputs', exactly, the trace's peak within
              P16_PEAK_BAND of the step's own CUDA peak, and phase 12's
              measured step no faster than the roofline's largest term /
              1.05; and rank 0's PSVGP step of the 16 x 16 grid on the
              card under the 256-rank group: one projection launch, the
              CPU trace's collectives; then the pinned cut cells
              (repro_torch/launch/pins.py: qwen3-0.6b prefill_32k and
              train_4k at 1 layer, minicpm3-4b prefill_32k at 1 layer,
              xlstm-350m at one period and 128 positions, the PSVGP gather
              step at 4 x 4) traced on this host's torch and held to the
              pins the CPU tests hold (their collective bytes reckoned from
              the shapes where they follow from them): the two torch
              versions agree.

Each phase's seconds are printed as "[phases] <phase>: <s> s".

Tolerances (``repro_torch.kernels.ref.tolerance_ratio``): float32 rounding
scaled by the magnitude of the terms each output sums — prediction: per
row |d mean| <= 1e-5 max(1, sum_j |k_j c_j|), |d var| <= 1e-5 max(1,
||Wk||^2 + ||Uk||^2) (fitted c_j cancel); projection: |d knm| <= 1e-5
sigma^2, |d lk_t| <= 1e-5 max(1, sum_j |k_j W_ij|), |d q_diag| <= 1e-5
max(1, q_diag); gradients: |d g| <= 1e-5 max(1, max |g|) per leaf.

The last three lines of standard output are the kernel table (one JSON
object), the card's name and power limit, and the device record (one
JSON object). Exits non-zero without printing
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
            plain = re.search(r"([a-z_]+_kernel)EP", entry.group(1))
            name = (f"{kernel.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', kernel.group(2) + 'E'))}>"
                    if kernel else f"{plain.group(1)}<>" if plain else entry.group(1))
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
    once; knm (and lk_t, q_diag) written once. W = Lmm^{-1} is lower
    triangular (the kernel's precondition), so the function needs its
    m(m+1)/2 entries on and below the diagonal. Operations per row: scale x
    (d); per inducing point the difference, square and sum (3d), -0.5 r2,
    exp, * sigma^2 (3); then lk_t = knm W^T over W's triangle (m(m+1)) and
    q_diag (2m)."""
    rows = P * B
    nbytes = 4 * (rows * d + P * (m * d + d + 1 + (m * (m + 1) // 2 if project else 0))
                  + rows * m * (2 if project else 1) + (rows if project else 0))
    flops = rows * (d + m * (3 * d + 3) + ((m * (m + 1) + 2 * m) if project else 0))
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


# m past the prediction's narrow body (m > 64; the projection's wide body
# starts at m = 17, which the ragged cases above reach, and the paper's
# Fig. 4 trains at m = 20 on 400 cells of 32) and d past 4, as the JAX
# package takes them: (P, S, Q, m, d) for the slots entry, (P, Q, m, d) for
# the single-block one, (P, B, m, d) for the projection and K(X, Z); ragged
# Q and B against the wide body's row tiles, 16-deep chunks and 128-column
# tiles
WIDE_SLOTS = ((3, 9, 77, 65, 5), (2, 4, 133, 128, 8), (2, 9, 50, 256, 2),
              (1, 3, 97, 1024, 5), (4, 9, 33, 5, 8), (1, 1, 45, 2048, 2))
WIDE_SINGLE = ((5, 123, 65, 8), (3, 301, 128, 5), (2, 77, 256, 8), (1, 519, 1024, 2),
               (6, 45, 7, 5))
WIDE_PROJ = ((3, 45, 65, 5), (2, 333, 128, 8), (1, 100, 256, 5), (1, 77, 1024, 8),
             (7, 33, 5, 8), (1, 40, 2048, 2), (400, 32, 20, 2),
             # K(X, Z) past one wave (its z/l staged), m % 4 == 0 and not
             (40, 1024, 32, 2), (30, 1500, 25, 3))


def check_wide_predict(torch, random_case, t, rng, compare) -> None:
    """Phase 3: both prediction entries against their plain versions at
    every wide shape (m in {65, 128, 256, 1,024, 2,048}, d in {5, 8})."""
    from repro_torch.kernels import predict, ref

    for P, S, Q, m, d in WIDE_SLOTS:
        args = random_case(P, m, d)
        hx = t(rng.uniform(0, 2, (P, S, Q, d)))
        compare(f"slots P={P} S={S} Q={Q} m={m} d={d} (wide)",
                predict.posterior_predict_slots(hx, *args),
                ref.posterior_predict_slots_stacked(hx, *args),
                ref.posterior_predict_scales(hx, *(a[:, None] for a in args)))
    for P, Q, m, d in WIDE_SINGLE:
        args = random_case(P, m, d)
        x = t(rng.uniform(0, 2, (P, Q, d)))
        compare(f"single-block P={P} Q={Q} m={m} d={d} (wide)", predict.posterior_predict(x, *args),
                ref.posterior_predict(x, *args), ref.posterior_predict_scales(x, *args))


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

    def random_case(B, m, d, P=1):
        z = t(rng.uniform(0, 2, (P, m, d)))
        log_l = t(np.log(rng.uniform(0.3, 1.5, (P, d))))
        log_v = t(rng.normal(0, 0.5, P))
        w = t(np.tril(rng.normal(0, 1, (P, m, m))) / np.sqrt(m))
        return t(rng.uniform(0, 2, (P, B, d))), z, log_l, log_v, w

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
        check(torch.equal(knm, got[0]), f"{name}: K(X, Z)'s knm differs from the projection's")
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
    errors["adam_update"] = check_adam_kernel(torch, dev)
    compare("SPMD rank's step P=1 B=32 m=5 d=2 (artifact cell 0)",
            tuple(a[:1] for a in main_args))
    for i, (m, B) in enumerate((m, B) for m in (1, 10, 17, 64) for B in (1, 33, 200)):
        d = 1 + i % 4
        compare(f"P=1 B={B} m={m} d={d}", random_case(B, m, d))
    compare("P=1 B=65536 m=64 d=2", random_case(65536, 64, 2))
    for P, B, m, d in WIDE_PROJ:
        compare(f"P={P} B={B} m={m} d={d} (wide)", random_case(B, m, d, P))

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

    # the same at m = 128 (the wide body's forward), on the Cholesky factor
    # of an RBF Kmm + 1e-3 I of seeded inducing points
    x, z, log_l, log_v, _ = random_case(40, 128, 2, P=6)
    kmm = ref.rbf_cross_cov(z, z, log_l, log_v).double()
    eye = torch.eye(128, device=dev, dtype=torch.float64)
    lmm = torch.linalg.cholesky(kmm + 1e-3 * eye).float()
    args = [x, z, log_l, log_v, lmm]
    cot = [t(rng.normal(size=s)) for s in ((6, 40, 128), (6, 40, 128), (6, 40))]
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = svgp_proj.LAUNCHES["svgp_projection"]
    got = torch.autograd.grad(ops.svgp_projection(*leaves), leaves, cot)
    check(svgp_proj.LAUNCHES["svgp_projection"] == before + 1,
          "the Function at m = 128 launched the kernel other than once")
    plain = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ops.svgp_projection_ref(*plain), plain, cot)
    worst = 0.0
    for name, g, w in zip(("x", "z", "log_l", "log_v", "lmm"), got, want, strict=True):
        ratio = float((g - w).abs().max()) / (1e-5 * max(1.0, float(w.abs().max())))
        worst = max(worst, ratio)
        check(bool(torch.isfinite(g).all()) and ratio <= 1,
              f"gradient wrt {name} disagrees at m = 128")
    print(f"[kernels] gradient of the projection Function vs plain autograd "
          f"(P=6 B=40 m=128): worst tol ratio {worst:.3f}; one launch")


# the Adam update's (label, P, m) at d = 2: the benchmark cells' (P, N) =
# (400, 44), (400, 464) and (6,400, 44), N = m + m^2 + 2m + 4 floats a cell
ADAM_SHAPES = (("main", 400, 5), ("m 20", 400, 20), ("6,400 cells", 6400, 5))
ADAM_LR = 0.05  # the paper's E3SM operating point


def adam_case(torch, dev, P: int, m: int, step, seed: int):
    """Seeded params, grads and Adam state of PSVGP's leaf shapes (d = 2)
    on the card (nu >= 0, as a second moment is)."""
    from repro_torch.core.svgp import SVGPParams
    from repro_torch.gp.covariances import CovarianceParams
    from repro_torch.optim import AdamState, tree_map

    gen = torch.Generator(device=dev).manual_seed(seed)

    def tree(scale):
        def r(*shape):
            return scale * torch.randn(shape, generator=gen, device=dev)

        return SVGPParams(m_star=r(P, m), s_tril=r(P, m, m), z=r(P, m, 2),
                          cov=CovarianceParams(r(P, 2), r(P)), log_beta=r(P))

    params, grads, mu = tree(1.0), tree(0.3), tree(0.1)
    return params, grads, AdamState(step, mu, tree_map(torch.abs, tree(0.05)))


def adam_bound(elems: int) -> tuple[float, str]:
    """Least time (ms) for one Adam launch over ``elems`` floats: p, g, m
    and v read once, p, mu and nu written once (28 B an element); 14
    operations an element."""
    return _bound(28 * elems, 14 * elems)


def check_adam_kernel(torch, dev) -> float:
    """Phase 3, training half: the Adam kernel (``optim.adam_update`` on
    CUDA) against the plain formula on the same card inputs at
    :data:`ADAM_SHAPES`, at steps 1 and 2,500, the counter on the host and
    on the device, out of place and (device counter) in place: every leaf
    and the counter bitwise, one launch a call. Returns the largest
    difference (0)."""
    from repro_torch.kernels import adam
    from repro_torch.optim import adam_update, tree_leaves
    from repro_torch.optim.adam import plain_adam_update

    worst = 0.0
    for label, P, m in ADAM_SHAPES:
        for t in (1, 2500):
            for on_device in (False, True):
                step = torch.tensor(t - 1, device=dev) if on_device else t - 1
                params, grads, state = adam_case(torch, dev, P, m, step, seed=P + m + t)
                want = plain_adam_update(params, grads, state, lr=ADAM_LR)
                before = adam.LAUNCHES["adam_update"]
                forms = [("out of place", adam_update(params, grads, state, lr=ADAM_LR))]
                if on_device:  # the destination is the input itself
                    forms.append(("in place", adam_update(params, grads, state, lr=ADAM_LR,
                                                          out=(params, state))))
                check(adam.LAUNCHES["adam_update"] == before + len(forms),
                      f"adam_update {label}: other than one launch a call")
                for form, got in forms:
                    pairs = list(zip(tree_leaves((got[0], got[1].mu, got[1].nu)),
                                     tree_leaves((want[0], want[1].mu, want[1].nu)), strict=True))
                    worst = max([worst] + [float((g - w).abs().max()) for g, w in pairs])
                    where = (f"adam_update {label} t={t} "
                             f"{'device' if on_device else 'host'} counter {form}")
                    check(all(torch.equal(g, w) for g, w in pairs),
                          f"{where}: not bitwise the plain formula")
                    check(int(got[1].step) == t, f"{where}: counter {int(got[1].step)} != {t}")
        n = sum(x.numel() for x in tree_leaves(params)) // P
        print(f"[kernels] adam_update {label} (P, N)=({P}, {n}): bitwise the plain formula at "
              "t in {1, 2,500}, host and device counters, out of place and in place")
    return worst


# the draws kernel's (label, grid side, n_max) at B = 32: the storage of the
# benchmark's ne30 and ne120 mixes (bench/field.py partitioned as the
# benchmark partitions it: (400, 224) and (6,400, 240)), and phase 5b's
# grid-4 partition of the paper's field (n_max None: read from that
# partition, ~3,000 rows, the streaming body)
DRAWS_SHAPES = (("main", 20, 224), ("6,400 cells", 80, 240), ("grid 4", 4, None))
DRAWS_BATCH = 32


def draws_case(torch, dev, g: int, n_max: int, seed: int):
    """A g x g grid's slot distribution (delta 0.125) and (P, n_max) mask on
    the card: cells of n_max / 2 .. n_max points, a tenth (at least three)
    under the batch, two of them empty."""
    from repro_torch.core import partition, sampler
    from repro_torch.core.neighbors import neighbor_table

    rng = np.random.default_rng(seed)
    P = g * g
    counts = rng.integers(n_max // 2, n_max + 1, P)
    counts[0] = n_max
    short = rng.choice(np.arange(1, P), max(3, P // 10), replace=False)
    counts[short] = rng.integers(1, DRAWS_BATCH, len(short))
    counts[short[:2]] = 0
    mask = torch.as_tensor((np.arange(n_max)[None] < counts[:, None]).astype(np.float32),
                           device=dev)
    edges = np.linspace(0.0, 1.0, g + 1)
    tbl = torch.as_tensor(neighbor_table(partition.PartitionGrid(g, g, edges, edges, False)),
                          device=dev)
    return sampler.slot_distribution(torch.as_tensor(counts, device=dev), tbl, 0.125), mask


def draws_bound(P: int, n_max: int, batch: int) -> tuple[float, str]:
    """Least time (ms) for one draws launch: the source rows' masks, probs
    and the neighbour table read once, kprime and idx written once; the
    scores' 4 float operations an element (the integer mixing not
    counted)."""
    return _bound(4 * P * n_max + 12 * 5 * P + 8 * P * (batch + 1), 4 * P * n_max)


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
    from repro_torch.kernels import adam, draws, predict, rbf, svgp_proj
    from repro_torch.kernels import launches as kernel_launches

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

    kernel_launches.reset()
    psvgp.train_step = timed_step
    try:
        t0 = time.perf_counter()
        fitted = api.fit(cfg, ds)
        fit_wall = time.perf_counter() - t0
    finally:
        psvgp.train_step = inner
    launches = {**svgp_proj.LAUNCHES, **rbf.LAUNCHES, **predict.LAUNCHES, **adam.LAUNCHES,
                **draws.LAUNCHES}
    report["launches_training_path"] = launches
    print(f"[training] api.fit (grid 20, m 5, delta 0.125, B 32, lr 0.05, 2,500 steps) on "
          f"{fitted.device}: launches {launches}")
    check(fitted.device.type == "cuda" and fitted.static.cfg.svgp.use_pallas,
          "api.fit did not train on the kernel lane of the card")
    check(launches["svgp_projection"] == cfg.train_iters,
          f"projection launches {launches['svgp_projection']} != {cfg.train_iters} steps")
    check(launches["adam_update"] == cfg.train_iters,
          f"Adam kernel launches {launches['adam_update']} != {cfg.train_iters} steps")
    check(launches["minibatch_draws"] == cfg.train_iters,
          f"draws kernel launches {launches['minibatch_draws']} != {cfg.train_iters} steps")
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


def wide_slice(torch, dev, card: str, report: dict, ds):
    """Phase 5b: a model past the narrow kernels' m on the card. ``api.fit``
    at grid 4, m 128 (300 steps): one projection launch per step (the wide
    body), its RMSPE within 15% of its witness, the same fit (config, seed,
    draws) with the ELBO's projection in its plain PyTorch form on the card;
    the same pair at jitter 1e-3, where Kmm of 128 inducing points is better
    conditioned than at the default 1e-5 and 300 steps go further. Then
    ``Server`` over the first fit on the "fused" and "pallas" lanes against
    ``backend="ref"`` on the card, each kernel lane launching its kernel
    exactly once per request."""
    from repro_torch import api
    from repro_torch.core import partition, psvgp
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.kernels import draws, predict, ref, svgp_proj
    from repro_torch.kernels import launches as kernel_launches

    def plain_twin(fitted):
        """``fitted``'s training run again with the plain projection."""
        static = fitted.static
        static = static._replace(cfg=static.cfg._replace(
            svgp=static.cfg.svgp._replace(use_pallas=False)))
        pdata = partition.partition_data(ds.x, ds.y, fitted.grid, device=dev)
        state = psvgp.init(fitted.config.seed, static.cfg, pdata)
        state = psvgp.fit(static, state, pdata, fitted.config.train_iters)
        return api.FittedPSVGP(fitted.config, fitted.grid, static, state)

    report["wide_fit"] = {}
    wide = None
    for jitter in (1e-5, 1e-3):
        cfg = api.FitConfig(grid=4, m=128, delta=0.125, train_iters=300, batch_size=32,
                            learning_rate=0.05, seed=0, jitter=jitter)
        kernel_launches.reset()
        t0 = time.perf_counter()
        fitted = api.fit(cfg, ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = svgp_proj.LAUNCHES["svgp_projection"]
        check(launches == cfg.train_iters,
              f"wide fit: projection launches {launches} != {cfg.train_iters} steps")
        n_draws = draws.LAUNCHES["minibatch_draws"]
        check(n_draws == cfg.train_iters,
              f"wide fit: draws kernel launches {n_draws} != {cfg.train_iters} steps")
        label = f"grid 4, m 128, jitter {jitter:g}, 300 steps"
        rmspe, rmsd = train_quality(torch, fitted, ds, f"{label}, kernel")
        kernel_launches.reset()
        twin = plain_twin(fitted)
        check(svgp_proj.LAUNCHES["svgp_projection"] == 0, "the plain twin launched the kernel")
        rmspe_p, rmsd_p = train_quality(torch, twin, ds, f"{label}, plain projection")
        report["wide_fit"][f"jitter {jitter:g}"] = {
            "seconds": wall, "projection_launches": launches, "draws_launches": n_draws,
            "rmspe": rmspe, "boundary_rmsd": rmsd, "plain_rmspe": rmspe_p,
            "plain_boundary_rmsd": rmsd_p}
        check(abs(rmspe - rmspe_p) <= 0.15 * rmspe_p,
              f"wide fit ({label}): RMSPE {rmspe:.5f} not within 15% of the plain "
              f"projection's {rmspe_p:.5f}")
        print(f"[wide] [{card}] api.fit {label}: {wall:.3f} s, {launches} projection and "
              f"{n_draws} draws launches; "
              f"RMSPE {rmspe:.5f} vs {rmspe_p:.5f} through the plain projection")
        wide = wide or fitted
    lo = [wide.grid.x_edges[0], wide.grid.y_edges[0]]
    hi = [wide.grid.x_edges[-1], wide.grid.y_edges[-1]]
    q = np.random.default_rng(8).uniform(lo, hi, (4096, 2)).astype(np.float32)
    want = api.Server(wide, api.ServeConfig(mode="sharded", backend="ref")).submit(q)
    mean_scale, var_scale = blend_error_scales(wide.cache, wide.grid, q)
    for lane, entry in (("fused", "posterior_predict_slots"), ("pallas", "posterior_predict")):
        server = api.Server(wide, api.ServeConfig(mode="sharded", backend=lane))
        kernel_launches.reset()
        got = server.submit(q)
        n = predict.LAUNCHES[entry]
        check(n == 1, f"wide {lane} lane: {n} launches of {entry} in one request, not 1")
        rm = ref.tolerance_ratio(torch.as_tensor(got[0]), torch.as_tensor(want[0]),
                                 mean_scale.cpu())
        rv = ref.tolerance_ratio(torch.as_tensor(got[1]), torch.as_tensor(want[1]),
                                 var_scale.cpu())
        check(np.isfinite(got[0]).all() and np.isfinite(got[1]).all(),
              f"wide {lane} lane: non-finite answers")
        check(rm <= 1 and rv <= 1, f"wide {lane} lane disagrees with backend='ref' on the card")
        report["wide_fit"][f"{lane}_vs_ref"] = [rm, rv]
        print(f"[wide] [{card}] Server on the m 128 model, {lane} lane vs ref: tol ratio mean "
              f"{rm:.3f} var {rv:.3f}; 1 launch of {entry} per request")
    return wide


def _pct(ms: list) -> dict:
    a = np.asarray(ms, np.float64)
    return {f"p{q}_ms": float(np.percentile(a, q)) for q in (50, 95, 99)}


def _equal(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _uniform(grid, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]], (n, 2)
    ).astype(np.float32)


def insitu_loop(torch, card: str, report: dict, trained, store: str) -> tuple:
    """Phase 7a: the paper's in-situ loop on the card. From the 2,500-step
    fit, served sharded + pipelined on the fused lane, three steps of: a
    new slice e3sm_like_field(48,602, seed 100 + t), a warm refit of 150
    steps, ``save_step(store, t)``, and ``Server.swap`` from ``on_result``
    of a live stream of 4,096-point requests. Every answer is bitwise that
    of a Server on the version live when the request was routed (the
    pipelined loop routes request i + 1 before ``on_result(i)``, so a swap
    there answers i + 2 onward by the new model); one projection launch
    per refit step and one slots launch per routed request."""
    from repro_torch import api
    from repro_torch.core import metrics, partition
    from repro_torch.data.spatial import e3sm_like_field
    from repro_torch.kernels import predict, svgp_proj
    from repro_torch.kernels import launches as kernel_launches

    server = api.Server(trained, api.ServeConfig(mode="sharded", pipeline="pipelined"))
    check(server.backend == "fused", f"the in-situ server resolved to {server.backend}")
    versions = [trained]
    refs = [api.Server(trained, api.ServeConfig(mode="sharded"))]
    trained.save_step(store, 0)
    n_req, at = 32, 10  # a swap from on_result(at) answers at + 2 onward by the new model
    steps = []
    for t in (1, 2, 3):
        data = e3sm_like_field(n=48602, seed=100 + t)
        kernel_launches.reset()
        t0 = time.perf_counter()
        new = api.refit(versions[-1], data, api.RefitConfig(train_iters=150))
        torch.cuda.synchronize()
        refit_s = time.perf_counter() - t0
        proj = svgp_proj.LAUNCHES["svgp_projection"]
        check(proj == 150, f"step {t}: {proj} projection launches in a 150-step refit")
        new.save_step(store, t)

        def rmspe(model):
            pdata = partition.partition_data(data.x, data.y, model.grid, device=model.device)
            return float(metrics.rmspe(model.static, model.state, pdata, cache=model.cache))

        r_new, r_old = rmspe(new), rmspe(versions[-1])
        check(np.isfinite(r_new) and r_new < r_old,
              f"step {t}: refit RMSPE {r_new:.5f} on its slice not below version "
              f"{t - 1}'s {r_old:.5f}")
        batches = [_uniform(new.grid, 4096, 1000 * t + i) for i in range(n_req)]
        calm = server.stream(batches)  # the previous version, no swap
        outs, rec = {}, {}

        def on_result(i, out, new=new, t=t):
            outs[i] = out
            if i == at:
                rec.update(server.swap(new, version=t))

        server.reset_stats()
        kernel_launches.reset()
        swapped = server.stream(batches, warm=False, on_result=on_result)
        launches = dict(predict.LAUNCHES)
        routed = server.stats()["requests"]
        check(len(outs) == n_req, f"step {t}: {n_req - len(outs)} requests failed")
        check(launches["posterior_predict_slots"] == routed and launches["posterior_predict"] == 0,
              f"step {t}: slots launches {launches} for {routed} routed requests")
        versions.append(new)
        refs.append(api.Server(new, api.ServeConfig(mode="sharded")))
        bad = [i for i, q in enumerate(batches)
               if not _equal(outs[i], refs[t if i >= at + 2 else t - 1].submit(q))]
        check(not bad, f"step {t}: answers of requests {bad} differ from the version live "
              "when they were routed")
        step = {"refit_s": refit_s, "projection_launches": proj, "build_s": rec["build_s"],
                "rmspe": r_new, "rmspe_previous_version": r_old, "slots_launches": launches,
                "routed": routed, "stream_no_swap_ms": calm["latency_ms"],
                "stream_swap_ms": swapped["latency_ms"]}
        steps.append(step)
        print(f"[lifecycle] [{card}] step {t}: refit 150 steps {refit_s:.4f} s (to a "
              f"synchronize), {proj} projection launches; RMSPE on its slice {r_new:.5f} "
              f"(version {t - 1}: {r_old:.5f}); swap build_s {rec['build_s']:.6f} s; stream of "
              f"{n_req} x 4,096 points p50/p95 {calm['latency_ms']['p50_ms']:.4f}/"
              f"{calm['latency_ms']['p95_ms']:.4f} ms without a swap, "
              f"{swapped['latency_ms']['p50_ms']:.4f}/{swapped['latency_ms']['p95_ms']:.4f} ms "
              f"with one; {launches['posterior_predict_slots']} slots launches for {routed} "
              "routed requests (the swap's probe included); every answer bitwise its version's")
    lc = server.lifecycle()
    check(lc["swaps"] == 3 and len(lc["versions"]) == 4 and lc["active_version"] == 3,
          f"lifecycle {lc}")
    check(api.peek_steps(store) == [0, 1, 2, 3], f"peek_steps {api.peek_steps(store)}")
    q = _uniform(versions[-1].grid, 4096, 77)
    for t, ref_server in enumerate(refs):
        loaded = api.Server.from_artifact(store, api.ServeConfig(mode="sharded"), step=t)
        check(_equal(loaded.submit(q), ref_server.submit(q)),
              f"FittedPSVGP.load(store, step={t}) serves other answers than version {t}")
    print(f"[lifecycle] lifecycle(): {lc['swaps']} swaps, versions "
          f"{[v['version'] for v in lc['versions']]}; peek_steps {api.peek_steps(store)}; "
          "every stored step serves bitwise its in-memory version")
    report["insitu"] = {"steps": steps, "lifecycle": lc}
    return server, refs


def frontdoor_phase(card: str, report: dict, server) -> None:
    """Phase 7b: ``FrontDoor`` over the sharded fused server — 64 client
    coroutines x 16 requests of 1-64 uniform points under the default
    config, each answer bitwise that request served alone; then a shed
    lane (queue_depth 4) that must shed, leave no future pending and
    close."""
    import asyncio

    from repro_torch import api
    from repro_torch.kernels import predict
    from repro_torch.kernels import launches as kernel_launches

    grid = server.fitted.grid
    rng = np.random.default_rng(500)
    work = [[_uniform(grid, int(rng.integers(1, 65)), 10_000 + 16 * c + k) for k in range(16)]
            for c in range(64)]

    async def drive(cfg):
        fd = api.FrontDoor(server, cfg)
        got = {}

        async def client(c):
            for k, q in enumerate(work[c]):
                try:
                    got[c, k] = await fd.submit(q)
                except api.RequestRejected as err:
                    got[c, k] = err

        try:
            await asyncio.gather(*(client(c) for c in range(64)))
        finally:
            await asyncio.wait_for(fd.close(), 120)
        return got, fd.report()

    kernel_launches.reset()
    got, rep = asyncio.run(drive(api.FrontDoorConfig()))
    launches = dict(predict.LAUNCHES)
    check(launches["posterior_predict_slots"] == rep["batches"]["count"],
          f"FrontDoor: {launches} for {rep['batches']['count']} batches")
    failed = [ck for ck, out in got.items() if isinstance(out, BaseException)]
    check(len(got) == 1024 and not failed and rep["requests"]["completed"] == 1024,
          f"FrontDoor: {len(failed)} requests failed, {rep['requests']}")
    bad = [(c, k) for (c, k), out in got.items() if not _equal(out, server.submit(work[c][k]))]
    check(not bad, f"FrontDoor: answers of {bad[:8]} differ from solo Server.submit")
    b = rep["batches"]
    lat = rep["latency_ms"]
    report["frontdoor"] = rep
    print(f"[frontdoor] [{card}] 64 clients x 16 requests of 1-64 points (default config): "
          f"bitwise == solo submit; end-to-end p50/p95/p99 {lat['p50_ms']:.4f}/"
          f"{lat['p95_ms']:.4f}/{lat['p99_ms']:.4f} ms; {b['count']} batches, "
          f"{b['rows_per_batch_mean']:.1f} rows and {b['requests_per_batch_mean']:.2f} "
          f"requests per batch; recompiles {rep['recompiles']}; slots launches {launches}")
    got, rep = asyncio.run(drive(api.FrontDoorConfig(queue_depth=4, admission="shed")))
    shed = sum(isinstance(v, api.RequestRejected) for v in got.values())
    served = [(c, k) for (c, k), v in got.items() if not isinstance(v, BaseException)]
    check(shed >= 1 and len(got) == 1024 and shed + len(served) == 1024,
          f"shed lane: {shed} shed, {len(served)} served of {len(got)}")
    check(all(_equal(got[ck], server.submit(work[ck[0]][ck[1]])) for ck in served[:64]),
          "shed lane: a served answer differs from solo Server.submit")
    report["frontdoor_shed"] = rep["requests"]
    print(f"[frontdoor] shed lane (queue_depth 4): {shed} shed, {len(served)} served, no "
          "future pending, close() returned")


def _net_thread(net_server_cls, server, net, frontdoor=None):
    """Start a NetServer on its own event loop in a thread; returns (the
    NetServer, a stop function that closes it and joins the thread)."""
    import asyncio
    import threading

    box, started = {}, threading.Event()

    def run():
        async def main():
            box["loop"] = asyncio.get_running_loop()
            box["stop"] = asyncio.Event()
            try:
                async with net_server_cls(server, net, frontdoor) as ns:
                    box["ns"] = ns
                    started.set()
                    await box["stop"].wait()
            finally:
                started.set()

        asyncio.run(main())

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    started.wait(60)
    check("ns" in box, "the NetServer did not start")

    def stop():
        box["loop"].call_soon_threadsafe(box["stop"].set)
        thread.join(60)
        check(not thread.is_alive(), "the NetServer did not stop")

    return box["ns"], stop


def http_phase(card: str, report: dict, server, store: str) -> None:
    """Phase 7c: the HTTP front door on 127.0.0.1:0 over the same server —
    the sync client, 16 async clients x 16 requests of 64 points on
    keepalive connections (bitwise ``Server.submit``), the typed statuses
    (413, 400, 400, 429 with a retry hint) and a swap under wire load."""
    import asyncio
    import http.client

    from repro_torch import api
    from repro_torch.net import protocol
    from repro_torch.net.client import (
        AsyncNetClient,
        NetClient,
        RetryPolicy,
        ServerError,
        predict_points,
    )
    from repro_torch.net.server import SHED_RETRY_MS, NetServer

    grid = server.fitted.grid
    ns, stop = _net_thread(NetServer, server, api.NetConfig(port=0))
    try:
        with NetClient("127.0.0.1", ns.port) as c:
            for i in range(8):
                q = _uniform(grid, 1 + 9 * i, 20_000 + i)
                check(_equal(predict_points(c.predict(q)), server.submit(q)),
                      "NetClient answer differs from Server.submit")
            try:
                c.predict(np.zeros((65, 2), np.float32))
                check(False, "a 65-point request was not refused")
            except ServerError as err:
                check(err.status == 413 and err.frame.code == "oversized",
                      f"oversized request: {err.status} {err.frame.code}")
        for body in (b"\x00not msgpack", protocol.ErrorFrame("", "internal", "x").encode()):
            conn = http.client.HTTPConnection("127.0.0.1", ns.port, timeout=60)
            try:
                conn.request("POST", "/predict", body=body)
                resp = conn.getresponse()
                status, frame = resp.status, protocol.decode_frame(resp.read())
            finally:
                conn.close()
            check(status == 400 and frame.code == "bad-request",
                  f"malformed body {body[:8]!r}: {status} {frame.code}")
        work = [[_uniform(grid, 64, 30_000 + 16 * c + k) for k in range(16)] for c in range(16)]

        async def wire():
            lat = []

            async def client(c):
                out = []
                async with AsyncNetClient("127.0.0.1", ns.port) as cl:
                    for q in work[c]:
                        t0 = time.perf_counter()
                        out.append(await cl.predict(q))
                        lat.append(1e3 * (time.perf_counter() - t0))
                return out

            return await asyncio.gather(*(client(c) for c in range(16))), lat

        got, lat = asyncio.run(wire())
        bad = [(c, k) for c in range(16) for k in range(16)
               if not _equal(predict_points(got[c][k]), server.submit(work[c][k]))]
        check(not bad, f"wire answers of {bad[:8]} differ from Server.submit")
        wire_pct = _pct(lat)
        timing = np.asarray([r.timing_ms for out in got for r in out])
        report["http"] = {"latency_ms": wire_pct,
                          "server_timing_ms_p50": dict(zip(("decode_ms", "engine_ms", "total_ms"),
                                                           np.median(timing, axis=0).tolist()))}
        fd = report["frontdoor"]["latency_ms"]
        print(f"[http] [{card}] 16 async clients x 16 requests of 64 points (keepalive): "
              f"bitwise == Server.submit; client p50/p95 {wire_pct['p50_ms']:.4f}/"
              f"{wire_pct['p95_ms']:.4f} ms over the wire vs {fd['p50_ms']:.4f}/"
              f"{fd['p95_ms']:.4f} ms in process (FrontDoor); server-side p50 ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in report["http"]["server_timing_ms_p50"].items())
              + "; 413 oversized, 400 garbage, 400 wrong frame kind")

        # a swap under wire load: no failure, and the served version advances
        rollback = api.FittedPSVGP.load(store, step=2)
        pts = _uniform(grid, 64, 40_000)

        async def swap_load():
            loop = asyncio.get_running_loop()
            state = {"done": 0}

            async def stream():
                versions = []
                async with AsyncNetClient("127.0.0.1", ns.port) as cl:
                    for i in range(48):
                        versions.append((await cl.predict(pts, request_id=f"s{i}")).server_version)
                        state["done"] += 1
                return versions

            async def swapper():
                while state["done"] < 8:
                    await asyncio.sleep(0.001)
                await loop.run_in_executor(None, lambda: server.swap(rollback, version=4))

            return (await asyncio.gather(swapper(), stream()))[1]

        versions = asyncio.run(swap_load())
        check(len(versions) == 48 and versions == sorted(versions) and versions[0] == 3
              and versions[-1] == 4, f"server_version over the swap: {versions}")
        print(f"[http] swap under wire load (to the stored step 2 as version 4): 48 of 48 "
              f"requests answered, server_version {versions[0]} -> {versions[-1]} monotone")
    finally:
        stop()

    # shed -> 429 with a retry hint: a queue of one under bursts of clients
    ns, stop = _net_thread(NetServer, server, api.NetConfig(port=0),
                           api.FrontDoorConfig(queue_depth=1, admission="shed"))
    try:
        once = RetryPolicy(max_attempts=1)

        async def burst():
            async def one(i):
                async with AsyncNetClient("127.0.0.1", ns.port, retry=once) as cl:
                    try:
                        await cl.predict(_uniform(grid, 8, 50_000 + i))
                        return None
                    except ServerError as err:
                        return err

            return await asyncio.gather(*(one(i) for i in range(64)))

        shed = []
        for _ in range(5):
            shed = [e for e in asyncio.run(burst()) if e is not None]
            if shed:
                break
        check(shed and all(e.status == 429 and e.frame.code == "shed"
                           and e.frame.retry_after_ms == SHED_RETRY_MS for e in shed),
              f"shed lane over HTTP: {[(e.status, e.frame.code) for e in shed][:4]}")
        print(f"[http] shed lane (queue_depth 1, 64 concurrent clients): {len(shed)} answered "
              f"429 'shed' with retry_after_ms {SHED_RETRY_MS}")
    finally:
        stop()


def exact_gp_phase(torch, dev, card: str, report: dict) -> None:
    """Phase 7d: ``gp/exact.py`` on the card, set up as the JAX package's
    own checks are (tests/test_svgp.py): one cell in f32, n = 32, Z = X,
    q(u) at the closed-form Titsias optimum — the SVGP's mean and variance
    within 0.05 of the exact GP's, its ELBO <= logml + 1e-3 and the gap
    < 2% |logml| + 0.2; and ELBO <= logml + 1e-3 at random initial
    parameters with m = 16."""
    from repro_torch.core import svgp
    from repro_torch.gp import CovarianceParams, exact_gp_logml, exact_gp_predict, make_covariance

    rng = np.random.default_rng(0)
    x_np = rng.uniform(-2.0, 2.0, (64, 2)).astype(np.float32)
    y_np = (np.sin(2 * x_np[:, 0]) + 0.5 * np.cos(3 * x_np[:, 1])
            + 0.1 * rng.normal(size=64)).astype(np.float32)
    xs = torch.as_tensor(rng.uniform(-2, 2, (16, 2)).astype(np.float32), device=dev)
    cov_fn = make_covariance("rbf")
    cfg = svgp.SVGPConfig(num_inducing=32, input_dim=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def one_cell(p):
        return CovarianceParams(p.cov.log_lengthscale[0], p.cov.log_variance[0]), p.log_beta[0]

    x, y = torch.as_tensor(x_np[:32], device=dev), torch.as_tensor(y_np[:32], device=dev)
    params = svgp.init_svgp_params(gen, cfg, x[None])._replace(z=x[None])
    cov, log_beta = one_cell(params)
    # the Titsias optimum in float64: S* = Kmm A^-1 Kmm, m* = beta Kmm A^-1 Kmn y
    beta = torch.exp(log_beta).double()
    eye = torch.eye(32, dtype=torch.float64, device=dev)
    kmn = cov_fn(cov, x, x).double()
    kmm = kmn + 1e-6 * eye
    a = kmm + beta * kmn @ kmn.T
    s_star = kmm @ torch.linalg.solve(a, kmm)
    m_star = beta * kmm @ torch.linalg.solve(a, kmn @ y.double())
    sl = torch.linalg.cholesky(s_star + 1e-10 * eye)
    s_tril = torch.tril(sl, -1) + torch.diag(torch.log(torch.diagonal(sl)))
    params = params._replace(m_star=m_star.float()[None], s_tril=s_tril.float()[None])
    bound = float(svgp.elbo(params, cov_fn, x[None], y[None], jitter=1e-6)[0])
    logml = float(exact_gp_logml(cov, log_beta, cov_fn, x, y, jitter=1e-6))
    mean_s, var_s = svgp.predict(params, cov_fn, xs[None], jitter=1e-6)
    mean_e, var_e = exact_gp_predict(cov, log_beta, cov_fn, x, y, xs, jitter=1e-6)
    d_mean = float(torch.max(torch.abs(mean_s[0] - mean_e)))
    d_var = float(torch.max(torch.abs(var_s[0] - var_e)))
    check(d_mean <= 0.05 and d_var <= 0.05,
          f"exact GP: SVGP at Z = X off by {d_mean:.4g} (mean), {d_var:.4g} (var)")
    check(bound <= logml + 1e-3 and abs(bound - logml) < 0.02 * abs(logml) + 0.2,
          f"exact GP: ELBO {bound:.5f} vs logml {logml:.5f}")
    x16, y16 = torch.as_tensor(x_np, device=dev), torch.as_tensor(y_np, device=dev)
    rand = svgp.init_svgp_params(gen, svgp.SVGPConfig(num_inducing=16, input_dim=2), x16[None])
    cov16, log_beta16 = one_cell(rand)
    bound16 = float(svgp.elbo(rand, cov_fn, x16[None], y16[None])[0])
    logml16 = float(exact_gp_logml(cov16, log_beta16, cov_fn, x16, y16))
    check(bound16 <= logml16 + 1e-3, f"exact GP: ELBO {bound16:.5f} > logml {logml16:.5f}")
    report["exact_gp"] = {"elbo": bound, "logml": logml, "max_abs_mean": d_mean,
                          "max_abs_var": d_var, "elbo_m16": bound16, "logml_n64": logml16}
    print(f"[exact] [{card}] n = 32, Z = X, Titsias q(u), f32 on the card: ELBO {bound:.5f} <= "
          f"logml {logml:.5f}; SVGP vs exact max |d mean| {d_mean:.3g}, |d var| {d_var:.3g}; "
          f"m = 16 at init: ELBO {bound16:.5f} <= logml {logml16:.5f}")


def scan_slice(torch, dev, card: str, report: dict, fitted, ds):
    """Phase 5c: the 2,500-step fit of phase 5 again, from the same initial
    state, through ``psvgp.fit(use_scan=True)``: three eager warm-up steps,
    one step captured as a CUDA graph, 2,497 replays. Its state bitwise the
    eager fit's on every leaf; one projection launch a step; the quality
    band; a 150-step warm refit through the lane bitwise the uninterrupted
    2,650 steps through it and the eager warm refit (``api.refit``). Times:
    fit seconds to a synchronize, each replayed step on the device clock
    (CUDA events recorded between replays), a replay's host call (the first
    20, before the launch queue fills and blocks the call until the card
    frees a slot; and over the fit), the capture. Returns the graph lane's
    model."""
    from repro_torch import api
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.core import partition, psvgp
    from repro_torch.kernels import svgp_proj
    from repro_torch.kernels import launches as kernel_launches

    def differ(a, b):
        a, b = flatten(a), flatten(b)
        return ["keys"] if list(a) != list(b) else [k for k in a if not np.array_equal(a[k], b[k])]

    static, iters = fitted.static, fitted.config.train_iters
    pdata = partition.partition_data(ds.x, ds.y, fitted.grid, device=dev)
    init = psvgp.init(fitted.config.seed, static.cfg, pdata)

    # time the replays (an event after each; the host call too) and the
    # capture, inside the fit itself
    graph_cls = torch.cuda.CUDAGraph
    replay, begin, end = graph_cls.replay, graph_cls.capture_begin, graph_cls.capture_end
    events, host_us, capture = [], [], []

    def timed_replay(self):
        t0 = time.perf_counter()
        replay(self)
        host_us.append(1e6 * (time.perf_counter() - t0))
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    def timed_begin(self, *args, **kwargs):
        capture.append(time.perf_counter())
        return begin(self, *args, **kwargs)

    def timed_end(self, *args, **kwargs):
        out = end(self, *args, **kwargs)
        capture.append(time.perf_counter())
        return out

    kernel_launches.reset()
    graph_cls.replay, graph_cls.capture_begin, graph_cls.capture_end = (
        timed_replay, timed_begin, timed_end)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = psvgp.fit(static, init, pdata, iters, use_scan=True)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        graph_cls.replay, graph_cls.capture_begin, graph_cls.capture_end = replay, begin, end
    launches = svgp_proj.LAUNCHES["svgp_projection"]
    replays = iters - psvgp.WARMUP_STEPS
    check(len(events) == replays and len(capture) == 2,
          f"the graph lane made {len(events)} replays and {len(capture) // 2} captures, not "
          f"{replays} and 1")
    check(launches == iters, f"graph lane: projection launches {launches} != {iters} steps")
    bad = differ(state, fitted.state)
    check(not bad, f"the graph lane's 2,500-step state differs from the eager fit's at {bad}")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:], strict=False)]
    rec = {
        "fit_seconds": fit_s, "capture_ms": 1e3 * (capture[1] - capture[0]),
        "step_ms_p50": float(np.median(step_ms)), "step_ms_p95": float(np.percentile(step_ms, 95)),
        "replay_host_us_first20_p50": float(np.median(host_us[:20])),
        "replay_host_us_p50": float(np.median(host_us)), "projection_launches": launches,
        "bitwise_eager": True,
    }
    print(f"[training] graph lane (psvgp.fit(use_scan=True)), 2,500 steps: bitwise the eager "
          f"api.fit on every leaf ({len(flatten(state))} leaves); {launches} projection launches")
    lane = api.FittedPSVGP(fitted.config, fitted.grid, static, state)
    rmspe, rmsd = train_quality(torch, lane, ds, "graph lane, seed 0")
    check(0.052 <= rmspe <= 0.068, f"graph lane RMSPE {rmspe:.5f} outside [0.052, 0.068]")
    check(0.054 <= rmsd <= 0.076, f"graph lane boundary RMSD {rmsd:.5f} outside [0.054, 0.076]")
    rec["rmspe"], rec["boundary_rmsd"] = rmspe, rmsd

    # the in-situ budget: 150 warm steps through the lane, resumed
    t0 = time.perf_counter()
    resumed = psvgp.fit(static, state, pdata, 150, use_scan=True)
    torch.cuda.synchronize()
    rec["warm_150_seconds"] = time.perf_counter() - t0
    whole = psvgp.fit(static, init, pdata, iters + 150, use_scan=True)
    eager = api.refit(fitted, ds, api.RefitConfig(train_iters=150))
    for name, other in (("the uninterrupted 2,650-step lane fit", whole),
                        ("the eager warm refit", eager.state)):
        bad = differ(resumed, other)
        check(not bad, f"the lane's 150-step warm refit differs from {name} at {bad}")
    print("[training] graph lane: 2,500 + 150 warm steps == 2,650 steps, bitwise, and == the "
          "eager api.refit of 150 steps")
    report["graph_lane"] = rec
    print(f"[times] [{card}] training, graph lane: {fit_s:.3f} s for 2,500 steps to a synchronize "
          f"(capture {rec['capture_ms']:.3f} ms); replayed step p50 {rec['step_ms_p50']:.4f} ms, "
          f"p95 {rec['step_ms_p95']:.4f} ms (device clock); a replay's host call p50 "
          f"{rec['replay_host_us_first20_p50']:.1f} us over the first 20 replays, "
          f"{rec['replay_host_us_p50']:.1f} us over the fit (a full launch queue blocks it); "
          f"150 warm steps {rec['warm_150_seconds']:.3f} s")
    return lane


def train_state_phase(torch, card: str, report: dict, ds) -> None:
    """Phase 7e: train-state checkpoints on the card at the paper's
    configuration — 100 steps, ``save_train_state``, ``load_train_state``,
    100 more (a warm refit on the same slice continues the step counter),
    bitwise the uninterrupted 200-step fit."""
    from repro_torch import api
    from repro_torch.checkpoint import latest_step, load_train_state, save_train_state
    from repro_torch.checkpoint.checkpoint import flatten

    cfg = api.FitConfig(grid=20, m=5, delta=0.125, train_iters=200, batch_size=32,
                        learning_rate=0.05, seed=0)
    whole = api.fit(cfg, ds)
    half = api.fit(dataclasses.replace(cfg, train_iters=100), ds)
    with tempfile.TemporaryDirectory() as tmp:
        save_train_state(tmp, 100, half.state)
        check(latest_step(tmp).endswith("step_00000100"), "the latest pointer")
        state = load_train_state(tmp, half.state)
    check(state.params.z.device == half.device and state.step == 100, "the restored state")
    restored = api.FittedPSVGP(half.config, half.grid, half.static, state)
    resumed = api.refit(restored, ds, api.RefitConfig(train_iters=100))
    a, b = flatten(resumed.state), flatten(whole.state)
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    check(list(a) == list(b) and not bad, f"resumed fit differs from the 200-step fit at {bad}")
    report["train_state_resume_bitwise"] = True
    print(f"[checkpoint] [{card}] paper config: fit 100 -> save_train_state -> load -> 100 more "
          f"== the 200-step fit, bitwise ({len(a)} leaves, step {resumed.state.step})")


def lifecycle_slice(torch, dev, card: str, report: dict, trained, ds) -> None:
    """Phase 7: the in-situ lifecycle and its front doors on the card; the
    projection and slots launches of the path are counted within it."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        server, _ = insitu_loop(torch, card, report, trained, store)
        frontdoor_phase(card, report, server)
        http_phase(card, report, server, store)
    exact_gp_phase(torch, dev, card, report)
    train_state_phase(torch, card, report, ds)


def training_times(torch, dev, card: str, cache, x_main, fitted, ds, report: dict,
                   errors: dict) -> list:
    """Phase 6, training half: device time of the projection and K(X, Z)
    kernels at the training step's shape and at 65,536 rows (one cell's
    factors), of the Adam kernel at :data:`ADAM_SHAPES`, and of the draws
    kernel at :data:`DRAWS_SHAPES` (held bitwise its plain twin there
    first, both bodies), with their plain versions and bounds; the device's
    busy share of a training step in a profiler window of 20 steps."""
    from repro_torch.core import partition, psvgp, sampler
    from repro_torch.kernels import draws, rbf, ref, svgp_proj
    from repro_torch.optim import adam_update, tree_leaves
    from repro_torch.optim.adam import plain_adam_update

    grid = fitted.grid
    big = torch.as_tensor(np.random.default_rng(2).uniform(
        [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]],
        (1, 65536, 2)).astype(np.float32), device=dev)
    rows = []
    for label, x, factors in (
        ("main", x_main, (cache.z, cache.cov.log_lengthscale, cache.cov.log_variance, cache.w)),
        ("SPMD rank", x_main[:1], (cache.z[:1], cache.cov.log_lengthscale[:1],
                                   cache.cov.log_variance[:1], cache.w[:1])),
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

    # the Adam update at the benchmark cells' shapes: the kernel in place
    # (device counter), as the captured step runs it, and the plain formula
    for label, P, m in ADAM_SHAPES:
        params, grads, opt = adam_case(torch, dev, P, m, torch.tensor(9, device=dev), seed=P + m)
        elems = sum(x.numel() for x in tree_leaves(params))
        k_ms = device_ms(torch, lambda p=params, g=grads, o=opt: adam_update(
            p, g, o, lr=ADAM_LR, out=(p, o)))
        p_ms = device_ms(torch, lambda p=params, g=grads, o=opt: plain_adam_update(
            p, g, o, lr=ADAM_LR))
        b_ms, b_by = adam_bound(elems)
        rows.append(("adam_update", label, (P, elems // P), k_ms, p_ms, b_ms, b_by))
        print(f"[times] [{card}] adam_update {label} (P, N)={(P, elems // P)}: kernel "
              f"{k_ms:.6f} ms, plain {p_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), share "
              f"{b_ms / k_ms:.4f}, floor {report['floor_ms']:.6f} ms")

    # the draws: the kernel bitwise its plain twin over 64 steps from a
    # device counter, then timed against the plain composition it replaced
    # (the lane's torch.topk draws), both reading the counter on the card
    errors["minibatch_draws"] = 0.0
    for label, g, n_max in DRAWS_SHAPES:
        if n_max is None:  # phase 5b's partition of ds
            x_np = np.asarray(ds.x)
            n_max = partition.partition_data(x_np, np.asarray(ds.y),
                                             partition.make_grid(x_np, g, g)).mask.shape[1]
        dist, mask = draws_case(torch, dev, g, n_max, seed=g)
        step = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(64):
            step.fill_(2436 + t)
            got = draws.minibatch_draws(dist.probs, dist.neighbor_tbl, mask, DRAWS_BATCH, 0, step)
            want = ref.minibatch_draws(sampler.StepDraws(0, step, dev), dist, mask, DRAWS_BATCH)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"minibatch_draws {label} step {2436 + t}: not bitwise its plain twin")

        def plain(dist=dist, mask=mask, step=step):
            rand = sampler.StepDraws(0, step, dev)
            kprime, _slot = sampler.sample_slots(rand, dist)
            return sampler.sample_minibatch_indices(rand, mask[kprime], DRAWS_BATCH)

        P = g * g
        k_ms = device_ms(torch, lambda d=dist, m=mask, s=step: draws.minibatch_draws(
            d.probs, d.neighbor_tbl, m, DRAWS_BATCH, 0, s))
        p_ms = device_ms(torch, plain)
        b_ms, b_by = draws_bound(P, n_max, DRAWS_BATCH)
        rows.append(("minibatch_draws", label, (P, n_max), k_ms, p_ms, b_ms, b_by))
        print(f"[kernels] minibatch_draws {label} (P, n_max)=({P}, {n_max}), B {DRAWS_BATCH}: "
              "bitwise its plain twin over 64 steps (device counter)")
        print(f"[times] [{card}] minibatch_draws {label} (P, n_max)={(P, n_max)}: kernel "
              f"{k_ms:.6f} ms, plain composition {p_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), "
              f"share {b_ms / k_ms:.4f}, floor {report['floor_ms']:.6f} ms")

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

    # the graph lane: the same step captured once (psvgp.CapturedStep, as
    # fit(use_scan=True) runs it) and replayed; host syncs over 20 replays,
    # then a profiler window of 20 (its tracing slows the replays: the busy
    # share is also given against phase 5c's replayed step)
    captured = psvgp.CapturedStep(fitted.static, psvgp.device_counters(state, dev), pdata)
    captured.replay(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        captured.replay(n)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    report["graph_replay_host_syncs"] = len(syncs)
    check(not syncs, f"{len(syncs)} host synchronizations in {n} replays of the captured step")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        captured.replay(n)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, per_name = device_busy(torch, prof, n)
    proj = sum("projection" in e.name for e in on_card)
    # the card's own span, first kernel start to last kernel end: the
    # window's host time also holds the profiler's start and stop
    span_us = (max(e.time_range.end for e in on_card) - min(e.time_range.start for e in on_card)
               if on_card else 0.0)
    report["graph_device_ops_per_step"] = len(on_card) / n
    report["graph_projection_launches_by_profiler"] = proj
    if busy_us > 0:
        check(proj == n, f"the profiler saw {proj} projection kernels in {n} replays, not {n}")
        step_us = 1e3 * report["graph_lane"]["step_ms_p50"]
        report["graph_device_busy_share"] = busy_us / window_us
        report["graph_device_busy_share_of_span"] = busy_us / span_us
        report["graph_device_busy_share_of_step"] = busy_us / n / step_us
        report["graph_device_us_per_step"] = per_name
        print(f"[times] [{card}] training step, graph lane: 0 host syncs in {n} replays; "
              f"{len(on_card) / n:.1f} device ops and {proj / n:.0f} projection kernel per "
              f"replay (profiler); device busy {busy_us / n:.1f} us of {window_us / n:.1f} us "
              f"per step (share {busy_us / window_us:.4f}; of the card's span "
              f"{span_us / n:.1f} us, {busy_us / span_us:.4f}; of the {step_us:.1f} us replayed "
              f"step of phase 5c, {busy_us / n / step_us:.4f}); top device ops, us per step: "
              + ", ".join(f"{k} {v:.1f}" for k, v in per_name.items()))
    else:
        report["graph_device_busy_share"] = None
        print(f"[times] [{card}] training step, graph lane: 0 host syncs in {n} replays; device "
              "busy share and kernels by profiler: not measured (torch.profiler saw no device "
              "activity)")
    return rows


# (entry, shape, m, d) of the wide time rows: both prediction entries at
# m = 128 and 1,024; the projection at the JAX package's kernel benchmark
# shapes (benchmarks/bench_kernels.py: (B, m, d) = (256, 128, 2) and
# (1,024, 128, 3)), at 400 cells of m = 128 and at m = 1,024; K(X, Z) at the
# same benchmark shapes and at one store-bound shape that writes 210 MB; the
# paper's Fig. 4 widths (benchmarks/bench_delta.py: m in {5, 10, 20} at 400
# cells, B = 32): the projection at m = 10 (narrow) and 20 (wide), the
# slots kernel's request at m = 20
WIDE_TIMES = (
    ("posterior_predict_slots", (16, 9, 256), 128, 2),
    ("posterior_predict_slots", (4, 1, 4096), 1024, 2),
    ("posterior_predict", (16, 2304), 128, 2),
    ("posterior_predict", (4, 4096), 1024, 2),
    ("svgp_projection", (1, 256), 128, 2),
    ("svgp_projection", (1, 1024), 128, 3),
    ("svgp_projection", (400, 32), 128, 2),
    ("svgp_projection", (1, 4096), 1024, 2),
    ("rbf_cross_cov", (1, 256), 128, 2),
    ("rbf_cross_cov", (1, 1024), 128, 3),
    ("rbf_cross_cov", (400, 4096), 32, 2),
    ("svgp_projection", (400, 32), 10, 2),
    ("svgp_projection", (400, 32), 20, 2),
    ("posterior_predict_slots", (400, 9, 32), 20, 2),
)


def wide_times(torch, dev, card: str, report: dict) -> list:
    """Phase 6: device time of every entry at the wide shapes, beside its
    plain version, its bound and share and the launch floor; at the
    prediction and projection rows also ``torch.bmm`` for the same m x m
    products (TF32 off), a yardstick for the FFMA tile loop, not a port of
    anything."""
    from repro_torch.kernels import predict, rbf, ref, svgp_proj

    rng = np.random.default_rng(11)
    rows = []
    report["bmm_ms"] = {}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for name, shape, m, d in WIDE_TIMES:
        P = shape[0]
        z = t(rng.uniform(0, 2, (P, m, d)))
        log_l = t(np.log(rng.uniform(0.3, 1.5, (P, d))))
        log_v = t(rng.normal(0, 0.5, P))
        w = t(np.tril(rng.normal(0, 1, (P, m, m))) / np.sqrt(m))
        x = t(rng.uniform(0, 2, (*shape, d)))
        bmm_ms = None
        if name.startswith("posterior_predict"):
            u = t(rng.normal(0, 1, (P, m, m)) / np.sqrt(m))
            c = t(rng.normal(0, 1, (P, m)))
            args = (x, z, log_l, log_v, w, u, c)
            if name == "posterior_predict_slots":
                kernel, plain = predict.posterior_predict_slots, ref.posterior_predict_slots_stacked
                S, Q = shape[1], shape[2]
            else:
                kernel, plain = predict.posterior_predict, ref.posterior_predict
                S, Q = 1, shape[1]
            b_ms, b_by = bound(P, S, Q, m, d)
            knm = ref.rbf_cross_cov(x.reshape(P, S * Q, d), z, log_l, log_v)
            bmm_ms = device_ms(torch, lambda k=knm, a=w, b=u: (torch.bmm(k, a.mT),
                                                                torch.bmm(k, b.mT)))
            label = f"m={m} d={d} (P, S, Q)={(P, S, Q)}"
        else:
            project = name == "svgp_projection"
            args = (x, z, log_l, log_v, w) if project else (x, z, log_l, log_v)
            kernel = svgp_proj.svgp_projection if project else rbf.rbf_cross_cov
            plain = ref.svgp_projection if project else ref.rbf_cross_cov
            b_ms, b_by = projection_bound(P, shape[1], m, d, project)
            if project:
                knm = ref.rbf_cross_cov(x, z, log_l, log_v)
                bmm_ms = device_ms(torch, lambda k=knm, a=w: torch.bmm(k, a.mT))
            label = f"m={m} d={d} (P, B)={shape}"
        k_ms = device_ms(torch, lambda f=kernel, a=args: f(*a))
        # the plain prediction takes one op per inducing point (ref.row_products):
        # ~0.2 s a call at m = 1,024, so fewer calls in its graph there
        p_ms = device_ms(torch, lambda f=plain, a=args: f(*a), reps=10 if m <= 256 else 2)
        rows.append((name, label, shape, k_ms, p_ms, b_ms, b_by))
        report["bmm_ms"][f"{name} {label}"] = bmm_ms
        print(f"[times] [{card}] {name} {label}: kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), share {b_ms / k_ms:.4f}, floor "
              f"{report['floor_ms']:.6f} ms"
              + (f"; torch.bmm of the m x m products {bmm_ms:.6f} ms" if bmm_ms else ""))
    return rows


# --------------------------------------------------------------------------
# 8. the entry points and examples, each a subprocess on the card
# --------------------------------------------------------------------------

ENTRY_TIMEOUT_S = 400


def entry_point_commands() -> list:
    """(label, argv after the interpreter) of phase 8, at full width: the
    paper's 400-cell artifact (m 5) under 4,096-point requests, the Fig. 4
    delta sweep at its defaults (12,000 points, 10 x 10 cells, m 5), the
    in-situ loop. Every command runs on its default device, cuda."""
    art = ["--gp-artifact", FIXTURE, "--gp-batch", "4096", "--gp-requests", "50"]
    return [
        ("api.smoke", ["-m", "repro_torch.api.smoke"]),
        ("serve --gp", ["-m", "repro_torch.launch.serve", "--gp", *art]),
        ("serve --gp --sharded", ["-m", "repro_torch.launch.serve", "--gp", "--sharded", *art]),
        ("serve_sharded two-level zipf 1.1",
         ["-m", "repro_torch.launch.serve_sharded", *art, "--gp-skew", "1.1",
          "--gp-router", "two-level"]),
        ("delta_sweep gather", ["examples/delta_sweep_torch.py"]),
        ("delta_sweep ppermute", ["examples/delta_sweep_torch.py", "--comm", "ppermute"]),
        ("e3sm_insitu 3 steps", ["examples/e3sm_insitu_torch.py", "--sim-steps", "3"]),
    ]


_LATENCY = re.compile(r"latency/request ms: p50=([0-9.]+) p95=([0-9.]+) p99=([0-9.]+)")
_RATIO = re.compile(r"tolerance ratio mean ([0-9.e+-]+) var ([0-9.e+-]+)")
_LM_SERVE = re.compile(r"prefill: .* \(([0-9,]+) tok/s\)\ndecode: .* \(([0-9,]+) tok/s\)")
_SWEEP_ROW = re.compile(r"^\s*([0-9.]+) \|\s*(\S+) \|\s*(\S+) \|\s*([0-9.]+) \|", re.MULTILINE)


def parse_entry_point(label: str, out: str) -> dict:
    """What phase 8 reads from a command's standard output, checked."""
    rec: dict = {}
    lat = _LATENCY.search(out)
    if lat:
        rec["latency_ms"] = {"p50_ms": float(lat.group(1)), "p95_ms": float(lat.group(2)),
                             "p99_ms": float(lat.group(3))}
    if label.startswith("serve"):
        check(lat is not None, f"{label}: no latency report")
    if "sharded" in label:
        ratio = _RATIO.search(out)
        check(ratio is not None and "lane: one-process halo program" in out,
              f"{label}: no warm-up check or lane line")
        rec["tolerance_ratio"] = [float(ratio.group(1)), float(ratio.group(2))]
        check(max(rec["tolerance_ratio"]) <= 1, f"{label}: sharded != replicated")
    if label == "api.smoke":
        check("api-smoke OK" in out and "fused backend" in out, "api.smoke: no OK on the fused lane")
    if label.startswith("delta_sweep"):
        rows = [(float(a), float(b), float(c), float(d)) for a, b, c, d in _SWEEP_ROW.findall(out)]
        check([r[0] for r in rows] == [0.0, 0.125, 0.5, 1.0], f"{label}: rows {rows}")
        check(all(np.isfinite(r[1:]).all() for r in rows), f"{label}: a non-finite metric")
        rec["sweep"] = [{"delta": r[0], "rmspe": r[1], "boundary_rmsd": r[2], "fit_s": r[3]}
                        for r in rows]
    if label.startswith("lm serve"):
        m = _LM_SERVE.search(out)
        check(m is not None and "device=cuda" in out, f"{label}: no decode line on cuda")
        rec["prefill_tok_s"], rec["decode_tok_s"] = (float(v.replace(",", "")) for v in m.groups())
    if label.startswith("lm train"):
        rec["loss"] = [float(v) for v in re.findall(r"loss ([0-9.]+)", out)]
        check("device=cuda" in out and "parameters: 596.18M" in out and rec["loss"]
              and np.isfinite(rec["loss"]).all(), f"{label}: {out[-2000:]}")
        rec["tok_s"] = [float(v.replace(",", "")) for v in re.findall(r"([0-9,]+) tok/s", out)]
    if label.startswith("e3sm_insitu"):
        check("replays bitwise" in out, "e3sm_insitu: the store's replay differs")
        rec["refit_s"] = [float(v) for v in re.findall(r"refit \d+ iters in ([0-9.]+)s", out)]
        check(len(rec["refit_s"]) == 2, f"e3sm_insitu: refits {rec['refit_s']}")
    return rec


def entry_points_phase(card: str, report: dict, commands=None) -> None:
    """Phase 8: every command of :func:`entry_point_commands` as a
    subprocess from the checkout; a non-zero exit or a failed check of its
    output fails the phase. Prints each command's seconds and its p50/p95
    or fit seconds."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = SRC
    report.setdefault("entry_points", {})
    for label, argv in commands or entry_point_commands():
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, *argv], cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=ENTRY_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise SmokeFailure(f"{label}: no exit within {ENTRY_TIMEOUT_S} s") from e
        seconds = time.perf_counter() - t0
        check(r.returncode == 0, f"{label} exited {r.returncode}:\n{r.stderr[-3000:]}")
        rec = {"argv": argv, "seconds": seconds, **parse_entry_point(label, r.stdout)}
        report["entry_points"][label] = rec
        what = ""
        if "latency_ms" in rec:
            what = f"p50 {rec['latency_ms']['p50_ms']} ms, p95 {rec['latency_ms']['p95_ms']} ms"
        if "tolerance_ratio" in rec:
            what += f", vs replicated tol ratio {max(rec['tolerance_ratio']):.4f}"
        if "sweep" in rec:
            what = "; ".join(f"delta {s['delta']}: RMSPE {s['rmspe']}, bRMSD "
                             f"{s['boundary_rmsd']}, fit {s['fit_s']} s" for s in rec["sweep"])
        if "refit_s" in rec:
            what = "refits " + ", ".join(f"{s} s" for s in rec["refit_s"])
        if "decode_tok_s" in rec:
            what = f"prefill {rec['prefill_tok_s']} tok/s, decode {rec['decode_tok_s']} tok/s"
        if "loss" in rec:
            what = f"losses {rec['loss']}, tok/s {rec['tok_s']}"
        print(f"[entry] [{card}] {label}: {seconds:.3f} s; {what}")


# --------------------------------------------------------------------------
# 9. the halo mesh: one cell per rank, 16 ranks over gloo on one card
# --------------------------------------------------------------------------

MESH_SIDE = 4
MESH_REQUESTS = 20
MESH_PROFILED = 5


def _digest(results: list) -> str:
    import hashlib

    h = hashlib.sha256()
    for mean, var in results:
        h.update(np.ascontiguousarray(mean).tobytes())
        h.update(np.ascontiguousarray(var).tobytes())
    return h.hexdigest()


def _mesh_serve(group, artifact: str, reqs_file: str, device: str) -> dict:
    """Phase 9 in one rank of the shared spawn: serve the requests on the
    mesh lane, serial then pipelined, and count the rank's slots launches
    by wrapper and by profiler."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import predict
    from repro_torch.kernels import launches as kernel_launches

    rank = group.rank()
    reqs = list(np.load(reqs_file)["reqs"])
    fitted = api.FittedPSVGP.load(artifact, device=device)
    out: dict = {}
    for pipeline in ("serial", "pipelined"):
        server = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline=pipeline),
                            group=group)
        server.submit(reqs[0])  # warm-up, not counted
        server.reset_stats()
        kernel_launches.reset()
        res: list = []
        t0 = time.perf_counter()
        rec = server.stream(reqs, warm=False, on_result=lambda i, r, res=res: res.append(r))
        wall = time.perf_counter() - t0
        out[pipeline] = {
            "digest": _digest(res), "latency_ms": rec["latency_ms"], "wall_s": wall,
            "mesh": server.stats()["mesh"], "launches": dict(predict.LAUNCHES),
            "qmax": rec["qmax_policy"], "backend": server.backend,
        }
        if rank == 0:
            out[pipeline]["results"] = res
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for q in reqs[:MESH_PROFILED]:
            server.submit(q)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["profiler"] = {
        "device_events": len(on_card),
        "slots_kernels": sum("predict_kernel" in e.name or "predict_wide_kernel" in e.name
                             for e in on_card),
    }
    out["cache_bytes"] = server.cache_bytes
    out["cell"] = server.mesh.cell
    return out


def mesh_inputs(torch, dev) -> dict:
    """Phase 9's model and requests, and the one-process halo program's
    answers and p50 (serial and pipelined): a 4 x 4 model (m 5, 150
    steps) fitted on ``dev``, MESH_REQUESTS uniform 4,096-point requests."""
    from repro_torch import api
    from repro_torch.data.spatial import e3sm_like_field

    fitted = api.fit(api.FitConfig(grid=MESH_SIDE, m=5, train_iters=150, seed=0),
                     e3sm_like_field(n=1500, seed=0), device=dev)
    reqs = [_uniform(fitted.grid, 4096, 200 + i) for i in range(MESH_REQUESTS)]
    want = {}
    for pipeline in ("serial", "pipelined"):
        one = api.Server(fitted, api.ServeConfig(mode="sharded", pipeline=pipeline))
        one.submit(reqs[0])
        res: list = []
        rec = one.stream(reqs, warm=False, on_result=lambda i, r, res=res: res.append(r))
        want[pipeline] = (res, rec["latency_ms"])
    return {"fitted": fitted, "reqs": reqs, "want": want}


def mesh_check(card: str, report: dict, ranks: list, inputs: dict, spawn_s: float) -> None:
    """Phase 9's gates on what the 16 ranks saw: every answer bitwise the
    one-process halo program's, pipelined == serial, one slots launch a
    rank a request (wrapper and profiler), per-rank cache bytes total /
    16; p50 per request and the exchange's share of it."""
    from repro_torch.launch import serve_sharded as ss

    world = len(ranks)
    fitted, want = inputs["fitted"], inputs["want"]
    total, _ = ss.cache_memory_bytes(fitted.cache)
    rec: dict = {"ranks": world, "requests": MESH_REQUESTS, "shared_spawn_s": spawn_s}
    for pipeline in ("serial", "pipelined"):
        got = ranks[0][pipeline]["results"]
        same = all(_equal(a, b) for a, b in zip(got, want[pipeline][0], strict=True))
        check(same, f"mesh {pipeline}: rank 0's answers differ from the one-process program's")
        digests = {r[pipeline]["digest"] for r in ranks}
        check(digests == {_digest(got)}, f"mesh {pipeline}: the ranks' answers differ")
        check(len({json.dumps(r[pipeline]["qmax"], sort_keys=True) for r in ranks}) == 1,
              f"mesh {pipeline}: the ranks' q_max differ")
        for r, rk in enumerate(ranks):
            check(rk[pipeline]["backend"] == "fused", f"mesh: rank {r} on {rk[pipeline]['backend']}")
            check(rk[pipeline]["launches"]["posterior_predict_slots"] == MESH_REQUESTS,
                  f"mesh {pipeline}: rank {r} launched the slots kernel "
                  f"{rk[pipeline]['launches']} times for {MESH_REQUESTS} requests")
            check(rk[pipeline]["mesh"]["shifts"] == 4 * MESH_REQUESTS,
                  f"mesh {pipeline}: rank {r} made {rk[pipeline]['mesh']['shifts']} shifts")
        lat = [r[pipeline]["latency_ms"]["p50_ms"] for r in ranks]
        walls = [r[pipeline]["wall_s"] for r in ranks]
        def share(key, walls=walls, pipeline=pipeline):
            return [r[pipeline]["mesh"][key] / w for r, w in zip(ranks, walls, strict=True)]

        shift_share, gather_share, wait_share = share("exchange_s"), share("gather_s"), share("wait_s")
        rec[pipeline] = {
            "p50_ms_rank0": ranks[0][pipeline]["latency_ms"]["p50_ms"],
            "p95_ms_rank0": ranks[0][pipeline]["latency_ms"]["p95_ms"],
            "p50_ms_ranks": [min(lat), max(lat)],
            "shift_share_ranks": [min(shift_share), max(shift_share)],
            "gather_share_ranks": [min(gather_share), max(gather_share)],
            "device_wait_share_ranks": [min(wait_share), max(wait_share)],
            "one_process_p50_ms": want[pipeline][1]["p50_ms"],
        }
        print(f"[mesh] [{card}] {world} ranks, {pipeline}: {MESH_REQUESTS} x 4,096-point requests "
              f"bitwise the one-process program (p50 {want[pipeline][1]['p50_ms']:.4f} ms) on every "
              f"rank; p50 {rec[pipeline]['p50_ms_rank0']:.4f} ms (ranks "
              f"{min(lat):.4f}-{max(lat):.4f}), the 4 shifts {min(shift_share):.4f}-"
              f"{max(shift_share):.4f}, the all-gather {min(gather_share):.4f}-"
              f"{max(gather_share):.4f} and the wait for the rank's own evaluation "
              f"{min(wait_share):.4f}-{max(wait_share):.4f} of the stream's wall time (each "
              "collective's share includes the wait for the slowest rank); 1 slots launch a "
              "rank a request")
    same = all(_equal(a, b) for a, b in zip(ranks[0]["serial"]["results"],
                                            ranks[0]["pipelined"]["results"], strict=True))
    check(same, "mesh: pipelined != serial")
    for r, rk in enumerate(ranks):
        check(rk["cache_bytes"] == (total, total // world),
              f"mesh: rank {r} cache bytes {rk['cache_bytes']}, total {total}")
        check(tuple(rk["cell"]) == (r % MESH_SIDE, r // MESH_SIDE), f"mesh: rank {r} cell")
    seen = [rk["profiler"] for rk in ranks]
    if all(s["device_events"] > 0 for s in seen):
        check(all(s["slots_kernels"] == MESH_PROFILED for s in seen),
              f"mesh: the profiler saw {[s['slots_kernels'] for s in seen]} slots kernels in "
              f"{MESH_PROFILED} requests a rank")
        rec["profiler_slots_per_request"] = 1
        print(f"[mesh] [{card}] torch.profiler in every rank: {MESH_PROFILED} slots kernels in "
              f"{MESH_PROFILED} requests")
    else:
        rec["profiler_slots_per_request"] = None
        print(f"[mesh] [{card}] torch.profiler saw no device activity in some rank: slots "
              "launches by profiler not measured (the wrappers' counts stand)")
    rec["cache_bytes"] = [total, total // world]
    print(f"[mesh] [{card}] pipelined == serial; cache {total} B total, {total // world} B a rank "
          f"(1/{world}); the spawn phase 10 shares (serve + train) {spawn_s:.3f} s")
    report["mesh"] = rec


# --------------------------------------------------------------------------
# 10. SPMD training: one cell per rank, 16 ranks over gloo on one card
# --------------------------------------------------------------------------

SPMD_SIDE = 4
SPMD_N = 1944  # 48,602 x 16 / 400: a cell holds what a cell of the paper's 20 x 20 run holds
SPMD_STEPS = 300
SPMD_CHECKED = 5  # steps whose received batches are held to the one-process step's
SPMD_PROFILED = 5


def spmd_problem(dev):
    """(grid, data, static, initial state) of phase 10: the paper's width
    (m 5, B 32, delta 0.125, lr 0.05, the ppermute exchange) on 4 x 4
    cells of ``e3sm_like_field(1,944)``."""
    from repro_torch.core import partition, psvgp, svgp
    from repro_torch.data.spatial import e3sm_like_field

    ds = e3sm_like_field(n=SPMD_N, seed=0)
    grid = partition.make_grid(ds.x, SPMD_SIDE, SPMD_SIDE)
    data = partition.partition_data(ds.x, ds.y, grid, device=dev)
    cfg = psvgp.PSVGPConfig(
        svgp=svgp.SVGPConfig(num_inducing=5, input_dim=2, use_pallas=True),
        delta=0.125, batch_size=32, learning_rate=0.05, comm="ppermute", seed=0,
    )
    static = psvgp.build(cfg, data)
    return grid, data, static, psvgp.init(0, cfg, data)


def _flat_state(state) -> dict:
    from repro_torch.checkpoint.checkpoint import flatten

    out = flatten({"params": state.params, "opt": {"mu": state.opt.mu, "nu": state.opt.nu}})
    out["opt/step"] = np.asarray(int(state.opt.step))
    out["step"] = np.asarray(int(state.step))
    return out


def _spmd_train(group, inputs: str, device: str, marks: dict) -> dict:
    """Phase 10 in one rank of the shared spawn: the initial state's cell,
    SPMD_STEPS steps of ``psvgp_spmd.make_spmd_step`` (the first
    SPMD_CHECKED through its two halves, their received batches kept),
    each timed on the host clock; the gathered state after 2 steps and
    at the end; then SPMD_PROFILED more steps, rank 0 under
    torch.profiler. ``marks`` gains wall-clock times the parent reads
    against its spawn."""
    import contextlib

    import torch

    from repro_torch.core import psvgp
    from repro_torch.core import psvgp_spmd as spmd
    from repro_torch.device import resolve_device
    from repro_torch.kernels import svgp_proj
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.launch import serve_sharded as ss

    rank = group.rank()
    dev = resolve_device(device)
    z = dict(np.load(inputs))
    grid, data, static, _ = spmd_problem(dev)
    mesh = ss.mesh_for_grid(grid, group)
    step = spmd.make_spmd_step(mesh, mesh.axis_names, grid, static.cfg, static.cov_fn,
                               static.p_dir)
    arrays = spmd.shard_data((data.x, data.y, data.mask, static.dist.probs,
                              static.dist.n_eff), mesh)
    state = psvgp.state_from_numpy(z, dev)
    state = spmd.shard_state(state, mesh)
    marks["ready"] = time.time()
    out: dict = {"batches": [], "step_ms": [], "marks": marks}
    kernel_launches.reset()
    mesh.reset_stats()
    for t in range(SPMD_STEPS):
        t0 = time.perf_counter()
        if t < SPMD_CHECKED:
            d, bx, by, bm = step.batch(state, 0, *arrays[:3])
            state, _loss = step.update(state, d, bx, by, bm, *arrays[3:])
            out["batches"].append((int(d), *(a.cpu().numpy() for a in (bx, by, bm))))
        else:
            state, _loss = step(state, 0, *arrays)
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if t == 0:
            marks["first_step"] = time.time()
        if t == 1:
            two = spmd.gather_state(state, mesh)
            if rank == 0:
                out["state_2"] = _flat_state(two)
    out["wall_s"] = sum(out["step_ms"]) / 1e3
    marks["trained"] = time.time()
    out["launches"] = dict(svgp_proj.LAUNCHES)
    out["mesh"] = mesh.stats()
    out["reduce_s"] = step.reduce_s
    final = spmd.gather_state(state, mesh)
    if rank == 0:
        out["state_end"] = _flat_state(final)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with (torch.profiler.profile(activities=acts) if rank == 0
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        for _ in range(SPMD_PROFILED):
            state, _loss = step(state, 0, *arrays)
        window_us = 1e6 * (time.perf_counter() - t0)
    if prof is not None:
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us, per_name = device_busy(torch, prof, SPMD_PROFILED)
        out["profiler"] = {
            "device_events": len(on_card), "busy_us": busy_us, "window_us": window_us,
            "projection_kernels": sum("projection" in e.name for e in on_card),
            "per_name": per_name,
        }
    marks["done"] = time.time()
    return out


def batch_invariance(torch, static, state, data) -> dict:
    """{op: True when every cell's result at P = 1 is bitwise its row of
    the P-stacked call}: each library op of a training step, the
    projection kernel and the whole update (``psvgp._sgd_step``), on the
    state and the first 32 stored rows of every cell."""
    from repro_torch.core import posterior, psvgp
    from repro_torch.kernels import ops
    from repro_torch.optim import tree_map

    p_ = state.params
    jitter = static.cfg.svgp.jitter
    m = p_.z.shape[1]
    eye = torch.eye(m, device=p_.z.device)
    kmm = static.cov_fn(p_.cov, p_.z, p_.z) + jitter * eye
    lmm = torch.linalg.cholesky_ex(kmm)[0]
    x, y, mask = (a[:, :32].contiguous() for a in (data.x, data.y, data.mask))
    knm = static.cov_fn(p_.cov, x, p_.z)
    sl = posterior.s_chol(p_.s_tril)

    def sub(tree, rows):
        return tree_map(lambda a: a[rows], tree)

    def step(rows):
        st = psvgp.PSVGPState(sub(p_, rows), state.opt._replace(
            mu=sub(state.opt.mu, rows), nu=sub(state.opt.nu, rows)), state.step)
        new, _ = psvgp._sgd_step(st, x[rows], y[rows], mask[rows], static.dist.n_eff[rows],
                                 static.cfg, static.cov_fn)
        return new.params.m_star, new.params.s_tril, new.params.z

    probes = {
        "K(X, Z) (cov_fn)": lambda r: (static.cov_fn(sub(p_.cov, r), x[r], p_.z[r]),),
        "cholesky_ex": lambda r: (torch.linalg.cholesky_ex(kmm[r])[0],),
        "solve_triangular, W = Lmm^-1": lambda r: (ops.lower_inverse(lmm[r]),),
        "solve_triangular, Lmm^-T lk": lambda r: (
            torch.linalg.solve_triangular(lmm[r].mT, knm[r].mT, upper=True),),
        "matmul, a^T m": lambda r: (knm[r] @ p_.m_star[r][..., None],),
        "matmul, S_L^T a": lambda r: (sl[r].mT @ knm[r].mT,),
        "projection kernel": lambda r: ops.svgp_projection(x[r], p_.z[r], p_.cov.log_lengthscale[r],
                                                           p_.cov.log_variance[r], lmm[r]),
        "the whole update (psvgp._sgd_step)": step,
    }
    P = x.shape[0]
    out = {}
    for name, fn in probes.items():
        whole = fn(slice(None))
        out[name] = all(torch.equal(w[p:p + 1], a)
                        for p in range(P) for w, a in zip(whole, fn(slice(p, p + 1)), strict=True))
    return out


def spmd_inputs(torch, dev) -> dict:
    """Phase 10's problem and the one-process references on ``dev``: the
    eager fit of SPMD_STEPS steps (its projection launches) and of 2, the
    one-process step's p50 over 50 steps, every step's direction and the
    first SPMD_CHECKED steps' batches."""
    from repro_torch.core import psvgp, sampler
    from repro_torch.kernels import svgp_proj
    from repro_torch.kernels import launches as kernel_launches

    grid, data, static, state0 = spmd_problem(dev)
    kernel_launches.reset()
    one = psvgp.fit(static, state0, data, SPMD_STEPS)
    one_launches = svgp_proj.LAUNCHES["svgp_projection"]
    two = psvgp.fit(static, state0, data, 2)
    state, step_ms = psvgp.device_counters(state0, dev), []
    for _ in range(50):
        t0 = time.perf_counter()
        state, _loss = psvgp.train_step(static, state, data)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    log_p = torch.log(torch.clamp_min(static.p_dir, 1e-30))
    dirs = [int(sampler.categorical(log_p, sampler.StepDraws(0, t, dev)))
            for t in range(SPMD_STEPS)]
    want_batches = [
        [a.cpu().numpy() for a in psvgp.ppermute_batch(0, t, data.x, data.y, data.mask,
                                                        static.perms, static.p_dir, 32)]
        for t in range(SPMD_CHECKED)]
    return {"grid": grid, "data": data, "static": static, "state0": state0, "one": one,
            "one_launches": one_launches, "two": two, "step_ms": step_ms, "dirs": dirs,
            "want_batches": want_batches}


def spmd_check(torch, dev, card: str, report: dict, ranks: list, inputs: dict,
               spawn_s: float, spawned: float) -> None:
    """Phase 10's gates on what the 16 ranks trained: one projection
    launch a rank a step (wrapper; torch.profiler on rank 0), one hop a
    step where d != 0, the received batches bitwise the one-process
    step's, the gathered state against the one-process eager
    ``psvgp.fit(comm="ppermute")`` from the same init and seed — bitwise,
    or, where a library op rounds a cell differently alone, within 2e-4
    after 2 steps with RMSPE and boundary RMSD within 10%."""
    from repro_torch.core import metrics, neighbors, psvgp

    world = len(ranks)
    grid, data, static = inputs["grid"], inputs["data"], inputs["static"]
    one, two, dirs = inputs["one"], inputs["two"], inputs["dirs"]
    one_launches, step_ms = inputs["one_launches"], inputs["step_ms"]
    want_batches = inputs["want_batches"]
    # counts: one projection launch a rank a step, one hop a step where d != 0
    hops = sum(d != 0 for d in dirs)
    for r, rk in enumerate(ranks):
        check(rk["launches"]["svgp_projection"] == SPMD_STEPS,
              f"spmd: rank {r} launched the projection kernel {rk['launches']} times in "
              f"{SPMD_STEPS} steps")
        check(rk["mesh"]["shifts"] == hops,
              f"spmd: rank {r} made {rk['mesh']['shifts']} hops, {hops} steps moved a batch")
    check(one_launches == SPMD_STEPS, f"spmd: the one-process fit launched {one_launches} times")
    # the received batches, bitwise
    perms = static.perms.cpu().numpy()
    for t, (d, bx, by, bm) in enumerate(want_batches):
        d = int(d[0])
        check(all(rk["batches"][t][0] == d for rk in ranks), f"spmd: step {t}: the ranks' d differ")
        for p, rk in enumerate(ranks):
            _, gx, gy, gm = rk["batches"][t]
            if d != 0 and perms[d][p] == p:
                check(not (gx.any() or gy.any() or gm.any()),
                      f"spmd: step {t}: rank {p} has no neighbor in direction {d}, got non-zeros")
            else:
                check(_equal((gx[0], gy[0]), (bx[p], by[p])) and np.array_equal(gm[0], bm[p]),
                      f"spmd: step {t}: rank {p}'s batch differs from the one-process step's")
    print(f"[spmd] [{card}] {world} ranks, {SPMD_STEPS} steps: 1 projection launch a rank a step, "
          f"{hops} hops ({SPMD_STEPS - hops} steps drew d = 0); the received batches of the "
          f"first {SPMD_CHECKED} steps bitwise the one-process step's (zeros at the grid's edge)")

    # the state against the one-process fit
    def diff(flat, state):
        want = _flat_state(state)
        return {k: float(np.abs(flat[k].astype(np.float64) - want[k]).max()) for k in want}

    end = diff(ranks[0]["state_end"], one)
    at2 = diff(ranks[0]["state_2"], two)
    bitwise = all(v == 0.0 for v in end.values())
    gathered = psvgp.state_from_numpy(ranks[0]["state_end"], dev)
    probes = neighbors.boundary_probes(grid, 23)
    quality = {}
    for label, st in (("spmd", gathered), ("one-process", one)):
        quality[label] = (float(metrics.rmspe(static, st, data)),
                          float(metrics.boundary_rmsd(static, st, probes)))
    invariant = batch_invariance(torch, static, one, data)
    params_2 = max(v for k, v in at2.items() if k.startswith("params/"))
    params_end = max(v for k, v in end.items() if k.startswith("params/"))
    rel = [abs(a - b) / b for a, b in zip(quality["spmd"], quality["one-process"], strict=True)]
    print(f"[spmd] [{card}] batch invariance on {dev.type} (P = 1 against the P-stacked call, "
          "bitwise per cell): " + ", ".join(f"{k} {'yes' if v else 'NO'}"
                                            for k, v in invariant.items()))
    print(f"[spmd] [{card}] final state bitwise the one-process fit's: {bitwise} (max |d| "
          f"params {params_end:.3e}, all leaves {max(end.values()):.3e}); after 2 steps max "
          f"|d| params {params_2:.3e}, all leaves "
          f"{max(at2.values()):.3e}; RMSPE {quality['spmd'][0]:.5f} vs "
          f"{quality['one-process'][0]:.5f}, "
          f"boundary RMSD {quality['spmd'][1]:.5f} vs {quality['one-process'][1]:.5f}")
    check(all(np.isfinite(q) for qs in quality.values() for q in qs), "spmd: non-finite metrics")
    if not bitwise:
        check(not all(invariant.values()),
              "spmd: the state differs from the one-process fit's though every op is "
              "batch-invariant")
        check(params_2 <= 2e-4, f"spmd: after 2 steps the params differ by {params_2:.3e} > 2e-4")
        check(max(rel) <= 0.10, f"spmd: RMSPE / boundary RMSD {quality} differ by more than 10%")

    # times: per rank on the host clock, the exchange's and the all-reduce's shares
    p50 = [float(np.percentile(rk["step_ms"], 50)) for rk in ranks]
    p95 = [float(np.percentile(rk["step_ms"], 95)) for rk in ranks]
    ex = [rk["mesh"]["exchange_s"] / rk["wall_s"] for rk in ranks]
    red = [rk["reduce_s"] / rk["wall_s"] for rk in ranks]
    rec = {"ranks": world, "steps": SPMD_STEPS, "hops": hops, "bitwise": bitwise,
           "max_abs_diff_end": max(end.values()), "max_abs_diff_params_end": params_end,
           "max_abs_diff_params_2": params_2,
           "batch_invariant": invariant, "quality": quality, "shared_spawn_s": spawn_s,
           "step_p50_ms_ranks": [min(p50), max(p50)], "step_p95_ms_ranks": [min(p95), max(p95)],
           "step_p50_ms_rank0": p50[0], "step_p95_ms_rank0": p95[0],
           "exchange_share_ranks": [min(ex), max(ex)],
           "allreduce_share_ranks": [min(red), max(red)],
           "one_process_step_p50_ms": float(np.percentile(step_ms, 50))}
    print(f"[spmd] [{card}] step p50 {p50[0]:.4f} ms, p95 {p95[0]:.4f} ms on rank 0 (ranks' p50 "
          f"{min(p50):.4f}-{max(p50):.4f}, p95 {min(p95):.4f}-{max(p95):.4f}) on the host clock; "
          f"the exchange {min(ex):.4f}-{max(ex):.4f} and the loss all-reduce {min(red):.4f}-"
          f"{max(red):.4f} of a rank's wall time (each includes the wait for the slowest); the "
          f"one-process step p50 {rec['one_process_step_p50_ms']:.4f} ms; the spawn phase 9 "
          f"shares (serve + train) {spawn_s:.3f} s")
    # where the spawn's seconds go: the last rank to reach each mark
    marks = {k: max(rk["marks"][k] for rk in ranks) - spawned for k in ranks[0]["marks"]}
    rec["rank_marks_s"] = marks
    print(f"[spmd] [{card}] seconds from the spawn until the last rank has: "
          + ", ".join(f"{k} {v:.3f}" for k, v in marks.items())
          + f"; all joined the parent at {spawn_s:.3f}")
    seen = ranks[0].get("profiler", {})
    if seen.get("device_events", 0) > 0:
        check(seen["projection_kernels"] == SPMD_PROFILED,
              f"spmd: the profiler saw {seen['projection_kernels']} projection kernels in "
              f"{SPMD_PROFILED} steps on rank 0")
        rec["device_busy_share_rank0"] = seen["busy_us"] / seen["window_us"]
        rec["profiler_projection_per_step"] = 1
        print(f"[spmd] [{card}] torch.profiler on rank 0: {SPMD_PROFILED} projection kernels in "
              f"{SPMD_PROFILED} steps; device busy {seen['busy_us'] / SPMD_PROFILED:.1f} us of "
              f"{seen['window_us'] / SPMD_PROFILED:.1f} us per step (share "
              f"{rec['device_busy_share_rank0']:.4f}); top device ops, us per step: "
              + ", ".join(f"{k} {v:.1f}" for k, v in seen["per_name"].items()))
    else:
        rec["device_busy_share_rank0"] = None
        rec["profiler_projection_per_step"] = None
        print(f"[spmd] [{card}] torch.profiler saw no device activity on rank 0: the busy share "
              "and the launches by profiler not measured (the wrapper's counts stand)")
    report["spmd"] = rec


MESH_SPMD_JOIN_S = 600


def mesh_spmd_rank(rank: int, world: int, store: str, artifact: str, reqs_file: str,
                   inputs: str, out_dir: str, device: str) -> None:
    """One rank of phases 9 and 10 (a spawned process): ONE gloo process
    group, phase 9's serving on it (``_mesh_serve``), then phase 10's
    training (``_spmd_train``); what it saw goes to ``out_dir``."""
    import pickle
    import traceback

    import torch

    torch.set_num_threads(1)
    marks = {"imported": time.time()}  # wall clock: the parent reads them against its spawn
    try:
        import torch.distributed as dist

        from repro_torch.launch import serve_sharded as ss

        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        marks["joined"] = time.time()
        try:
            out = {"mesh": _mesh_serve(dist.group.WORLD, artifact, reqs_file, device)}
            marks["served"] = time.time()
            out["spmd"] = _spmd_train(dist.group.WORLD, inputs, device, marks)
        finally:
            ss.close_mesh_group(dist.group.WORLD)
    except Exception:  # noqa: BLE001 — the parent reads and raises it
        out = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def mesh_spmd_phase(torch, dev, card: str, report: dict, rank_fn=None) -> None:
    """Phases 9 and 10 on ONE spawn of 16 ranks over gloo, all on ``dev``,
    one cell each: every rank serves phase 9's requests on the halo mesh,
    then trains phase 10's SPMD steps (``mesh_spmd_rank``); the parent
    prepares both phases' inputs and references first and holds the ranks
    to them after (``mesh_check``, ``spmd_check``)."""
    import multiprocessing as mp
    import pickle

    world = MESH_SIDE * MESH_SIDE
    check(SPMD_SIDE * SPMD_SIDE == world, "phases 9 and 10 need one world size")
    t0 = time.perf_counter()
    mesh_in = mesh_inputs(torch, dev)
    spmd_in = spmd_inputs(torch, dev)
    prepare_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        artifact = mesh_in["fitted"].save(os.path.join(tmp, "artifact"))
        reqs_file = os.path.join(tmp, "reqs.npz")
        np.savez(reqs_file, reqs=np.stack(mesh_in["reqs"]))
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **_flat_state(spmd_in["state0"]))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_fn or mesh_spmd_rank,
                             args=(r, world, os.path.join(tmp, "store"), artifact, reqs_file,
                                   inputs, tmp, str(dev)))
                 for r in range(world)]
        t0, spawned = time.perf_counter(), time.time()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(MESH_SPMD_JOIN_S)
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            check(not alive, f"mesh/spmd: ranks {alive} still running after "
                             f"{MESH_SPMD_JOIN_S} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            check(os.path.exists(path), f"mesh/spmd: rank {r} wrote nothing "
                                        f"(exit {procs[r].exitcode})")
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
            check("error" not in ranks[r], f"mesh/spmd: rank {r} failed:\n"
                                           f"{ranks[r].get('error')}")
    check(all(p.exitcode == 0 for p in procs),
          f"mesh/spmd: exit codes {[p.exitcode for p in procs]}")
    print(f"[mesh] [{card}] phases 9 and 10 share one spawn of {world} ranks: inputs and "
          f"one-process references {prepare_s:.3f} s, the spawn (serve, then train) "
          f"{spawn_s:.3f} s")
    mesh_check(card, report, [rk["mesh"] for rk in ranks], mesh_in, spawn_s)
    spmd_check(torch, dev, card, report, [rk["spmd"] for rk in ranks], spmd_in, spawn_s,
               spawned)
    report["mesh"]["prepare_s"] = report["spmd"]["prepare_s"] = prepare_s


# --------------------------------------------------------------------------
# 11. the analysis package's program passes on the card
# --------------------------------------------------------------------------

ANALYSIS_PASSES = ("hlo", "contracts", "costs")
ANALYSIS_TIMEOUT_S = 400
_F64_OP = re.compile(r"^op (\S+) .*out=[^ ]*float64[^ ]* dev=cuda", re.MULTILINE)


def analysis_phase(card: str, report: dict) -> None:
    """Phase 11: ``python -m repro_torch.analysis --passes hlo,contracts,costs
    --device cuda`` as a subprocess from the checkout; the mesh probes of
    hlo and costs share one spawn of 16 gloo ranks on the card. Fails
    unless it exits 0 with no finding in any of the three passes. Prints,
    from its report: the kernel launches a request on every pallas/fused
    lane (the wrappers' counters), the shifts and all-gathers a mesh
    request (the recorder, beside HaloMesh.stats), the host copies a
    request, per-rank peak CUDA memory at P = 4, 9 and 16 with its fitted
    exponent and budget, and the f64 ops the ref lanes ran on the card."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = SRC
    argv = ["-m", "repro_torch.analysis", "--passes", ",".join(ANALYSIS_PASSES),
            "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ANALYSIS_TORCH.json")
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, *argv, "--out", out], cwd=REPO, env=env,
                               capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise SmokeFailure(f"analysis: no exit within {ANALYSIS_TIMEOUT_S} s") from e
        seconds = time.perf_counter() - t0
        check(r.returncode == 0, f"analysis exited {r.returncode}:\n{r.stdout[-4000:]}\n"
              f"{r.stderr[-3000:]}")
        with open(out) as f:
            rep = json.load(f)
    check(rep["findings_per_pass"] == {p: 0 for p in ANALYSIS_PASSES},
          f"analysis: findings {rep['findings_per_pass']}")
    spawns = rep["mesh_probes"]
    check(len(spawns) == 1 and spawns[0]["ranks"] == 16,
          f"analysis: the mesh probes took {spawns}, not one spawn of 16 ranks")
    hlo = rep["passes"]["hlo"]
    check(hlo["device"] == "cuda", f"analysis: hlo ran on {hlo['device']}")
    lanes = {rec["lane"]: rec for rec in hlo["lanes"]}
    kernel_lanes = {name: rec["kernel_dispatches"] for name, rec in lanes.items()
                    if name.endswith(("/pallas", "/fused"))}
    check(len(kernel_lanes) == 16 and set(kernel_lanes.values()) == {1},
          f"analysis: kernel launches a request {kernel_lanes}")
    mesh = {name: rec for name, rec in lanes.items() if name.startswith("mesh/")}
    for name, rec in mesh.items():
        check(rec["collectives"]["collective-permute"] == 4 and rec["collectives"]["all-gather"] == 1
              and rec["mesh_stats"] == {"shifts": 4, "gathers": 1} and rec["ranks"] == 16,
              f"analysis: {name} {rec['collectives']} {rec['mesh_stats']}")
    f64 = {}
    for program, trace in hlo["traces"].items():
        if program.endswith("/ref"):
            names: dict = {}
            for name in _F64_OP.findall(trace):
                names[name] = names.get(name, 0) + 1
            f64[program] = names
    check(all(f64.values()), f"analysis: no f64 op on the card in a ref program {f64}")
    copies = {name: rec["host_copies"] for name, rec in lanes.items()}
    costs = rep["passes"]["costs"]
    mesh_cost = costs["programs"]["mesh-blend/ref"]
    peaks = {lab: mesh_cost["cuda_peak_bytes"][lab] for lab in mesh_cost["axes"]["devices"]}
    budget = costs["budgets"]["mesh-blend"]["max_device_exponent"]
    exponent = mesh_cost["cuda_peak_exponent"]
    check(exponent <= budget, f"analysis: per-rank peak CUDA memory exponent {exponent} > {budget}")
    # api.Server(group=) itself on every rank at P = 4, 9, 16 and m 128,
    # built by the torchrun CLI's front from an artifact: what a rank
    # keeps resident after the load, the build and one request
    server = costs["server_memory"]
    check(sorted(server, key=int) == ["4", "9", "16"], f"analysis: server probe {list(server)}")
    for p_, ranks in server.items():
        for r, res in enumerate(ranks):
            total, per_rank = res["cache_bytes"]
            check(per_rank * int(p_) == total and res["answers"] == 8 * int(p_),
                  f"analysis: P={p_} rank {r} keeps {res}")
    server_exp = costs["server_resident_exponent"]
    check(server_exp is not None and server_exp <= budget,
          f"analysis: Server(group=) resident CUDA memory exponent {server_exp} > {budget}")
    # the shape-derived costs on the card against the committed CPU baseline
    with open(os.path.join(SRC, "repro_torch", "analysis", "analysis_costs.json")) as f:
        base = json.load(f)["programs"]
    ratios = [costs["programs"][name]["points"][lab][metric] / max(ref[metric], 1)
              for name, prog in base.items() for lab, ref in prog["points"].items()
              for metric in ref]
    rec = {
        "seconds": seconds, "mesh_probe_spawn": spawns[0],
        "kernel_launches_per_request": kernel_lanes,
        "mesh_per_request": {name: {op: lane["collectives"][op]
                                    for op in ("collective-permute", "all-gather")}
                             for name, lane in mesh.items()},
        "host_copies_per_request": copies,
        "f64_ops_on_device": f64,
        "mesh_cuda_peak_bytes": peaks,
        "mesh_cuda_peak_exponent": exponent,
        "server_memory": {p_: {k: [r[k] for r in ranks] for k in (
            "cuda_peak_bytes", "cuda_resident_bytes", "cuda_request_peak_bytes")}
            for p_, ranks in server.items()},
        "server_resident_exponent": server_exp,
        "server_cache_bytes": {p_: ranks[0]["cache_bytes"] for p_, ranks in server.items()},
        "mesh_device_exponent_budget": budget,
        "contracts_checked": rep["passes"]["contracts"]["targets_checked"],
        "costs_vs_cpu_baseline": [min(ratios), max(ratios)],
    }
    report["analysis"] = rec
    print(f"[analysis] [{card}] {' '.join(argv)}: exit 0, 0 findings in hlo, contracts and "
          f"costs, {seconds:.3f} s (the mesh probes' one spawn of 16 ranks, "
          f"{spawns[0]['jobs']} jobs: {spawns[0]['seconds']} s from start to the last rank's "
          "exit)")
    print(f"[analysis] [{card}] kernel launches a request (the wrappers' counters): "
          + ", ".join(f"{k} {v}" for k, v in sorted(kernel_lanes.items())))
    print(f"[analysis] [{card}] a mesh request on each of 16 ranks: 4 shifts and 1 all-gather "
          f"on all {len(mesh)} mesh lanes (recorder and HaloMesh.stats)")
    print(f"[analysis] [{card}] device-to-host copies a request: "
          + ", ".join(f"{k} {v}" for k, v in sorted(copies.items())))
    print(f"[analysis] [{card}] per-rank peak CUDA memory over a request (min-max over ranks): "
          + ", ".join(f"P={mesh_cost['axes']['devices'][lab]} {min(v)}-{max(v)} B"
                      for lab, v in peaks.items())
          + f"; fitted exponent vs P {exponent} (budget {budget})")
    print(f"[analysis] [{card}] api.Server(group=) at m {costs['server_m']} on every rank, "
          "built from an artifact by the torchrun CLI's front, after the load, the build and "
          "one request (min-max over ranks): "
          + "; ".join(
              f"P={p_}: peak {min(v['cuda_peak_bytes'])}-{max(v['cuda_peak_bytes'])} B, resident "
              f"{min(v['cuda_resident_bytes'])}-{max(v['cuda_resident_bytes'])} B, the request's "
              f"peak {min(v['cuda_request_peak_bytes'])}-{max(v['cuda_request_peak_bytes'])} B, "
              f"cache bytes (total, a rank) {rec['server_cache_bytes'][p_]}"
              for p_, v in rec["server_memory"].items())
          + f"; resident exponent vs P {server_exp} (budget {budget})")
    print(f"[analysis] [{card}] the shape-derived costs of the ref programs on the card over "
          f"the committed CPU baseline: ratios {min(ratios):.4f}-{max(ratios):.4f} at "
          f"{len(ratios)} (program, point, metric)")
    for program, names in f64.items():
        print(f"[analysis] [{card}] f64 ops on the card in {program} (the plain lane's "
              "declared row sums): " + ", ".join(f"{k} x{v}" for k, v in sorted(names.items())))


# --------------------------------------------------------------------------
# 12. the dense LM substrate at full width: qwen3-0.6b served and trained
# --------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_PARAMS = 596_180_992  # 155.7M embedding (152,064 x 1,024) + 28 layers of 15.73M + the norm
LM_BATCH, LM_PROMPT, LM_GEN = 4, 128, 32
LM_CHECKED = 8  # decode steps held to the uncached forward
# float32: prefill + decode against one uncached forward, both on cuBLAS at
# full width (28 layers, 1,024-wide sums in other orders); the JAX
# package's bound at 4 layers of 128 (tests/test_models.py:100) holds at
# full width too, whose logits are ~0.5 (tied 0.02-scale embeddings)
LM_FP32_ATOL = 2e-4
# bfloat16: the cached and uncached paths each round every activation to
# bf16, so each deviates from the float32 forward by bf16 noise; their gap
# may be at most the sum of two such deviations, the largest measured one
# twice
LM_BF16_FACTOR = 2.0
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_LR = 8, 256, 1e-3
LM_OVERFIT_STEPS, LM_TIMED_STEPS = 8, 20
LM_PROFILED = 8  # decode steps in the profiler window
LM_PROFILED_STEPS = 3  # training steps in the profiler window
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def lm_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs a trained token: 6 x the matmul parameters (every layer's
    projections and MLP, and the tied head's D x V) plus attention's 12 x
    L x H x hd x S (PaLM's count, the causal half not subtracted)."""
    hd = cfg.resolved_head_dim
    layer = (cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
             + cfg.num_heads * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    matmul = cfg.num_layers * layer + cfg.d_model * cfg.padded_vocab_size
    return 6.0 * matmul + 12.0 * cfg.num_layers * cfg.num_heads * hd * seq


def _lm_cache_gap(torch, params, cfg, tokens, frames=None, patches=None) -> tuple[float, object]:
    """max |logits| gap of prefill(S) + LM_CHECKED decode steps (positions
    S - 1 .. S + LM_CHECKED - 1 after a VLM's P prepended patches; an
    encoder-decoder's frames in the prefill, none in decode) against one
    uncached forward over the S + LM_CHECKED tokens (unmasked logits), and
    that forward's logits at those positions."""
    from repro_torch.models.transformer import forward
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    S = tokens.shape[1] - LM_CHECKED
    P = patches.shape[1] if patches is not None else 0
    last, cache = make_prefill_step(cfg, cache_len=P + S + LM_CHECKED)(
        params, tokens[:, :S], frames=frames, patches=patches)
    decode = make_decode_step(cfg)
    got = [last]
    for i in range(LM_CHECKED):
        lg, cache = decode(params, cache, P + S + i, tokens[:, S + i:S + i + 1])
        got.append(lg)
    del cache
    with torch.no_grad():
        full, _, _ = forward(params, cfg, tokens, frames=frames, patches=patches)
    want = full[:, P + S - 1:]
    ok = want > -1e29
    gap = float((torch.stack(got, 1) - want)[ok].abs().max())
    return gap, want


def lm_phase(torch, dev, card: str, report: dict, seed: int) -> None:
    """Phase 12: qwen3-0.6b at full width (bf16 activations, fp32
    parameters) from a torch.Generator on the card seeded from ``seed``.
    Gates: the parameter count; prefill + 8 decode steps against the
    uncached forward in fp32 (LM_FP32_ATOL) and bf16 (LM_BF16_FACTOR x the
    bf16 forward's gap to the fp32 one); 8 AdamW steps on one batch finite
    and falling; 20 synthetic batches finite; the LM CLIs at full width.
    Prints prefill and decode times and rates (launch.serve.generate, the
    second of two runs), peak CUDA memory, the host's share of a decode
    step (torch.profiler), train ms a step p50/p95 on CUDA events,
    tokens/s and the model FLOPs' share of the dense bf16 peak."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch.serve import generate, lm_prompts
    from repro_torch.launch.train import device_batch
    from repro_torch.models.transformer import init_model_params
    from repro_torch.optim import adam_init, tree_leaves
    from repro_torch.runtime.steps import (
        TrainState,
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )

    t_phase = time.perf_counter()
    cfg = get(LM_ARCH)
    rec: dict = {"arch": cfg.name, "dtype": cfg.dtype, "seed": seed}
    gen = torch.Generator(dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_model_params(gen, cfg)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    n_params = sum(a.numel() for a in tree_leaves(params))
    rec["parameters"] = n_params
    check(n_params == LM_PARAMS, f"lm: {n_params} parameters, not {LM_PARAMS}")
    check(all(a.device.type == dev.type and a.dtype == torch.float32 for a in tree_leaves(params)),
          "lm: a parameter is not fp32 on the card")
    print(f"[lm] [{card}] {cfg.name}: {n_params:,} parameters initialised on the card in "
          f"{rec['init_s']:.3f} s (seed {seed})")

    # -- 12a. the KV cache against the uncached forward, fp32 then bf16 ----
    tokens = torch.from_numpy(lm_prompts(cfg, LM_BATCH, LM_PROMPT + LM_CHECKED, seed)).to(dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gap32, full32 = _lm_cache_gap(torch, params, cfg32, tokens)
    gap16, full16 = _lm_cache_gap(torch, params, cfg, tokens)
    ok = full32 > -1e29
    bf16_noise = float((full16 - full32)[ok].abs().max())
    del full32, full16
    rec.update(cache_gap_fp32=gap32, cache_gap_bf16=gap16, bf16_vs_fp32_forward=bf16_noise)
    print(f"[lm] [{card}] prefill({LM_PROMPT}) + {LM_CHECKED} decode steps vs the uncached "
          f"forward, batch {LM_BATCH}: fp32 max|d logits| {gap32:.3e} (bound {LM_FP32_ATOL}); "
          f"bf16 {gap16:.3e} (bound {LM_BF16_FACTOR} x {bf16_noise:.3e}, the bf16 forward's gap "
          "to the fp32 one)")
    check(np.isfinite(gap32) and gap32 <= LM_FP32_ATOL, f"lm: fp32 cache gap {gap32}")
    check(np.isfinite(gap16) and gap16 <= LM_BF16_FACTOR * bf16_noise,
          f"lm: bf16 cache gap {gap16} > {LM_BF16_FACTOR} x {bf16_noise}")

    # -- 12b. serve: launch.serve.generate, bf16, greedy -------------------
    prompts = tokens[:, :LM_PROMPT].contiguous()
    first = generate(params, cfg, prompts, LM_GEN, temperature=0.0)
    torch.cuda.reset_peak_memory_stats()
    out = generate(params, cfg, prompts, LM_GEN, temperature=0.0)
    rec["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    toks = out["tokens"]
    check(tuple(toks.shape) == (LM_BATCH, LM_GEN) and bool((toks >= 0).all())
          and bool((toks < cfg.vocab_size).all()), f"lm: generated {tuple(toks.shape)}")
    rec["greedy_repeat_equal"] = bool(torch.equal(first["tokens"], toks))
    pre_s, dec_s = out["prefill_s"], out["decode_s"]
    rec.update(prefill_ms=1e3 * pre_s, prefill_tok_s=LM_BATCH * LM_PROMPT / pre_s,
               decode_ms_per_step=1e3 * dec_s / (LM_GEN - 1),
               decode_tok_s=LM_BATCH * (LM_GEN - 1) / dec_s,
               first_run_prefill_ms=1e3 * first["prefill_s"],
               first_run_decode_ms_per_step=1e3 * first["decode_s"] / (LM_GEN - 1))
    print(f"[lm] [{card}] serve (launch.serve.generate, bf16, greedy, second run): prefill "
          f"{LM_BATCH}x{LM_PROMPT} in {rec['prefill_ms']:.3f} ms ({rec['prefill_tok_s']:.1f} "
          f"tok/s); decode {rec['decode_ms_per_step']:.3f} ms a step x {LM_GEN - 1} "
          f"({rec['decode_tok_s']:.1f} tok/s); peak CUDA memory {rec['serve_peak_bytes']:,} B; "
          f"first run {rec['first_run_prefill_ms']:.3f} / {rec['first_run_decode_ms_per_step']:.3f}"
          f" ms; greedy tokens equal across runs: {rec['greedy_repeat_equal']}")

    # the host's share of a decode step: torch.profiler over LM_PROFILED steps
    _, cache = make_prefill_step(cfg, cache_len=LM_PROMPT + LM_GEN)(params, prompts)
    decode = make_decode_step(cfg)
    tok = toks[:, :1]
    decode(params, cache, LM_PROMPT, tok)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_PROFILED):
            decode(params, cache, LM_PROMPT + 1 + i, tok)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_name = device_busy(torch, prof, LM_PROFILED)
    ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    del cache
    if busy_us > 0:
        rec["decode_device_busy_share"] = busy_us / window_us
        rec["decode_host_share"] = 1.0 - busy_us / window_us
        rec["decode_device_us_per_step"] = per_name
        rec["decode_device_ops_per_step"] = ops / LM_PROFILED
        print(f"[lm] [{card}] decode step under torch.profiler: device busy "
              f"{busy_us / LM_PROFILED:.1f} us of {window_us / LM_PROFILED:.1f} us (host share "
              f"{rec['decode_host_share']:.4f}), {ops / LM_PROFILED:.0f} device ops a step; "
              "top device ops, us a step: "
              + ", ".join(f"{k} {v:.1f}" for k, v in per_name.items()))
    else:
        rec["decode_host_share"] = None
        print(f"[lm] [{card}] decode step host share: not measured (torch.profiler saw no "
              "device activity)")

    # -- 12c. train: AdamW + clip, bf16 activations, remat per period ------
    state = TrainState(params, adam_init(params), 0)
    del params
    step = make_train_step(cfg, learning_rate=LM_TRAIN_LR)
    toks_np, tg_np = next(synthetic_token_batches(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                                  seed=seed))
    batch = device_batch(toks_np, tg_np, dev)
    losses = []
    for _ in range(LM_OVERFIT_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    rec["overfit_losses"] = losses
    print(f"[lm] [{card}] {LM_OVERFIT_STEPS} steps on one batch ({LM_TRAIN_BATCH}x"
          f"{LM_TRAIN_SEQ}, lr {LM_TRAIN_LR}): losses " + ", ".join(f"{v:.4f}" for v in losses))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"lm: the loss on one repeated batch did not fall: {losses}")

    # two runs of the same step from the same state: bitwise on the card?
    again = [step(state, batch)[0] for _ in range(2)]
    rec["train_step_repeat_bitwise"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(again[0].params),
                                          tree_leaves(again[1].params), strict=True))
    del again
    print(f"[lm] [{card}] the same step twice from the same state, bitwise: "
          f"{rec['train_step_repeat_bitwise']}")

    data = synthetic_token_batches(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=seed,
                                   num_batches=LM_TIMED_STEPS, start_row=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    t0 = time.perf_counter()
    for toks_np, tg_np in data:
        b = device_batch(toks_np, tg_np, dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b)
        end.record()
        events.append((start, end))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(v) for v in torch.stack(losses).cpu()]
    check(all(np.isfinite(losses)), f"lm: a non-finite loss in {losses}")
    flops = lm_flops_per_token(cfg, LM_TRAIN_SEQ)
    p50 = float(np.percentile(ms, 50))
    tok_s = LM_TRAIN_BATCH * LM_TRAIN_SEQ / (p50 / 1e3)
    rec.update(train_ms=_pct(ms), train_tok_s=tok_s,
               train_wall_tok_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ * LM_TIMED_STEPS / wall_s,
               train_peak_bytes=torch.cuda.max_memory_allocated(),
               flops_per_token=flops, bf16_peak_share=tok_s * flops / PEAK_BF16_FLOP_PER_S,
               train_losses=losses)
    print(f"[lm] [{card}] {LM_TIMED_STEPS} steps of synthetic_token_batches through "
          f"launch.train's step ({LM_TRAIN_BATCH}x{LM_TRAIN_SEQ} tokens): p50 {p50:.3f} ms, p95 "
          f"{rec['train_ms']['p95_ms']:.3f} ms (CUDA events), {tok_s:.1f} tok/s at p50 "
          f"({rec['train_wall_tok_s']:.1f} over the host's clock); peak CUDA memory "
          f"{rec['train_peak_bytes']:,} B; model FLOPs a token {flops:.4e} (6N + attention), "
          f"{rec['bf16_peak_share']:.4f} of the dense bf16 peak; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}")
    # where a training step's time goes: torch.profiler over LM_PROFILED_STEPS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILED_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_name = device_busy(torch, prof, LM_PROFILED_STEPS)
    ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us > 0:
        rec["train_device_busy_share"] = busy_us / window_us
        rec["train_device_us_per_step"] = per_name
        rec["train_device_ops_per_step"] = ops / LM_PROFILED_STEPS
        print(f"[lm] [{card}] train step under torch.profiler: device busy "
              f"{busy_us / LM_PROFILED_STEPS:.1f} us of {window_us / LM_PROFILED_STEPS:.1f} us "
              f"(share {rec['train_device_busy_share']:.4f}), "
              f"{rec['train_device_ops_per_step']:.0f} device ops a step; top device ops, us a "
              "step: " + ", ".join(f"{k} {v:.1f}" for k, v in per_name.items()))
    else:
        rec["train_device_busy_share"] = None
        print(f"[lm] [{card}] train step device busy share: not measured (torch.profiler saw "
              "no device activity)")
    # phase 16's real side, on this model: one train and one decode step
    rec["accounting"] = real_step_accounting(torch, cfg, state, step, batch, prompts)
    del state, batch
    torch.cuda.empty_cache()

    # -- 12d. the LM entry points at full width, as subprocesses -----------
    entry_points_phase(card, report, commands=[
        ("lm serve --arch", ["-m", "repro_torch.launch.serve", "--arch", LM_ARCH, "--batch",
                             str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen",
                             str(LM_GEN), "--temperature", "0"]),
        ("lm train --arch", ["-m", "repro_torch.launch.train", "--arch", LM_ARCH, "--steps",
                             "10", "--batch", str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
                             "--lr", "1e-3", "--log-every", "5"]),
        ("lm train examples/lm_train_torch.py --full",
         ["examples/lm_train_torch.py", "--full", "--steps", "20", "--seq", str(LM_TRAIN_SEQ)]),
    ])
    rec["phase_s"] = time.perf_counter() - t_phase
    report["lm"] = rec
    print(f"[lm] [{card}] phase 12: {rec['phase_s']:.3f} s")


# --------------------------------------------------------------------------
# 13. MoE and MLA at the published width: deepseek-moe-16b, qwen3-moe-30b-a3b
#     and minicpm3-4b, depth cut to fit the card
# --------------------------------------------------------------------------

# arch, serve depth and its parameter count, train depth and its count
# (jax.eval_shape(transformer.init_model_params) over repro.configs.get)
P13_MODELS = (
    ("deepseek-moe-16b", 4, 2_267_039_744, 4, 2_267_039_744),
    ("qwen3-moe-30b-a3b", 4, 3_115_338_752, 2, 1_869_097_472),
    ("minicpm3-4b", 62, 4_262_025_728, 12, 1_128_278_528),
)
P13_BATCH, P13_PROMPT, P13_GEN = 4, 128, 16
P13_TRAIN_BATCH, P13_TRAIN_SEQ, P13_TRAIN_LR = 8, 256, 1e-3
P13_OVERFIT_STEPS, P13_TIMED_STEPS = 8, 5
P13_SPMD_RANKS = 2
# the expert-parallel layer against the local one, both fp32 on cuBLAS
# with other batch shapes: JAX's tests/test_moe_spmd.py bound (2e-5) scaled
# by the output's magnitude
P13_SPMD_RTOL = 2e-5
P13_JOIN_S = 240
P13_CLI_TIMEOUT_S = 300


def raised_capacity(cfg):
    """``cfg`` with capacity_factor E / K (Cg >= Tg: no group drops an
    assignment), or ``cfg`` without MoE."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k))


def moe_spmd_config():
    """One deepseek-moe-16b MoE layer at its published width (E 64, top-6,
    d_expert 1,408, 2 shared, d_model 2,048), fp32, capacity raised."""
    from repro_torch.configs import get

    return raised_capacity(dataclasses.replace(get("deepseek-moe-16b"), dtype="float32"))


def moe_spmd_rank(rank: int, world: int, store: str, out_dir: str, seed: int,
                  device: str) -> None:
    """One rank of phase 13's expert-parallel check (a spawned process): the
    same layer and tokens on every rank from one seed, the local path and
    the expert-parallel one over the gloo group, on the card."""
    import pickle
    import traceback

    import torch

    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from repro_torch.models import moe

        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        try:
            dev = torch.device(device)
            cfg = moe_spmd_config()
            gen = torch.Generator(dev).manual_seed(seed)
            p = moe.init_moe_params(gen, cfg)
            x = torch.randn((P13_BATCH, P13_PROMPT, cfg.d_model), generator=gen, device=dev)
            with torch.no_grad():
                want, waux = moe._moe_forward_local(p, cfg, x)
                moe.reset_collectives()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                got, aux = moe.moe_forward(p, cfg, x, group=dist.group.WORLD)
                torch.cuda.synchronize(dev)
                seconds = time.perf_counter() - t0
            out = {"max_abs_err": float((got - want).abs().max()),
                   "scale": float(want.abs().max()), "aux": float(aux), "local_aux": float(waux),
                   "collectives": dict(moe.COLLECTIVES), "seconds": seconds}
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — a rank reports its failure to the parent
        out = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def moe_spmd_check(dev, card: str, seed: int, rank_fn=None) -> dict:
    """2 spawned gloo ranks on the card, 32 experts each: the layer's
    output within P13_SPMD_RTOL of the local path, aux equal, 1 all-reduce
    a forward."""
    import multiprocessing as mp
    import pickle

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_fn or moe_spmd_rank,
                             args=(r, P13_SPMD_RANKS, os.path.join(tmp, "store"), tmp, seed,
                                   str(dev)))
                 for r in range(P13_SPMD_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(P13_JOIN_S)
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            check(not alive, f"moe spmd: ranks {alive} still running after {P13_JOIN_S} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        ranks = []
        for r in range(P13_SPMD_RANKS):
            path = os.path.join(tmp, f"rank{r}.pkl")
            check(os.path.exists(path), f"moe spmd: rank {r} wrote nothing "
                                        f"(exit {procs[r].exitcode})")
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
            check("error" not in ranks[r], f"moe spmd: rank {r} failed:\n{ranks[r].get('error')}")
    spawn_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        bound = P13_SPMD_RTOL * max(1.0, res["scale"])
        check(res["max_abs_err"] <= bound,
              f"moe spmd: rank {r} |d out| {res['max_abs_err']} > {bound}")
        check(res["aux"] == res["local_aux"], f"moe spmd: rank {r} aux {res['aux']} != "
                                              f"{res['local_aux']}")
        check(res["collectives"] == {"forward_all_reduce": 1, "backward_all_reduce": 0},
              f"moe spmd: rank {r} collectives {res['collectives']}")
    rec = {"ranks": P13_SPMD_RANKS, "tokens": P13_BATCH * P13_PROMPT, "spawn_s": spawn_s,
           "max_abs_err": max(r["max_abs_err"] for r in ranks),
           "out_scale": max(r["scale"] for r in ranks),
           "forward_s": [r["seconds"] for r in ranks],
           "all_reduces_per_forward": ranks[0]["collectives"]["forward_all_reduce"]}
    print(f"[moe-mla] [{card}] expert-parallel deepseek-moe-16b layer (E 64, 32 experts a rank) "
          f"on {P13_SPMD_RANKS} gloo ranks, {rec['tokens']} tokens, fp32: max|d out| vs the "
          f"local path {rec['max_abs_err']:.3e} (bound {P13_SPMD_RTOL} x max(1, "
          f"{rec['out_scale']:.3f})), aux equal, 1 all-reduce a forward; forward "
          + ", ".join(f"{s * 1e3:.3f}" for s in rec["forward_s"]) + " ms a rank (gloo through "
          f"host memory); {spawn_s:.3f} s for the spawn")
    return rec


def _p13_serve(torch, dev, card: str, cfg, params, seed: int, rec: dict,
               tag: str = "moe-mla") -> None:
    """The cache gates, the dropped share, serve times and the host share
    of a decode step, for one model (an encoder-decoder's seeded frames
    through the encoder at the prefill, a VLM's seeded patches
    prepended)."""
    from repro_torch.launch.serve import generate, lm_request
    from repro_torch.models import moe
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    name = cfg.name
    # the cache against the uncached forward, fp32 then bf16, at a capacity
    # no group can overflow (a capacity drop differs by design between a
    # T-token prefill and a 1-token decode step)
    gate_cfg = raised_capacity(cfg)
    tokens, frames, patches = lm_request(cfg, P13_BATCH, P13_PROMPT + LM_CHECKED, seed)
    tokens = torch.from_numpy(tokens).to(dev)
    P = 0
    if frames is not None:
        frames = torch.from_numpy(frames).to(dev)
        rec["frames"] = list(frames.shape)
    if patches is not None:
        patches = torch.from_numpy(patches).to(dev)
        P = patches.shape[1]
        rec["patches"] = list(patches.shape)
    gap32, full32 = _lm_cache_gap(torch, params, dataclasses.replace(gate_cfg, dtype="float32"),
                                  tokens, frames, patches)
    gap16, full16 = _lm_cache_gap(torch, params, gate_cfg, tokens, frames, patches)
    ok = full32 > -1e29
    noise = float((full16 - full32)[ok].abs().max())
    scale = float(full32[ok].abs().max())
    del full32, full16
    bound32 = LM_FP32_ATOL * max(1.0, scale)
    rec.update(cache_gap_fp32=gap32, cache_gap_bf16=gap16, bf16_vs_fp32_forward=noise,
               logits_scale=scale, cache_capacity_factor=(gate_cfg.moe.capacity_factor
                                                           if cfg.moe else None))
    print(f"[{tag}] [{card}] {name}: prefill({P13_PROMPT}) + {LM_CHECKED} decode steps vs the "
          f"uncached forward, batch {P13_BATCH}"
          + (f", {frames.shape[1]} frames x {frames.shape[2]} through the encoder at the "
             "prefill (decode without them)" if frames is not None else "")
          + (f", {P} patches x {patches.shape[2]} prepended (cache {P} + {P13_PROMPT} + "
             f"{LM_CHECKED} positions)" if P else "")
          + (f", capacity raised to E/K = {gate_cfg.moe.capacity_factor:.4f}" if cfg.moe else "")
          + f": fp32 max|d logits| {gap32:.3e} (bound {LM_FP32_ATOL} x max(1, {scale:.3f})); "
          f"bf16 {gap16:.3e} (bound {LM_BF16_FACTOR} x {noise:.3e}, the bf16 forward's gap to "
          "the fp32 one)")
    check(np.isfinite(gap32) and gap32 <= bound32, f"{name}: fp32 cache gap {gap32} > {bound32}")
    check(np.isfinite(gap16) and gap16 <= LM_BF16_FACTOR * noise,
          f"{name}: bf16 cache gap {gap16} > {LM_BF16_FACTOR} x {noise}")
    prompts = tokens[:, :P13_PROMPT].contiguous()
    if cfg.moe is not None:
        # the prefill's dropped share at the published capacity factor
        with torch.no_grad(), moe.routing_log() as log:
            make_prefill_step(cfg, cache_len=P13_PROMPT)(params, prompts)
        kept = float(torch.stack([k for k, _ in log]).sum())
        total = sum(n for _, n in log)
        rec["prefill_dropped_share"] = 1.0 - kept / total
        print(f"[moe-mla] [{card}] {name}: prefill {P13_BATCH}x{P13_PROMPT} at capacity factor "
              f"{cfg.moe.capacity_factor}: {total - kept:.0f} of {total} (token, expert) "
              f"assignments dropped over {len(log)} MoE layers (share "
              f"{rec['prefill_dropped_share']:.4f})")
    first = generate(params, cfg, prompts, P13_GEN, temperature=0.0, frames=frames,
                     patches=patches)
    torch.cuda.reset_peak_memory_stats()
    out = generate(params, cfg, prompts, P13_GEN, temperature=0.0, frames=frames,
                   patches=patches)
    rec["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    toks = out["tokens"]
    check(tuple(toks.shape) == (P13_BATCH, P13_GEN) and bool((toks >= 0).all())
          and bool((toks < cfg.vocab_size).all()), f"{name}: generated {tuple(toks.shape)}")
    pre_s, dec_s = out["prefill_s"], out["decode_s"]
    rec.update(prefill_ms=1e3 * pre_s, prefill_tok_s=P13_BATCH * P13_PROMPT / pre_s,
               decode_ms_per_step=1e3 * dec_s / (P13_GEN - 1),
               decode_tok_s=P13_BATCH * (P13_GEN - 1) / dec_s,
               greedy_repeat_equal=bool(torch.equal(first["tokens"], toks)))
    _, cache = make_prefill_step(cfg, cache_len=P + P13_PROMPT + P13_GEN)(
        params, prompts, frames=frames, patches=patches)
    decode = make_decode_step(cfg)
    tok = toks[:, :1]
    decode(params, cache, P + P13_PROMPT, tok)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_PROFILED):
            decode(params, cache, P + P13_PROMPT + 1 + i, tok)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    busy_us, _ = device_busy(torch, prof, LM_PROFILED)
    del cache
    rec["decode_host_share"] = 1.0 - busy_us / window_us if busy_us > 0 else None
    share = ("not measured (torch.profiler saw no device activity)"
             if rec["decode_host_share"] is None else f"{rec['decode_host_share']:.4f}")
    print(f"[{tag}] [{card}] {name}: serve (launch.serve.generate, bf16, greedy, second run) "
          f"prefill {P13_BATCH}x{P13_PROMPT}" + (f" after {P} patches" if P else "")
          + f" in {rec['prefill_ms']:.3f} ms ({rec['prefill_tok_s']:.1f} tok/s); decode "
          f"{rec['decode_ms_per_step']:.3f} ms a step x {P13_GEN - 1} ({rec['decode_tok_s']:.1f} tok/s); decode host share {share} "
          f"(torch.profiler, {LM_PROFILED} steps); peak CUDA memory {rec['serve_peak_bytes']:,} B")


def _p13_train(torch, dev, card: str, cfg, holder: list, seed: int, rec: dict,
               tag: str = "moe-mla") -> None:
    """8 AdamW steps on one batch (the loss falls), then P13_TIMED_STEPS
    timed on CUDA events, remat on; an encoder-decoder's batches carry the
    train CLI's seeded frames. ``holder`` hands over the parameters (a
    list of one tree, emptied here, so that no caller keeps them)."""
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch.train import device_batch, stub_stream
    from repro_torch.optim import adam_init, tree_leaves
    from repro_torch.runtime.steps import TrainState, make_train_step

    name = cfg.name
    params = holder.pop()
    state = TrainState(params, adam_init(params), 0)
    del params
    step = make_train_step(cfg, learning_rate=P13_TRAIN_LR)
    toks_np, tg_np = next(synthetic_token_batches(cfg.vocab_size, P13_TRAIN_BATCH,
                                                  P13_TRAIN_SEQ, seed=seed))
    stubs = stub_stream(cfg, P13_TRAIN_BATCH, seed)
    fr, pt = next(stubs)
    batch = device_batch(toks_np, tg_np, dev, frames=fr, patches=pt)
    losses, auxes = [], []
    for _ in range(P13_OVERFIT_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
        auxes.append(m["aux"])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    rec["overfit_losses"] = losses
    rec["overfit_aux"] = [float(v) for v in torch.stack(auxes).cpu()]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{name}: the loss on one repeated batch did not fall: {losses}")
    if cfg.moe is not None:
        check(all(a > 0 for a in rec["overfit_aux"]), f"{name}: aux {rec['overfit_aux']}")
        # the same step twice from the same state: per-leaf int64 sums of the
        # new parameters' float32 bit patterns (a second state would not
        # fit beside the first at this size)
        prints = []
        for _ in range(2):
            nxt, _ = step(state, batch)
            prints.append(torch.stack([leaf.view(torch.int32).sum(dtype=torch.int64)
                                       for leaf in tree_leaves(nxt.params)]).cpu())
            del nxt
        rec["train_step_repeat_bitwise"] = bool(torch.equal(*prints))
    data = synthetic_token_batches(cfg.vocab_size, P13_TRAIN_BATCH, P13_TRAIN_SEQ, seed=seed,
                                   num_batches=P13_TIMED_STEPS, start_row=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, tl = [], []
    for (toks_np, tg_np), (fr, pt) in zip(data, stubs):
        b = device_batch(toks_np, tg_np, dev, frames=fr, patches=pt)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b)
        end.record()
        events.append((start, end))
        tl.append(m["loss"])
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    tl = [float(v) for v in torch.stack(tl).cpu()]
    check(all(np.isfinite(tl)), f"{name}: a non-finite loss in {tl}")
    p50 = float(np.percentile(ms, 50))
    rec.update(train_ms=_pct(ms), train_tok_s=P13_TRAIN_BATCH * P13_TRAIN_SEQ / (p50 / 1e3),
               train_peak_bytes=torch.cuda.max_memory_allocated(), train_losses=tl)
    del state, batch
    print(f"[{tag}] [{card}] {name}: train (AdamW lr {P13_TRAIN_LR}, remat, bf16, "
          f"{P13_TRAIN_BATCH}x{P13_TRAIN_SEQ}"
          + (f", {fr.shape[1]} frames x {fr.shape[2]} a sequence" if fr is not None else "")
          + f"): {P13_OVERFIT_STEPS} steps on one batch, losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + (f" (aux {rec['overfit_aux'][0]:.4f} .. {rec['overfit_aux'][-1]:.4f}; the same step "
             "twice, the bit patterns' per-leaf sums equal: "
             f"{rec['train_step_repeat_bitwise']})" if cfg.moe else "")
          + f"; {P13_TIMED_STEPS} timed steps p50 {p50:.3f} ms (CUDA events), "
          f"{rec['train_tok_s']:.1f} tok/s, peak CUDA memory {rec['train_peak_bytes']:,} B")


def p13_cli_commands() -> list:
    """(label, argv after the interpreter): launch.serve --arch and
    launch.train --arch at --smoke for each of phase 13's, phase 14's and
    phase 15's architectures (one concurrent batch, run in phase 13)."""
    cmds = []
    for arch in [a for a, *_ in P13_MODELS] + list(P14_ARCHS) + list(P15_ARCHS):
        cmds.append((f"serve --arch {arch} --smoke",
                     ["-m", "repro_torch.launch.serve", "--arch", arch, "--smoke", "--gen", "8",
                      "--temperature", "0"]))
        cmds.append((f"train --arch {arch} --smoke",
                     ["-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--steps", "4",
                      "--log-every", "2"]))
    return cmds


def moe_mla_phase(torch, dev, card: str, report: dict, seed: int) -> None:
    """Phase 13: deepseek-moe-16b (depth 4), qwen3-moe-30b-a3b (serve depth
    4, train depth 2) and minicpm3-4b (serve 62, the full depth; train 12)
    at their published widths, random from ``seed`` on the card, each cut
    by ``dataclasses.replace(cfg, num_layers=n)``. Gates: the parameter
    counts; prefill + 8 decode steps against the uncached forward in fp32
    (LM_FP32_ATOL x max(1, max|logits|)) and bf16 (LM_BF16_FACTOR x the
    bf16 forward's gap to fp32), MoE at capacity E/K; 8 AdamW steps on one
    batch falling (aux > 0 with MoE); the expert-parallel MoE layer on 2
    gloo ranks against the local path; the LM CLIs at --smoke for the three
    architectures. Prints the prefill's dropped share at the published
    capacity, prefill and decode tok/s, the decode step's host share,
    train ms p50 on CUDA events, tok/s and peak CUDA memory."""
    from repro_torch.configs import get
    from repro_torch.models.transformer import init_model_params
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    out: dict = {"models": {}}

    def build(full, n: int, want: int, what: str, rec: dict):
        cfg = dataclasses.replace(full, num_layers=n)
        t0 = time.perf_counter()
        params = init_model_params(torch.Generator(dev).manual_seed(seed), cfg)
        torch.cuda.synchronize()
        got = sum(a.numel() for a in tree_leaves(params))
        rec["train_parameters" if what == "train" else "serve_parameters"] = got
        check(got == want, f"{full.name}: {got} parameters at depth {n}, not {want}")
        cut = "" if n == full.num_layers else \
            f", cut from {full.num_layers} layers (dataclasses.replace(cfg, num_layers={n}))"
        print(f"[moe-mla] [{card}] {full.name} at depth {n}{cut}: {got:,} parameters "
              f"initialised on the card in {time.perf_counter() - t0:.3f} s (seed {seed}; "
              f"{what})")
        return cfg, params

    for arch, serve_n, serve_params, train_n, train_params in P13_MODELS:
        full = get(arch)
        rec: dict = {"published_layers": full.num_layers, "serve_layers": serve_n,
                     "train_layers": train_n, "dtype": full.dtype}
        cfg, params = build(full, serve_n, serve_params, "serve and train" if
                            train_n == serve_n else "serve", rec)
        if train_n == serve_n:
            rec["train_parameters"] = rec["serve_parameters"]
        _p13_serve(torch, dev, card, cfg, params, seed, rec)
        if train_n != serve_n:
            del params
            torch.cuda.empty_cache()
            cfg, params = build(full, train_n, train_params, "train", rec)
        holder = [params]
        del params  # the training state takes them over: AdamW replaces them step by step
        _p13_train(torch, dev, card, cfg, holder, seed, rec)
        torch.cuda.empty_cache()
        out["models"][arch] = rec
    out["moe_spmd"] = moe_spmd_check(dev, card, seed)

    # the LM CLIs of the three architectures at --smoke, all at once
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = SRC
    cmds = p13_cli_commands()
    t0 = time.perf_counter()
    procs = [(label, subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for label, argv in cmds]
    out["clis"] = {}
    try:
        for label, proc in procs:
            try:
                so, se = proc.communicate(timeout=max(1.0, t0 + P13_CLI_TIMEOUT_S
                                                      - time.perf_counter()))
            except subprocess.TimeoutExpired as e:
                raise SmokeFailure(f"{label}: no exit within {P13_CLI_TIMEOUT_S} s") from e
            check(proc.returncode == 0, f"{label} exited {proc.returncode}:\n{se[-3000:]}")
            if label.startswith("serve"):
                check(_LM_SERVE.search(so) is not None, f"{label}: no prefill/decode report")
            else:
                losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", so)]
                check(len(losses) == 2 and all(np.isfinite(losses)) and "done." in so,
                      f"{label}: losses {losses}")
            out["clis"][label] = "exit 0"
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    out["clis_s"] = time.perf_counter() - t0
    print(f"[moe-mla] [{card}] the LM CLIs at --smoke, {len(cmds)} at once: "
          + ", ".join(out["clis"]) + f" exit 0 in {out['clis_s']:.3f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    report["moe_mla"] = out
    print(f"[moe-mla] [{card}] phase 13: {out['phase_s']:.3f} s")


# --------------------------------------------------------------------------
# 14. xLSTM and the vision stub at the published width: xlstm-350m uncut,
#     internvl2-76b served at 4 of its 80 layers
# --------------------------------------------------------------------------

# jax.eval_shape(transformer.init_model_params) over repro.configs.get
P14_ARCHS = ("xlstm-350m", "internvl2-76b")
P14_XLSTM_PARAMS = 590_423_200
P14_VLM_LAYERS = 4
P14_VLM_PARAMS = 5_617_295_360
# internvl2-76b is not trained on the card at its published width: 1 layer
# is 3,050,332,160 parameters, and the functional AdamW's step holds ~30 B
# a parameter (deepseek-moe-16b's 2.27 B peaked at 68.6 GB), ~92 GB


def xlstm_vlm_phase(torch, dev, card: str, report: dict, seed: int) -> None:
    """Phase 14: xlstm-350m uncut (24 layers, 5 mLSTM : 1 sLSTM) and
    internvl2-76b at 4 of 80 layers (``dataclasses.replace(cfg,
    num_layers=4)``), random from ``seed`` on the card. Gates: the
    parameter counts; prefill(128) + 8 decode steps against the uncached
    forward, batch 4, in fp32 (LM_FP32_ATOL x max(1, max|logits|)) and
    bf16 (LM_BF16_FACTOR x the bf16 forward's gap to fp32), internvl2's
    with 256 seeded 3,200-wide patches prepended; xlstm-350m's 8 AdamW
    steps on one 8 x 256 batch falling. Prints serve times and the decode
    step's host share, xlstm-350m's train ms p50 on CUDA events and peak
    CUDA memory. The two architectures' CLIs at --smoke run in phase 13's
    concurrent batch (``p13_cli_commands``)."""
    from repro_torch.configs import get
    from repro_torch.models.transformer import init_model_params
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    out: dict = {"models": {}}
    for arch, layers, want, train in (("xlstm-350m", None, P14_XLSTM_PARAMS, True),
                                      ("internvl2-76b", P14_VLM_LAYERS, P14_VLM_PARAMS, False)):
        full = get(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        rec: dict = {"published_layers": full.num_layers, "layers": cfg.num_layers,
                     "dtype": cfg.dtype}
        t0 = time.perf_counter()
        params = init_model_params(torch.Generator(dev).manual_seed(seed), cfg)
        torch.cuda.synchronize()
        got = sum(a.numel() for a in tree_leaves(params))
        rec["parameters"] = got
        check(got == want, f"{arch}: {got} parameters at depth {cfg.num_layers}, not {want}")
        cut = "uncut" if layers is None else \
            f"cut from {full.num_layers} layers (dataclasses.replace(cfg, num_layers={layers}))"
        print(f"[xlstm-vlm] [{card}] {arch} at depth {cfg.num_layers}, {cut}: {got:,} parameters "
              f"initialised on the card in {time.perf_counter() - t0:.3f} s (seed {seed})")
        _p13_serve(torch, dev, card, cfg, params, seed, rec, tag="xlstm-vlm")
        if train:
            holder = [params]
            del params  # the training state takes them over
            _p13_train(torch, dev, card, cfg, holder, seed, rec, tag="xlstm-vlm")
        else:
            del params
            rec["trained_on_the_card"] = False
            print(f"[xlstm-vlm] [{card}] {arch}: not trained on the card at the published width "
                  "(one layer is 3,050,332,160 parameters, ~92 GB for the functional AdamW "
                  "step); its training is held to JAX's on the CPU and runs here at --smoke "
                  "through launch.train")
        torch.cuda.empty_cache()
        out["models"][arch] = rec
    out["phase_s"] = time.perf_counter() - t_phase
    report["xlstm_vlm"] = out
    print(f"[xlstm-vlm] [{card}] phase 14: {out['phase_s']:.3f} s")


# --------------------------------------------------------------------------
# 15. RG-LRU and the encoder-decoder at the published width:
#     recurrentgemma-2b served uncut and trained at 4 layers, whisper-base
#     uncut
# --------------------------------------------------------------------------

# jax.eval_shape(transformer.init_model_params) over repro.configs.get
P15_ARCHS = ("recurrentgemma-2b", "whisper-base")
P15_RG_PARAMS = 3_549_795_840
P15_RG_TRAIN_LAYERS = 4  # one period of (rglru, rglru, local_attn) and a remainder rglru
P15_RG_TRAIN_PARAMS = 1_659_432_960
P15_WHISPER_PARAMS = 100_167_680
# recurrentgemma-2b is trained at 4 of its 26 layers: the functional AdamW
# holds ~30 B a parameter (~106 GB at full depth with the fp32 passes over
# the (8, 256, 256,000) logits), ~50 GB at 4
P15_START_BYTES = 1 << 30  # what an earlier phase may still hold on the card


def rglru_encdec_phase(torch, dev, card: str, report: dict, seed: int) -> None:
    """Phase 15: recurrentgemma-2b served at its published 26 layers (8
    periods of (rglru, rglru, local_attn) and 2 trailing rglru) and
    trained at 4 (``dataclasses.replace(cfg, num_layers=4)``), and
    whisper-base uncut (6 encoder and 6 decoder layers, 1,500 seeded stub
    frames x 512, no enc_proj at this width), random from ``seed`` on the
    card. Gates: the card holds under 1 GiB at the start; the parameter
    counts; prefill(128) + 8 decode steps against the uncached forward,
    batch 4, fp32 and bf16 (phase 13's bounds; whisper's prefill with its
    frames, decode without them); 8 AdamW steps on one 8 x 256 batch
    falling. Prints serve times and the decode step's host share, train ms
    p50 on CUDA events, tok/s and peak CUDA memory. The two architectures'
    CLIs at --smoke run in phase 13's concurrent batch."""
    from repro_torch.configs import get
    from repro_torch.models.transformer import init_model_params
    from repro_torch.optim import tree_leaves

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    print(f"[rglru-encdec] [{card}] CUDA memory allocated at the phase's start: {held:,} B "
          f"(the card: {free:,} of {total:,} B free)")
    check(held < P15_START_BYTES, f"phase 15 starts with {held} B on the card (an earlier "
          f"phase's tensors; limit {P15_START_BYTES})")
    out: dict = {"start_allocated_bytes": held, "start_free_bytes": free, "models": {}}

    def build(full, layers: int, want: int, what: str):
        cfg = dataclasses.replace(full, num_layers=layers)
        t0 = time.perf_counter()
        params = init_model_params(torch.Generator(dev).manual_seed(seed), cfg)
        torch.cuda.synchronize()
        got = sum(a.numel() for a in tree_leaves(params))
        check(got == want, f"{full.name}: {got} parameters at depth {layers}, not {want}")
        cut = "uncut" if layers == full.num_layers else \
            f"cut from {full.num_layers} layers (dataclasses.replace(cfg, num_layers={layers}))"
        print(f"[rglru-encdec] [{card}] {full.name} at depth {layers}, {cut}: {got:,} parameters "
              f"initialised on the card in {time.perf_counter() - t0:.3f} s (seed {seed}; "
              f"{what})")
        return cfg, params, got

    # recurrentgemma-2b: served uncut, trained at 4 layers
    full = get("recurrentgemma-2b")
    rec: dict = {"published_layers": full.num_layers, "serve_layers": full.num_layers,
                 "train_layers": P15_RG_TRAIN_LAYERS, "dtype": full.dtype}
    cfg, params, rec["serve_parameters"] = build(full, full.num_layers, P15_RG_PARAMS, "serve")
    _p13_serve(torch, dev, card, cfg, params, seed, rec, tag="rglru-encdec")
    del params
    torch.cuda.empty_cache()
    cfg, params, rec["train_parameters"] = build(full, P15_RG_TRAIN_LAYERS, P15_RG_TRAIN_PARAMS,
                                                 "train")
    holder = [params]
    del params  # the training state takes them over
    _p13_train(torch, dev, card, cfg, holder, seed, rec, tag="rglru-encdec")
    torch.cuda.empty_cache()
    out["models"]["recurrentgemma-2b"] = rec

    # whisper-base: uncut, served and trained
    full = get("whisper-base")
    rec = {"published_layers": full.num_layers, "encoder_layers": full.encoder.num_layers,
           "dtype": full.dtype}
    cfg, params, rec["parameters"] = build(full, full.num_layers, P15_WHISPER_PARAMS,
                                           "serve and train")
    check(("enc_proj" in params) == (cfg.encoder.frontend_dim != cfg.d_model),
          "whisper-base: enc_proj exists only where frontend_dim != d_model")
    _p13_serve(torch, dev, card, cfg, params, seed, rec, tag="rglru-encdec")
    holder = [params]
    del params
    _p13_train(torch, dev, card, cfg, holder, seed, rec, tag="rglru-encdec")
    torch.cuda.empty_cache()
    out["models"]["whisper-base"] = rec

    out["phase_s"] = time.perf_counter() - t_phase
    report["rglru_encdec"] = out
    print(f"[rglru-encdec] [{card}] phase 15: {out['phase_s']:.3f} s")


# --------------------------------------------------------------------------
# 16. the dry-run: the JAX tests' cases on the production meshes (fake
#     tensors over a fake process group, on the host), and the tracer's
#     accounting held against phase 12's steps on the card
# --------------------------------------------------------------------------

P16_CASES = (  # tests/test_dryrun.py:16-21, and its PSVGP case
    ("qwen3_0_6b", "train_4k", ()),
    ("recurrentgemma_2b", "long_500k", ()),
    ("whisper_base", "decode_32k", ()),
    ("deepseek_moe_16b", "prefill_32k", ("--multi-pod",)),
    ("psvgp", "ppermute", ()),
)
P16_TIMEOUT_S = 300
# the trace's peak_est over the real step's own CUDA peak (the card's other
# live bytes taken off): the band measured on the H100 (PERF.md §6)
P16_PEAK_BAND = (0.95, 1.05)
P16_ROOFLINE_SLACK = 1.05


def real_step_accounting(torch, cfg, state, step, batch, prompts) -> dict:
    """Phase 16's real side on phase 12's model: one train step on ``batch``
    and one decode step (batch LM_BATCH against a cache of LM_PROMPT +
    LM_GEN positions, the position a device tensor) under
    ``FlopCounterMode``: their FLOPs, their inputs' bytes and the CUDA
    memory each step peaks at, less the bytes live on the card beside its
    inputs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.hlo_analysis import _tensors
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in _tensors(tree))

    def measure(fn, args) -> dict:
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - nbytes(args)
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as counter:
            out = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - other
        del out
        return {"flops": counter.get_total_flops(), "arguments": nbytes(args),
                "peak_bytes": peak}

    out = {"train": measure(step, (state, batch))}
    _, cache = make_prefill_step(cfg, cache_len=LM_PROMPT + LM_GEN)(state.params, prompts)
    pos = torch.tensor(LM_PROMPT, device=prompts.device)
    out["decode"] = measure(make_decode_step(cfg),
                            (state.params, cache, pos, prompts[:, :1].contiguous()))
    return out


def p16_commands(out_dir: str) -> list:
    cmds = []
    for arch, shape, extra in P16_CASES:
        out = os.path.join(out_dir, f"{arch}.{shape}.jsonl")
        args = (["--psvgp", "--comm", shape] if arch == "psvgp"
                else ["--arch", arch, "--shape", shape, *extra])
        cmds.append(((arch, shape, extra), out,
                     [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", out]))
    return cmds


def p16_check_record(case, rec: dict) -> str:
    """JAX's tests/test_dryrun.py asserts on one record; a line for the log."""
    arch, shape, extra = case
    check(rec["flops_per_device"] > 0 or arch == "psvgp", f"dryrun {case}: no FLOPs")
    check(rec["roofline_s"]["memory"] > 0, f"dryrun {case}: no memory term")
    check(rec["dominant"] in ("compute", "memory", "collective"), f"dryrun {case}: dominant")
    if extra:
        check(rec["chips"] == 512, f"dryrun {case}: {rec['chips']} chips, not 512")
    if arch == "psvgp":
        check(rec["chips"] == 256, f"dryrun psvgp: {rec['chips']} chips")
        check("collective-permute" in rec["collective_breakdown"],
              f"dryrun psvgp: no collective-permute in {rec['collective_breakdown']}")
        check(rec["collective_bytes_per_device"] < 10e6,
              f"dryrun psvgp: {rec['collective_bytes_per_device']} collective bytes a device")
    else:
        check(rec["arch"] == arch and rec["shape"] == shape, f"dryrun {case}: record {rec}")
    mem = rec["bytes_per_device"]
    return (f"{rec['arch']} {rec['shape']} on {rec['mesh']} ({rec['chips']} ranks): traced in "
            f"{rec['compile_s']} s, peak_est {mem['peak_est'] / 1e9:.3f} GB a device, "
            f"{rec['flops_per_device']:.4e} FLOPs a device, collectives "
            f"{rec['collective_breakdown']}, dominant {rec['dominant']}")


def dryrun_phase(torch, dev, card: str, report: dict) -> None:
    """Phase 16 (see the module docstring)."""
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import svgp_proj
    from repro_torch.kernels import launches as kernel_launches
    from repro_torch.launch import dryrun, hlo_analysis, pins
    from repro_torch.launch.mesh import MeshSpec, make_production_mesh

    t_phase = time.perf_counter()
    rec: dict = {}
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        # -- 16a. the JAX tests' cases, concurrent subprocesses on the host
        procs = []
        for case, out, cmd in p16_commands(tmp):
            with open(out + ".log", "w") as log:
                procs.append((case, out, subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                                          stderr=subprocess.STDOUT)))
        try:
            # -- 16b. the accounting against phase 12's steps on the card ---
            real = report["lm"]["accounting"]
            cfg = get(LM_ARCH)
            mesh1 = MeshSpec(("data", "model"), (1, 1))
            shapes = {"train": InputShape(LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"),
                      "decode": InputShape(LM_PROMPT + LM_GEN, LM_BATCH, "decode")}
            measured_ms = {"train": report["lm"]["train_ms"]["p50_ms"],
                           "decode": report["lm"]["decode_ms_per_step"]}
            for kind, sh in shapes.items():
                t0 = time.perf_counter()
                trace = dryrun.trace_combo(cfg, sh, mesh1)
                trace_s = time.perf_counter() - t0
                terms = hlo_analysis.roofline(trace)
                bound_ms = 1e3 * max(terms.compute_s, terms.memory_s, terms.collective_s)
                mem = trace.memory()
                ratio = mem["peak_est"] / real[kind]["peak_bytes"]
                rec[kind] = {"trace_s": trace_s, "trace_flops": trace.flops,
                             "real_flops": real[kind]["flops"],
                             "trace_arguments": trace.arguments,
                             "real_arguments": real[kind]["arguments"],
                             "peak_est": mem["peak_est"], "real_peak": real[kind]["peak_bytes"],
                             "peak_ratio": ratio, "roofline_ms": {
                                 "compute": 1e3 * terms.compute_s, "memory": 1e3 * terms.memory_s,
                                 "collective": 1e3 * terms.collective_s},
                             "measured_ms": measured_ms[kind]}
                print(f"[dryrun] [{card}] {LM_ARCH} {kind} {sh.global_batch}x{sh.seq_len} on a "
                      f"1x1 mesh, traced in {trace_s:.3f} s: FLOPs {trace.flops:,} (FlopCounterMode"
                      f" on the card {real[kind]['flops']:,}); arguments {trace.arguments:,} B "
                      f"(real {real[kind]['arguments']:,}); peak_est {mem['peak_est']:,} B against"
                      f" the step's CUDA peak {real[kind]['peak_bytes']:,} B (ratio {ratio:.4f}, "
                      f"band {P16_PEAK_BAND}); roofline compute {1e3 * terms.compute_s:.3f} / "
                      f"memory {1e3 * terms.memory_s:.3f} / collective "
                      f"{1e3 * terms.collective_s:.3f} ms against {measured_ms[kind]:.3f} ms "
                      "measured (phase 12, p50)")
                check(trace.flops == real[kind]["flops"],
                      f"dryrun {kind}: trace FLOPs {trace.flops} != {real[kind]['flops']}")
                check(trace.arguments == real[kind]["arguments"],
                      f"dryrun {kind}: arguments {trace.arguments} != {real[kind]['arguments']}")
                check(P16_PEAK_BAND[0] <= ratio <= P16_PEAK_BAND[1],
                      f"dryrun {kind}: peak ratio {ratio} outside {P16_PEAK_BAND}")
                check(measured_ms[kind] >= bound_ms / P16_ROOFLINE_SLACK,
                      f"dryrun {kind}: {measured_ms[kind]} ms beats the roofline's {bound_ms} ms")

            # -- 16c. the PSVGP rank step on the card under the 256-rank group
            mesh = make_production_mesh()
            cpu = dryrun.psvgp_rank_trace(mesh, "cpu")
            kernel_launches.reset()
            gpu = dryrun.psvgp_rank_trace(mesh, "cuda")
            torch.cuda.synchronize()
            launches = svgp_proj.LAUNCHES["svgp_projection"]
            kinds = hlo_analysis.collective_bytes(gpu)
            rec["psvgp"] = {"launches": launches, "collectives": kinds,
                            "cpu_collectives": hlo_analysis.collective_bytes(cpu)}
            print(f"[dryrun] [{card}] PSVGP rank 0 of 256 (fake group) on the card: "
                  f"{launches} projection launch, collectives {kinds} (the CPU trace "
                  f"{rec['psvgp']['cpu_collectives']})")
            check(launches == 1, f"dryrun psvgp: {launches} projection launches, not 1")
            check(kinds == rec["psvgp"]["cpu_collectives"],
                  "dryrun psvgp: the card's collectives differ from the CPU trace's")
            check(kinds.get("collective-permute", 0) < 10e6, f"dryrun psvgp: {kinds}")

            # -- 16d. the pinned cut cells on this host's torch, held to the
            # pins the CPU tests hold (repro_torch/launch/pins.py)
            rec["pins"] = {"torch": torch.__version__}
            for name in pins.CELLS:
                t0 = time.perf_counter()
                got = pins.trace_cell(name)
                bad = pins.check(name, got)
                rec["pins"][name] = {**got, "trace_s": time.perf_counter() - t0, "bad": bad}
                print(f"[dryrun] [{card}] pinned cell {name} on torch {torch.__version__}, traced"
                      f" in {rec['pins'][name]['trace_s']:.3f} s: peak {got['peak']:,} B, "
                      f"collectives {got['kinds']}: "
                      + ("as pinned" if not bad else "; ".join(bad)))
                check(not bad, f"dryrun pins: {bad}")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for _, _, proc in procs:
                try:
                    proc.wait(timeout=P16_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        rec["cases"] = []
        for case, out, proc in procs:
            with open(out + ".log") as f:
                log = f.read()
            check(proc.returncode == 0,
                  f"dryrun {case}: exit {proc.returncode}\n{log[-3000:]}")
            line = open(out).read().strip().splitlines()[-1]
            rep = json.loads(line)
            rec["cases"].append(rep)
            print(f"[dryrun] [{card}] {p16_check_record(case, rep)}")
    rec["phase_s"] = time.perf_counter() - t_phase
    report["dryrun"] = rec
    print(f"[dryrun] [{card}] phase 16: {rec['phase_s']:.3f} s")


def run(report: dict, seed: int = 0) -> None:
    import torch

    from repro_torch import api
    from repro_torch.core import partition, routing
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.data.spatial import e3sm_like_field, zipf_query_stream
    from repro_torch.kernels import build, ops, predict, rbf, ref
    from repro_torch.kernels import launches as kernel_launches

    dev = torch.device("cuda")
    card = card_line()
    report["card"] = card
    seconds: dict = {}
    mark = [time.perf_counter()]

    def phase_done(label: str) -> None:
        now = time.perf_counter()
        seconds[label] = now - mark[0]
        mark[0] = now
        print(f"[phases] {label}: {seconds[label]:.3f} s")

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
        insts = sorted((tuple(int(a) for a in k[len(family) + 1:-1].split(",") if a), r, sp)
                       for k, (r, sp) in report["ptxas"].items() if k.startswith(family + "<"))
        print(f"[build] {family}<MMAX,KD,...> registers (+spill bytes): "
              + ", ".join(f"{args} {r}" + (f"+{sp}" if sp else "") for args, r, sp in insts))

    phase_done("1-2 card and build")

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

    # the single-block kernel ("pallas" lane): ONE launch over every cell's
    # 9 * 32 rows (the lane's request), bitwise the same as one launch per
    # cell; then ragged cases
    x_cells = hx_main.reshape(grid.num_partitions, -1, 2)
    got = predict.posterior_predict(x_cells, *leaves)
    errors["posterior_predict"] = compare(
        "single-block P=400 Q=288 m=5 d=2 (artifact)", got,
        ref.posterior_predict(x_cells, *leaves), ref.posterior_predict_scales(x_cells, *leaves))
    for p in range(grid.num_partitions):
        one = predict.posterior_predict(x_cells[p:p + 1], *(a[p:p + 1] for a in leaves))
        check(torch.equal(one[0], got[0][p:p + 1]) and torch.equal(one[1], got[1][p:p + 1]),
              f"single-block: cell {p} launched alone differs from the one launch")
    print("[kernels] single-block: one launch over 400 cells == 400 per-cell launches, bitwise")
    for P, Q, m, d in ((1, 1, 1, 2), (1, 1000, 10, 2), (2, 517, 17, 2), (3, 130, 64, 4)):
        args = random_case(P, m, d)
        x = t(rng.uniform(0, 2, (P, Q, d)))
        compare(f"single-block P={P} Q={Q} m={m} d={d}", predict.posterior_predict(x, *args),
                ref.posterior_predict(x, *args), ref.posterior_predict_scales(x, *args))
    check_wide_predict(torch, random_case, t, rng, compare)

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

    phase_done("3 kernels")

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
    kernel_launches.reset()
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
    kernel_launches.reset()
    mp, vp = pallas.submit(queries)  # the "pallas" lane's path, counted
    launches_pallas = dict(predict.LAUNCHES)
    report["launches_pallas_path"] = launches_pallas
    print(f"[slice] pallas lane: launches {launches_pallas}")
    check(launches_pallas == {"posterior_predict": 1, "posterior_predict_slots": 0},
          "the pallas lane launched other than one single-block kernel for the request")
    vs_jax("sharded pallas", mp, vp, "routed")
    golden(pallas, stream, "single-level pallas")

    rep_m, rep_v = fitted.predict(queries)
    vs_jax("replicated", rep_m.cpu().numpy(), rep_v.cpu().numpy(), "replicated")

    phase_done("4 serving")

    # -- 5. training on the card ----------------------------------------------
    trained = train_slice(torch, dev, card, report, ds)
    scan_slice(torch, dev, card, report, trained, ds)
    wide_slice(torch, dev, card, report, ds)
    kernel_launches.reset()
    ops.rbf_cross_cov(x_train, cache.z, cache.cov.log_lengthscale, cache.cov.log_variance)
    report["launches_rbf_path"] = dict(rbf.LAUNCHES)
    print(f"[kernels] ops.rbf_cross_cov (the one entry that reaches it, as in the JAX "
          f"package): launches {report['launches_rbf_path']}")
    check(report["launches_rbf_path"]["rbf_cross_cov"] == 1, "ops.rbf_cross_cov did not launch")

    phase_done("5 training")

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
    x_cells = hx_main.reshape(grid.num_partitions, -1, 2)
    for label, x, factors in (("main", x_cells, leaves), ("one cell, Q=288", x_cells[:1], cell0),
                              ("65,536 queries", x_big[None], cell0)):
        P, Q, d = x.shape
        k_ms = device_ms(torch, lambda x=x, f=factors: predict.posterior_predict(x, *f))
        p_ms = device_ms(torch, lambda x=x, f=factors: ref.posterior_predict(x, *f))
        b_ms, b_by = bound(P, 1, Q, 5, d)
        rows.append(("posterior_predict", label, (P, 1, Q), k_ms, p_ms, b_ms, b_by))
    for name, label, shape, k_ms, p_ms, b_ms, b_by in rows:
        print(f"[times] [{card}] {name} {label} (P, S, Q)={shape}: kernel {k_ms:.6f} ms, "
              f"plain {p_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), share {b_ms / k_ms:.4f}, "
              f"floor {report['floor_ms']:.6f} ms")
    rows += wide_times(torch, dev, card, report)

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
    # host time (which the profiler's own host cost lengthens a little); the
    # fused lane, then the "pallas" lane (its p50 over 100 requests too)
    pallas = api.Server(fitted, api.ServeConfig(mode="sharded", backend="pallas"))
    rec = pallas.stream(reqs[:100])
    report["stream"]["pallas serial"] = rec
    print(f"[times] [{card}] stream of 100 x 4,096-point requests, sharded pallas serial: "
          f"p50 {rec['latency_ms']['p50_ms']:.4f} ms, p95 {rec['latency_ms']['p95_ms']:.4f} ms")
    window = reqs[:20]
    for lane, srv, key in (("fused", serial, ""), ("pallas", pallas, "pallas_")):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in window:
                srv.submit(q)
            window_us = 1e6 * (time.perf_counter() - t0)
        busy_us, per_name = device_busy(torch, prof, len(window))
        if busy_us > 0:
            report[f"{key}device_busy_share"] = busy_us / window_us
            report[f"{key}device_us_per_request"] = per_name
            print(f"[times] [{card}] {lane} lane: device busy {busy_us / len(window):.1f} us of "
                  f"{window_us / len(window):.1f} us per 4,096-point request "
                  f"(share {busy_us / window_us:.4f}); top device ops, us per request: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in per_name.items()))
        else:
            report[f"{key}device_busy_share"] = None
            print(f"[times] [{card}] {lane} lane: device busy share: not measured "
                  "(torch.profiler saw no device activity)")
    rows += training_times(torch, dev, card, cache, x_train, trained, ds, report, errors)

    phase_done("6 times")

    # -- 7. the in-situ lifecycle and its front doors (after the times, so
    # that they are taken in the process state of the earlier slices) -----
    lifecycle_slice(torch, dev, card, report, trained, ds)

    phase_done("7 lifecycle")
    # -- 8. the entry points and examples
    entry_points_phase(card, report)
    phase_done("8 entry")
    # -- 9. the halo mesh and 10. SPMD training, on one spawn of 16 ranks
    mesh_spmd_phase(torch, dev, card, report)
    phase_done("9-10 mesh and spmd (one spawn)")
    # -- 11. the analysis package's program passes on the card
    analysis_phase(card, report)
    phase_done("11 analysis")
    # -- 12. the dense LM substrate at full width
    lm_phase(torch, dev, card, report, seed)
    phase_done("12 lm")
    # -- 13. MoE and MLA at the published width (and the LM CLIs of 13 and 14)
    moe_mla_phase(torch, dev, card, report, seed)
    phase_done("13 moe-mla")
    # -- 14. xLSTM and the vision stub at the published width
    xlstm_vlm_phase(torch, dev, card, report, seed)
    phase_done("14 xlstm-vlm")
    # -- 15. RG-LRU and the encoder-decoder at the published width
    rglru_encdec_phase(torch, dev, card, report, seed)
    phase_done("15 rglru-encdec")
    # -- 16. the dry-run on the host, its accounting against phase 12's steps
    dryrun_phase(torch, dev, card, report)
    phase_done("dryrun")
    report["phase_s"] = seconds
    print(f"[phases] all: {sum(seconds.values()):.3f} s")
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
        ("adam_update", "adam.cu", "none (XLA-fused jnp)", "launches_training_path"),
        ("minibatch_draws", "draws.cu", "none (jax.random in jnp)", "launches_training_path"),
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
    ap.add_argument("--seed", type=int, default=0, help="phase 12's parameters and tokens")
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
        run(report, args.seed)
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
