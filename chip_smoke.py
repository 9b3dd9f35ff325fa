#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python chip_smoke.py [--out report.json]

Phases, each printed as it runs; any failure exits non-zero:

  1. card    the card's name and power limit (nvidia-smi); TF32 off.
  2. build   nvcc builds the kernels from src/repro_torch/kernels/csrc/.
  3. kernels each CUDA kernel against its plain PyTorch version on the
             card, at the main path's shape (the paper's 400-cell artifact,
             9 halo slots, q_max 32, m 5) and at ragged/odd shapes
             (m in {1, 10, 17, 64}, Q not a multiple of 128, d up to 4),
             plus row independence: junk in masked rows leaves every valid
             row bitwise unchanged.
  4. slice   Server.from_artifact(the committed JAX-trained artifact,
             ServeConfig(mode="sharded")) on the card: answers against the
             JAX answers stored beside it, the kernel's launch count over
             the run, serial == pipelined and submit_many == solo submit
             bitwise; the two-level router on a zipf stream; the "pallas"
             lane; the replicated lane against the JAX replicated answers.
  5. times   kernel, plain version and bound at the main path's shape and
             at a 65,536-query batch; p50/p95 latency and points/s of a
             stream of 4,096-point requests, the host stages of a request
             and the device's busy share (torch.profiler).

Tolerances (``repro_torch.kernels.ref.tolerance_ratio``): per row,
|d mean| <= 1e-5 max(1, sum_j |k_j c_j|) and
|d var| <= 1e-5 max(1, ||Wk||^2 + ||Uk||^2) — float32 rounding scaled by
the magnitude of the terms each output sums (fitted c_j cancel).

The last two lines of standard output are the kernel table and the
device record, each one JSON object. Exits non-zero without printing
them when no CUDA device is available, or when the port's sources are
not beside this file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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


def predict_flops_per_row(m: int, d: int) -> int:
    """Operations of one query row: scale x (d); per inducing point the
    explicit difference, square and sum (3d), -0.5 r2, exp, * var (3); the
    mean (2m); two m x m projections and their squared norms (4m^2 + 4m);
    var - q + s (2)."""
    return d + m * (3 * d + 3) + 2 * m + 4 * m * m + 4 * m + 2


def bound(P: int, S: int, Q: int, m: int, d: int) -> tuple[float, str]:
    """Least time (ms) for one launch: each input read once (queries and
    P cells' factors), each output written once, against the HBM rate; the
    operations against the FP32 rate. Returns (ms, what bounds it)."""
    rows = P * S * Q
    nbytes = 4 * (rows * d + P * (m * d + 2 * m * m + m + d + 1) + 2 * rows)
    flops = rows * predict_flops_per_row(m, d)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


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


def run(report: dict) -> None:
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core import routing
    from repro_torch.core.blend import blend_error_scales
    from repro_torch.data.spatial import zipf_query_stream
    from repro_torch.kernels import build, ops, predict, ref

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
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

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
                          (2, 9, 129, 64, 4), (1, 1, 1, 5, 1)):
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

    # -- 5. times ------------------------------------------------------------
    rows = []
    big = np.random.default_rng(1).uniform(
        [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]], (65536, 2)
    ).astype(np.float32)
    big_table = routing.build_routing_table(grid, big)
    hx_big = torch.as_tensor(routing.make_halo_stacker(grid)(big_table.xq), device=dev)
    for label, hx in (("main", hx_main), ("65,536 queries", hx_big)):
        P, S, Q, d = hx.shape
        k_ms = device_ms(torch, lambda hx=hx: predict.posterior_predict_slots(hx, *leaves))
        p_ms = device_ms(torch, lambda hx=hx: ref.posterior_predict_slots_stacked(hx, *leaves))
        b_ms, b_by = bound(P, S, Q, 5, d)
        rows.append(("posterior_predict_slots", label, (P, S, Q), k_ms, p_ms, b_ms, b_by))
    x_main = hx_main[0].reshape(-1, 2).contiguous()
    x_big = torch.as_tensor(big, device=dev)
    one_cell = [a[0] for a in leaves]
    for label, x in (("main", x_main), ("65,536 queries", x_big)):
        k_ms = device_ms(torch, lambda x=x: predict.posterior_predict(x, *one_cell))
        p_ms = device_ms(torch, lambda x=x: ref.posterior_predict(x, *one_cell))
        b_ms, b_by = bound(1, 1, x.shape[0], 5, 2)
        rows.append(("posterior_predict", label, (1, 1, x.shape[0]), k_ms, p_ms, b_ms, b_by))
    for name, label, shape, k_ms, p_ms, b_ms, b_by in rows:
        print(f"[times] [{card}] {name} {label} (P, S, Q)={shape}: kernel {k_ms:.6f} ms, "
              f"plain {p_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
    report["times"] = [
        {"name": n, "shape": list(s), "label": lab, "ms": k, "plain_ms": p,
         "bound_ms": b, "bound_by": by}
        for n, lab, s, k, p, b, by in rows
    ]

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
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    per_name: dict = {}
    for e in sorted(on_card, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        name = e.name if len(e.name) <= 40 else e.name[:37] + "..."
        per_name[name] = per_name.get(name, 0.0) + (b - a) / len(window)
    if busy_us > 0:
        report["device_busy_share"] = busy_us / window_us
        report["device_us_per_request"] = dict(
            sorted(per_name.items(), key=lambda kv: -kv[1])[:6])
        print(f"[times] [{card}] device busy {busy_us / len(window):.1f} us of "
              f"{window_us / len(window):.1f} us per 4,096-point request "
              f"(share {report['device_busy_share']:.4f}); top device ops, us per request: "
              + ", ".join(f"{k} {v:.1f}" for k, v in report["device_us_per_request"].items()))
    else:
        report["device_busy_share"] = None
        print(f"[times] [{card}] device busy share: not measured "
              "(torch.profiler saw no device activity)")

    def main_row(name):
        return next(r for r in rows if r[0] == name and r[1] == "main")

    kernels = []
    for name, replaces, launch_key in (
        ("posterior_predict_slots", "src/repro/kernels/predict.py:160", "launches_main_path"),
        ("posterior_predict", "src/repro/kernels/predict.py:81", "launches_pallas_path"),
    ):
        _, _, _, k_ms, p_ms, b_ms, b_by = main_row(name)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/predict.cu",
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
