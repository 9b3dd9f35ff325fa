#!/usr/bin/env python3
"""Time the port's CUDA kernels against other versions of their sources.

    python scripts/kernel_ab.py [--against NAME=DIR ...] [--set all|thresholds]
                                [--out report.json]

Each DIR holds a ``predict.cu`` and a ``svgp_proj.cu`` with the same C
entries as ``src/repro_torch/kernels/csrc/`` -- for example the csrc of an
earlier commit unpacked with ``git archive``, or a copy with one constant
changed (``kPredictWideMinM = 17`` in ``kernel_common.cuh`` times the
prediction's wide body at m = 17..64). A version that refuses a shape (an
earlier source's m or d limit) gets no time at that shape. Every version
is built with the repo's nvcc flags (the one in this tree through
``repro_torch.kernels.build``, the others into ``DIR/_ab/``), held to the
plain PyTorch versions at every shape (``ref.tolerance_ratio`` <= 1), and
timed with ``chip_smoke.device_ms`` (a CUDA graph of 50 launches between
CUDA events) in turns: this tree, the others, then the same in reverse;
each time is the mean of the two turns. Inputs are seeded random factors
(m and d as each shape says). ``posterior_predict`` is the single-block
entry (the slots C entry with S = 1) in one launch over P cells;
``posterior_predict_per_cell`` is the same rows in P launches of one cell
each (how the "pallas" lane launched before it took a cell axis). Last,
that lane end to end in both forms, in turns: request p50 of 100
4,096-point requests through ``Server.stream`` on the committed artifact,
and the device's busy time a request in a torch.profiler window of 20
(the per-cell form put in place of ``predict_cached_slots_stacked`` for
its turns; with the default set only). ``--set thresholds`` times the
projection at (400, 32) and the slots kernel at (400, 9, 32) over m in
{9, ..., 65}, d = 2, where the narrow and the wide bodies meet (run it
against a copy whose ``k*WideMinM`` are 9 to time the wide body there).
Compare versions only within one run: two runs may land on two cards.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

# (entry, shape, m, d): slots (P, S, Q); single-block (P, Q); projection and
# K(X, Z) (P, B). The serving and training paths' shapes, their 65,536-row
# shapes, two projection launches either side of the slab threshold (65,536
# rows) with unaligned slabs, a large m; the "pallas" lane's request in one
# launch and in per-cell launches; K(X, Z) at the JAX package's kernel
# benchmark shapes and at a store-bound 210 MB; the wide body at m = 128;
# m in 17..64 (the prediction's padded narrow instances, the projection's
# wide body; the other body in a copy with k*WideMinM changed); the paper's
# Fig. 4 widths m = 10 and 20 at its 400 cells, B = 32 (and the slots
# kernel's request at m = 20)
SHAPES = (
    ("posterior_predict_slots", (400, 9, 32), 5, 2),
    ("posterior_predict_slots", (400, 9, 216), 5, 2),
    ("posterior_predict_slots", (1, 1, 65536), 5, 2),
    ("posterior_predict_slots", (1, 1, 288), 5, 2),
    ("posterior_predict_slots", (2, 9, 129), 33, 2),
    ("posterior_predict", (400, 288), 5, 2),
    ("posterior_predict_per_cell", (400, 288), 5, 2),
    ("posterior_predict", (1, 288), 5, 2),
    ("posterior_predict", (1, 65536), 5, 2),
    ("posterior_predict", (16, 2304), 128, 2),
    ("svgp_projection", (400, 32), 5, 2),
    ("svgp_projection", (1, 65536), 5, 2),
    ("svgp_projection", (300, 111), 5, 2),
    ("svgp_projection", (600, 111), 5, 2),
    ("svgp_projection", (1, 4096), 64, 2),
    ("svgp_projection", (1, 1024), 128, 3),
    ("rbf_cross_cov", (400, 32), 5, 2),
    ("rbf_cross_cov", (1, 65536), 5, 2),
    ("rbf_cross_cov", (1, 256), 128, 2),
    ("rbf_cross_cov", (1, 1024), 128, 3),
    ("rbf_cross_cov", (400, 4096), 32, 2),
    ("posterior_predict_slots", (400, 9, 32), 25, 2),
    ("posterior_predict_slots", (400, 9, 32), 64, 2),
    ("svgp_projection", (400, 32), 25, 2),
    ("svgp_projection", (400, 32), 64, 2),
    ("svgp_projection", (1, 4096), 33, 2),
    ("posterior_predict", (4, 4096), 1024, 2),
    ("svgp_projection", (1, 4096), 1024, 2),
    ("posterior_predict_slots", (16, 9, 256), 128, 2),
    ("posterior_predict_slots", (4, 1, 4096), 1024, 2),
    ("svgp_projection", (1, 256), 128, 2),
    ("svgp_projection", (400, 32), 128, 2),
    ("svgp_projection", (400, 32), 10, 2),
    ("svgp_projection", (400, 32), 20, 2),
    ("posterior_predict_slots", (400, 9, 32), 20, 2),
)
# where the narrow and the wide bodies meet: (400, 32) and (400, 9, 32), d = 2
THRESHOLD_MS = (9, 12, 16, 17, 20, 25, 33, 48, 64, 65)
THRESHOLDS = tuple(("svgp_projection", (400, 32), m, 2) for m in THRESHOLD_MS) + tuple(
    ("posterior_predict_slots", (400, 9, 32), m, 2) for m in THRESHOLD_MS)


# the C entries these versions are timed through (an earlier source has no
# ``psvgp_adam_update``)
AB_ENTRIES = ("psvgp_posterior_predict", "psvgp_svgp_projection", "psvgp_rbf_cross_cov")


def shape_set(name: str) -> tuple:
    """The rows of ``--set name``."""
    return THRESHOLDS if name == "thresholds" else SHAPES


def build_dir(path: str):
    """Build DIR's sources with the repo's flags into DIR/_ab/lib.so and load it."""
    from repro_torch.kernels import build

    lib = Path(path) / "_ab" / "lib.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    build.compile_shared(sorted(Path(path).glob("*.cu")), lib)
    return build.bind(lib, AB_ENTRIES)


def lane_ab(torch, cs, card: str) -> dict:
    """The "pallas" lane as it is (one launch a request) and in its
    per-cell form (one launch per cell), in turns (this, per-cell, per-cell,
    this): {form: {"p50_ms": [...], "busy_us": [...]}}."""
    from repro_torch import api
    from repro_torch.core import posterior

    one_launch = posterior.predict_cached_slots_stacked

    def per_cell(cache, cov_fn, hx, *, include_noise=False, backend="ref"):
        outs = [posterior.predict_cached_slots(posterior.take_cache(cache, p), cov_fn, hx[p],
                                               include_noise=include_noise, backend=backend)
                for p in range(hx.shape[0])]
        return torch.stack([m for m, _ in outs]), torch.stack([v for _, v in outs])

    fitted = api.FittedPSVGP.load(cs.FIXTURE, device=torch.device("cuda"))
    grid = fitted.grid
    reqs = [np.random.default_rng(10 + i).uniform(
        [grid.x_edges[0], grid.y_edges[0]], [grid.x_edges[-1], grid.y_edges[-1]], (4096, 2)
    ).astype(np.float32) for i in range(100)]
    out = {"one launch": {"p50_ms": [], "busy_us": []},
           "per-cell launches": {"p50_ms": [], "busy_us": []}}
    for form in ("one launch", "per-cell launches", "per-cell launches", "one launch"):
        posterior.predict_cached_slots_stacked = one_launch if form == "one launch" else per_cell
        try:
            server = api.Server(fitted, api.ServeConfig(mode="sharded", backend="pallas"))
            p50 = server.stream(reqs)["latency_ms"]["p50_ms"]
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for q in reqs[:20]:
                    server.submit(q)
        finally:
            posterior.predict_cached_slots_stacked = one_launch
        busy_us, _ = cs.device_busy(torch, prof, 20)
        out[form]["p50_ms"].append(p50)
        out[form]["busy_us"].append(busy_us / 20 if busy_us > 0 else None)
        print(f"[ab] [{card}] pallas lane, {form}: request p50 {p50:.4f} ms, device busy "
              + (f"{busy_us / 20:.1f} us a request" if busy_us > 0 else "not measured"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="another version of the kernel sources (repeatable)")
    ap.add_argument("--set", default="all", choices=("all", "thresholds"),
                    help="which rows to time (default all)")
    ap.add_argument("--out", default=None, help="also write the table as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import build, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"[card] {card}")
    libs = {"this": build.library()}
    for spec in args.against:
        name, _, path = spec.partition("=")
        libs[name] = build_dir(path)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def slots(lib, hx, z, log_l, log_v, w, u, c):
        P, S, Q, d = hx.shape
        mean = torch.empty((P, S, Q), device=dev)
        fvar = torch.empty((P, S, Q), device=dev)
        rc = lib.psvgp_posterior_predict(
            hx.data_ptr(), z.data_ptr(), log_l.data_ptr(), log_v.data_ptr(), w.data_ptr(),
            u.data_ptr(), c.data_ptr(), mean.data_ptr(), fvar.data_ptr(), P, S, Q, z.shape[1], d,
            0, stream())
        return (mean, fvar) if rc == 0 else None

    def single(lib, x, *factors):
        out = slots(lib, x[:, None], *factors)
        return None if out is None else (out[0][:, 0], out[1][:, 0])

    def per_cell(lib, x, *factors):
        outs = [slots(lib, x[p:p + 1, None], *(a[p:p + 1] for a in factors))
                for p in range(x.shape[0])]
        if any(o is None for o in outs):
            return None
        return tuple(torch.cat([o[i][:, 0] for o in outs]) for i in range(2))

    def projection(lib, x, z, log_l, log_v, w):
        P, B, d = x.shape
        m = z.shape[1]
        knm, lk_t = (torch.empty((P, B, m), device=dev) for _ in range(2))
        q_diag = torch.empty((P, B), device=dev)
        rc = lib.psvgp_svgp_projection(
            x.data_ptr(), z.data_ptr(), log_l.data_ptr(), log_v.data_ptr(), w.data_ptr(),
            knm.data_ptr(), lk_t.data_ptr(), q_diag.data_ptr(), P, B, m, d, 0, stream())
        return (knm, lk_t, q_diag) if rc == 0 else None

    def cross_cov(lib, x, z, log_l, log_v):
        P, B, d = x.shape
        knm = torch.empty((P, B, z.shape[1]), device=dev)
        rc = lib.psvgp_rbf_cross_cov(x.data_ptr(), z.data_ptr(), log_l.data_ptr(),
                                     log_v.data_ptr(), knm.data_ptr(), P, B, z.shape[1], d, 0,
                                     stream())
        return (knm,) if rc == 0 else None

    one = torch.zeros(1, device=dev)
    floor_ms = cs.device_ms(torch, lambda: one.add_(1.0))
    print(f"[ab] launch floor (one-element add_): {1e3 * floor_ms:.3f} us")
    order = list(libs) + list(libs)[::-1]
    rows = []
    for entry, shape, m, d in shape_set(args.set):
        P = shape[0]
        z = t(rng.uniform(0, 2, (P, m, d)))
        log_l = t(np.log(rng.uniform(0.3, 1.5, (P, d))))
        log_v = t(rng.normal(0, 0.5, P))
        w = t(np.tril(rng.normal(0, 1, (P, m, m))) / np.sqrt(m))
        if entry.startswith("posterior_predict"):
            x = t(rng.uniform(0, 2, (*shape, d)))
            u = t(rng.normal(0, 1, (P, m, m)) / np.sqrt(m))
            c = t(rng.normal(0, 1, (P, m)))
            inputs = (x, z, log_l, log_v, w, u, c)
            floors = (1.0, 1.0)
            if entry == "posterior_predict_slots":
                run, plain = slots, ref.posterior_predict_slots_stacked
                scales = ref.posterior_predict_scales(x, *(a[:, None] for a in inputs[1:]))
                b_ms, _ = cs.bound(*shape, m, d)
            else:
                run = single if entry == "posterior_predict" else per_cell
                plain = ref.posterior_predict
                scales = ref.posterior_predict_scales(*inputs)
                b_ms, _ = cs.bound(P, 1, shape[1], m, d)
        else:
            x = t(rng.uniform(0, 2, (*shape, d)))
            project = entry == "svgp_projection"
            inputs = (x, z, log_l, log_v, w) if project else (x, z, log_l, log_v)
            run = projection if project else cross_cov
            plain = ref.svgp_projection if project else (lambda *a: (ref.rbf_cross_cov(*a),))
            scales = ref.svgp_projection_scales(x, z, log_l, log_v, w)
            floors = (0.0, 1.0, 1.0)
            b_ms, _ = cs.projection_bound(*shape, m, d, project)
        want = plain(*inputs)
        ratio = 0.0
        takes = {}
        for name, lib in libs.items():
            got = run(lib, *inputs)
            takes[name] = got is not None
            if got is not None:
                ratio = max([ratio] + [ref.tolerance_ratio(g, wv, s, floor=f)
                                       for g, wv, s, f in zip(got, want, scales, floors)])
        cs.check(takes["this"], f"{entry} {shape} m={m} d={d}: this tree refused the shape")
        cs.check(ratio <= 1, f"{entry} {shape}: a version disagrees with the plain version")
        times = {name: [] for name in libs if takes[name]}
        for name in order:
            if takes[name]:
                times[name].append(cs.device_ms(torch, lambda lib=libs[name]: run(lib, *inputs),
                                                reps=5 if entry.endswith("per_cell") else 50))
        us = {name: (1e3 * float(np.mean(times[name])) if takes[name] else None)
              for name in libs}
        # K(X, Z): a fill_ of the same output, what writing its bytes alone takes
        fill_us = None
        if entry == "rbf_cross_cov":
            out = torch.empty((*shape, m), device=dev)
            fill_us = 1e3 * cs.device_ms(torch, lambda o=out: o.fill_(1.0))
        rows.append({"entry": entry, "shape": list(shape), "m": m, "d": d, "us": us,
                     "bound_us": 1e3 * b_ms, "floor_us": 1e3 * floor_ms, "fill_us": fill_us,
                     "worst_tol_ratio": ratio})
        print(f"[ab] [{card}] {entry} {shape} m={m} d={d}: "
              + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} refused"
                          for k, v in us.items())
              + f" us; bound {1e3 * b_ms:.3f} us"
              + (f"; fill_ of the output {fill_us:.3f} us" if fill_us is not None else "")
              + f"; worst tol ratio {ratio:.3f}")
    lane = lane_ab(torch, cs, card) if args.set == "all" else None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "floor_us": 1e3 * floor_ms, "rows": rows,
                       "pallas_lane": lane}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
