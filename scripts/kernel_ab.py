#!/usr/bin/env python3
"""Time the port's CUDA kernels against other versions of their sources.

    python scripts/kernel_ab.py --against NAME=DIR [--against NAME=DIR ...] [--out report.json]

Each DIR holds a ``predict.cu`` and a ``svgp_proj.cu`` with the same C
entries as ``src/repro_torch/kernels/csrc/`` -- for example the csrc of an
earlier commit unpacked with ``git archive``, or a copy with one constant
changed. Every version is built with the repo's nvcc flags (the one in
this tree through ``repro_torch.kernels.build``, the others into
``DIR/_ab/``), held to the plain PyTorch versions at every shape
(``ref.tolerance_ratio`` <= 1), and timed with ``chip_smoke.device_ms`` (a
CUDA graph of 50 launches between CUDA events) in turns: this tree, the
others, then the same in reverse; each time is the mean of the two turns.
Inputs are seeded random factors (m = 5 and d = 2 unless a shape says
otherwise). Compare versions only within one run: two runs may land on
two cards.
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

# (entry, shape, m): slots (P, S, Q); projection and K(X, Z) (P, B). The
# serving and training paths' shapes, their 65,536-row shapes, two
# projection launches either side of the slab threshold (65,536 rows) with
# unaligned slabs, and a large m
SHAPES = (
    ("posterior_predict_slots", (400, 9, 32), 5),
    ("posterior_predict_slots", (400, 9, 216), 5),
    ("posterior_predict_slots", (1, 1, 65536), 5),
    ("posterior_predict_slots", (1, 1, 288), 5),
    ("posterior_predict_slots", (2, 9, 129), 33),
    ("svgp_projection", (400, 32), 5),
    ("svgp_projection", (1, 65536), 5),
    ("svgp_projection", (300, 111), 5),
    ("svgp_projection", (600, 111), 5),
    ("svgp_projection", (1, 4096), 64),
    ("rbf_cross_cov", (400, 32), 5),
    ("rbf_cross_cov", (1, 65536), 5),
)


def build_dir(path: str):
    """Build DIR's sources with the repo's flags into DIR/_ab/lib.so and load it."""
    from repro_torch.kernels import build

    lib = Path(path) / "_ab" / "lib.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    build.compile_shared(sorted(Path(path).glob("*.cu")), lib)
    return build.bind(lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="another version of the kernel sources (repeatable)")
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
        cs.check(rc == 0, f"launch failed: cudaError {rc}")
        return mean, fvar

    def projection(lib, x, z, log_l, log_v, w):
        P, B, d = x.shape
        m = z.shape[1]
        knm, lk_t = (torch.empty((P, B, m), device=dev) for _ in range(2))
        q_diag = torch.empty((P, B), device=dev)
        rc = lib.psvgp_svgp_projection(
            x.data_ptr(), z.data_ptr(), log_l.data_ptr(), log_v.data_ptr(), w.data_ptr(),
            knm.data_ptr(), lk_t.data_ptr(), q_diag.data_ptr(), P, B, m, d, 0, stream())
        cs.check(rc == 0, f"launch failed: cudaError {rc}")
        return knm, lk_t, q_diag

    def cross_cov(lib, x, z, log_l, log_v):
        P, B, d = x.shape
        knm = torch.empty((P, B, z.shape[1]), device=dev)
        rc = lib.psvgp_rbf_cross_cov(x.data_ptr(), z.data_ptr(), log_l.data_ptr(),
                                     log_v.data_ptr(), knm.data_ptr(), P, B, z.shape[1], d, 0,
                                     stream())
        cs.check(rc == 0, f"launch failed: cudaError {rc}")
        return (knm,)

    one = torch.zeros(1, device=dev)
    floor_ms = cs.device_ms(torch, lambda: one.add_(1.0))
    print(f"[ab] launch floor (one-element add_): {1e3 * floor_ms:.3f} us")
    order = list(libs) + list(libs)[::-1]
    rows = []
    for entry, shape, m in SHAPES:
        P, d = shape[0], 2
        z = t(rng.uniform(0, 2, (P, m, d)))
        log_l = t(np.log(rng.uniform(0.3, 1.5, (P, d))))
        log_v = t(rng.normal(0, 0.5, P))
        w = t(np.tril(rng.normal(0, 1, (P, m, m))) / np.sqrt(m))
        if entry == "posterior_predict_slots":
            x = t(rng.uniform(0, 2, (*shape, d)))
            u = t(rng.normal(0, 1, (P, m, m)) / np.sqrt(m))
            c = t(rng.normal(0, 1, (P, m)))
            inputs = (x, z, log_l, log_v, w, u, c)
            run, plain = slots, ref.posterior_predict_slots_stacked
            scales = ref.posterior_predict_scales(x, *(a[:, None] for a in inputs[1:]))
            floors = (1.0, 1.0)
            b_ms, _ = cs.bound(*shape, m, d)
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
        for lib in libs.values():
            got = run(lib, *inputs)
            ratio = max([ratio] + [ref.tolerance_ratio(g, wv, s, floor=f)
                                   for g, wv, s, f in zip(got, want, scales, floors)])
        cs.check(ratio <= 1, f"{entry} {shape}: a version disagrees with the plain version")
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cs.device_ms(torch, lambda lib=libs[name]: run(lib, *inputs)))
        us = {name: 1e3 * float(np.mean(v)) for name, v in times.items()}
        rows.append({"entry": entry, "shape": list(shape), "m": m, "us": us,
                     "bound_us": 1e3 * b_ms, "floor_us": 1e3 * floor_ms,
                     "worst_tol_ratio": ratio})
        print(f"[ab] [{card}] {entry} {shape} m={m}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
              + f" us; bound {1e3 * b_ms:.3f} us; worst tol ratio {ratio:.3f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "floor_us": 1e3 * floor_ms, "rows": rows}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
