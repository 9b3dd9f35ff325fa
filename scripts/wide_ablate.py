#!/usr/bin/env python3
"""Time the wide kernel bodies with parts of their loop switched off.

    python scripts/wide_ablate.py [--out report.json]

Builds four versions of ``src/repro_torch/kernels/csrc`` under
``src/repro_torch/kernels/_build/ablate/`` (gitignored): the sources as
they are, and copies of ``kernel_common.cuh`` whose shared loop
(``wide_run``) skips the knm chunks after the first, skips the factors'
``cp.async`` copies, or skips both (the FFMA loop with its barriers and
folds alone). The copies compute wrong answers on purpose and are never
checked; ``scripts/kernel_ab.py`` holds the sources as they are to their
plain versions. Each version is timed with ``chip_smoke.device_ms`` (a
CUDA graph of 50 launches between CUDA events) at the wide rows of
``PERF.md``, in turns (the versions in order, then in reverse; each time
the mean of the two). The difference to the full version is what that
part costs where the rest stays.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

# (entry, (P, rows), m, d): the prediction's single-block entry and the
# projection at their wide rows
ROWS = (
    ("posterior_predict", (4, 4096), 1024, 2),
    ("posterior_predict", (16, 2304), 128, 2),
    ("svgp_projection", (1, 4096), 1024, 2),
    ("svgp_projection", (400, 32), 128, 2),
    ("svgp_projection", (1, 256), 128, 2),
)

# the edits of kernel_common.cuh that switch a part off (anchor -> text)
NO_KNM = ("    if (nxt.k < tl.count()) knm_step(",
          "    if (nxt.k < tl.count() && m < 0) knm_step(")
NO_COPY = ("  const int step = T / per_row;\n",
           "  const int step = T / per_row;\n  if (m > 0) return;\n")
VERSIONS = {"full": (), "no knm": (NO_KNM,), "no copies": (NO_COPY,),
            "FFMA loop alone": (NO_KNM, NO_COPY)}


def make_version(name: str, edits, root: Path) -> Path:
    """A copy of the kernel sources with ``edits`` applied to kernel_common.cuh."""
    from repro_torch.kernels import build

    out = root / name.replace(" ", "_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    header = out / "kernel_common.cuh"
    text = header.read_text()
    for anchor, new in edits:
        if anchor not in text:
            raise SystemExit(f"wide_ablate: {anchor!r} not found in kernel_common.cuh")
        text = text.replace(anchor, new)
    header.write_text(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the table as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wide_ablate: no CUDA device is available", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from kernel_ab import build_dir
    from repro_torch.kernels import build

    card = cs.card_line()
    print(f"[card] {card}")
    root = build.BUILD_DIR / "ablate"
    libs = {name: build_dir(str(make_version(name, edits, root)))
            for name, edits in VERSIONS.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    order = list(libs) + list(libs)[::-1]
    rows = []
    for entry, (P, R), m, d in ROWS:
        x = t(rng.uniform(0, 2, (P, R, d)))
        z = t(rng.uniform(0, 2, (P, m, d)))
        log_l = t(np.log(rng.uniform(0.3, 1.5, (P, d))))
        log_v = t(rng.normal(0, 0.5, P))
        w = t(np.tril(rng.normal(0, 1, (P, m, m))) / np.sqrt(m))
        u = t(rng.normal(0, 1, (P, m, m)) / np.sqrt(m))
        c = t(rng.normal(0, 1, (P, m)))
        out = [torch.empty((P, R, m), device=dev) for _ in range(2)]
        q = torch.empty((P, R), device=dev)

        def run(lib):
            stream = torch.cuda.current_stream().cuda_stream  # the capturing one in a graph
            if entry == "posterior_predict":
                rc = lib.psvgp_posterior_predict(
                    x.data_ptr(), z.data_ptr(), log_l.data_ptr(), log_v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), c.data_ptr(), q.data_ptr(), out[0].data_ptr(), P, 1, R, m, d,
                    0, stream)
            else:
                rc = lib.psvgp_svgp_projection(
                    x.data_ptr(), z.data_ptr(), log_l.data_ptr(), log_v.data_ptr(), w.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), q.data_ptr(), P, R, m, d, 0, stream)
            cs.check(rc == 0, f"{entry} {(P, R)} m={m}: launch failed ({rc})")

        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cs.device_ms(torch, lambda lib=libs[name]: run(lib)))
        us = {name: 1e3 * float(np.mean(v)) for name, v in times.items()}
        rows.append({"entry": entry, "shape": [P, R], "m": m, "d": d, "us": us})
        print(f"[ablate] [{card}] {entry} {(P, R)} m={m} d={d}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in us.items()) + " us")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
