#!/usr/bin/env python3
"""What a mesh rank keeps on its device: ``api.Server(group=)`` of this tree
against other trees' servers, on spawned gloo ranks.

    python scripts/server_memory_ab.py [--against NAME=SRC ...] [--device cuda]

Runs the ``costs`` pass's ``Server(group=)`` probe
(``repro_torch.analysis.costs.measure_server``: P = 4, 9 and 16 ranks of
one spawn, m = 128, an artifact of random cells loaded as the sharded
serving CLI loads it under ``torchrun``, one warm-up request and one
measured) on this tree, then on each SRC (the ``src/`` of another tree,
for example an earlier commit unpacked with ``git archive`` into the
gitignored ``tmp/``) with this tree's ``analysis/costs.py``,
``analysis/meshprobe.py`` and ``launch/serve_sharded.py`` (the CLI's
front, ``build_server``) laid over its own, so that both run the same
probe and front on their own ``api.Server``. Each tree runs in a
subprocess of its own, this tree first. Prints, per tree and P, the
min-max over ranks of the CUDA bytes above what was allocated before the
load: the peak over the load, the build and the request, what stays
allocated after it (resident) and the request's own peak, and the
resident bytes' exponent against P.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("src/repro_torch/analysis/costs.py", "src/repro_torch/analysis/meshprobe.py",
         "src/repro_torch/launch/serve_sharded.py")
_CHILD = """
import json, sys
from repro_torch.analysis import costs
if __name__ == "__main__":
    server = costs.measure_server(device=sys.argv[1])
    print("RESULT " + json.dumps({"server": server,
                                  "exponent": costs.server_resident_exponent(server)}))
"""


def run_tree(src: str, device: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = src
    with tempfile.TemporaryDirectory() as tmp:
        child = os.path.join(tmp, "probe.py")
        with open(child, "w") as f:
            f.write(_CHILD)
        r = subprocess.run([sys.executable, child, device], env=env, capture_output=True,
                           text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{src}: exit {r.returncode}\n{r.stderr[-3000:]}")
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def overlay(src: str, into: str) -> str:
    """A copy of ``src`` with this tree's probe and CLI front laid over it."""
    dst = os.path.join(into, "src")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel in PROBE:
        shutil.copy(os.path.join(REPO, rel), os.path.join(dst, os.path.relpath(rel, "src")))
    return dst


def summary(name: str, res: dict) -> None:
    out = {}
    for p, ranks in sorted(res["server"].items(), key=lambda kv: int(kv[0])):
        out[p] = {k: [min(r[k] or 0 for r in ranks), max(r[k] or 0 for r in ranks)]
                  for k in ("cuda_peak_bytes", "cuda_resident_bytes", "cuda_request_peak_bytes")}
        out[p]["cache_bytes"] = ranks[0]["cache_bytes"]
    print(f"[server-memory] {name}: " + "; ".join(
        f"P={p}: peak {v['cuda_peak_bytes'][0]}-{v['cuda_peak_bytes'][1]} B, resident "
        f"{v['cuda_resident_bytes'][0]}-{v['cuda_resident_bytes'][1]} B, request peak "
        f"{v['cuda_request_peak_bytes'][0]}-{v['cuda_request_peak_bytes'][1]} B, cache bytes "
        f"{v['cache_bytes']}" for p, v in out.items())
        + f"; resident exponent vs P {res['exponent']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=SRC")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        trees = [("this tree", os.path.join(REPO, "src"))]
        for name, src in (a.split("=", 1) for a in args.against):
            trees.append((name, overlay(os.path.abspath(src), os.path.join(tmp, name))))
        for name, src in trees:
            summary(name, run_tree(src, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
