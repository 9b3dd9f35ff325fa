"""Compare two dry-run sweeps record by record.

Reads the JSONL files that ``python -m repro_torch.launch.dryrun --all
[--multi-pod] --out F`` writes (one record an arch x shape; a JAX
package record file reads too) and, for each record of the first file,
compares the second's: the peak bytes a device and the collective bytes
of each kind, which agree when within 5% of each other (the pins' rule,
``repro_torch.launch.pins.close``). Where
they differ it lists the model lines (``collective_sites``) whose bytes
differ. With ``--jax F`` it adds the JAX package's peak for the same
record and the ratio to it.

  python scripts/dryrun_diff.py card.jsonl here.jsonl [--jax jax.jsonl] [--table]

``--table`` prints one markdown row a record (GB a device): the first
file's peak and collectives, the second's, and JAX's peak. Exits 1 when a
record differs or is missing from the second file.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.launch.pins import TOLERANCE, close

KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A",
         "collective-permute": "CP"}


def load(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                out[(rec["arch"], rec["shape"], rec["mesh"], rec.get("config_name"))] = rec
    return out


def differences(a: dict, b: dict) -> list:
    """What differs between two records of one cell, as lines."""
    out = []
    pa, pb = a["bytes_per_device"]["peak_est"], b["bytes_per_device"]["peak_est"]
    if not close(pa, pb):
        out.append(f"peak {pa / 1e9:.3f} against {pb / 1e9:.3f} GB")
    ka, kb = a["collective_breakdown"], b["collective_breakdown"]
    for kind in sorted(set(ka) | set(kb)):
        if not close(ka.get(kind, 0), kb.get(kind, 0)):
            out.append(f"{kind} {ka.get(kind, 0) / 1e9:.4g} against {kb.get(kind, 0) / 1e9:.4g} GB")
    if out:
        sa, sb = a.get("collective_sites", {}), b.get("collective_sites", {})
        for site in sorted(set(sa) | set(sb)):
            x, y = sa.get(site, {}), sb.get(site, {})
            for kind in sorted(set(x) | set(y)):
                if not close(x.get(kind, 0), y.get(kind, 0)):
                    out.append(f"  {site} {kind}: {x.get(kind, 0) / 1e9:.4g} against "
                               f"{y.get(kind, 0) / 1e9:.4g} GB")
    return out


def gb(rec: dict) -> str:
    kinds = rec["collective_breakdown"]
    parts = " ".join(f"{KINDS.get(k, k)} {v / 1e9:.3g}" for k, v in sorted(kinds.items()) if v)
    return f"{rec['bytes_per_device']['peak_est'] / 1e9:.1f} | {parts or '—'}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("first")
    ap.add_argument("second")
    ap.add_argument("--jax", default=None, help="the JAX package's records of the same sweep")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args()
    first, second = load(args.first), load(args.second)
    jax = {(k[0], k[1], k[2]): v for k, v in load(args.jax).items()} if args.jax else {}
    bad = 0
    for key, a in first.items():
        b = second.get(key)
        j = jax.get(key[:3])
        jpeak = j["bytes_per_device"]["peak_est"] if j else None
        if args.table:
            row = [f"{key[0]} {key[1]}", gb(a), gb(b) if b else "missing"]
            if args.jax:
                ratio = (f" ({b['bytes_per_device']['peak_est'] / jpeak:.2f}x)"
                         if b and jpeak else "")
                row.append(f"{jpeak / 1e9:.1f}{ratio}" if jpeak else "—")
            print("| " + " | ".join(row) + " |")
        if b is None:
            print(f"{key}: missing from {args.second}", file=sys.stderr)
            bad += 1
            continue
        diff = differences(a, b)
        if diff:
            bad += 1
            print(f"{key[0]} {key[1]} {key[2]}:", file=sys.stderr)
            for line in diff:
                print(f"  {line}", file=sys.stderr)
    print(f"{len(first)} records, {bad} differ beyond {TOLERANCE:.0%} or are missing",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
