"""Artifact format=2: an append-only versioned store of serving artifacts.

Format=1 (``api.FittedPSVGP.save``) is one directory = one model. The
in-situ loop produces one model PER SIMULATION STEP, and the paper's
whole premise is that these per-step summaries are small enough to keep
all of them (a few KB per partition per step, versus the raw field). The
store is the on-disk shape of that loop:

    store/
    ├── store.json            the step index: {"format": 2, "steps": [...]}
    ├── step_00000000/        one FULL format=1 artifact per step
    │   ├── artifact.json     (manifest: FitConfig + grid geometry)
    │   ├── arrays.npz
    │   └── manifest.msgpack
    ├── step_00000001/
    │   └── ...
    └── ...

Properties the lifecycle relies on:

  * APPEND-ONLY: a step id can be committed once; re-committing raises.
    Steps need not be contiguous, but must be strictly increasing — the
    index is the simulation's timeline.
  * CRASH-SAFE commits: the step directory is fully written BEFORE the
    index is rewritten (atomically, tmp + ``os.replace``). A crash
    mid-save leaves at worst an orphan step directory the index never
    mentions — every indexed step is complete.
  * PURE-JSON PEEK: this module is stdlib-only, and ``store.json`` +
    each step's ``artifact.json`` are plain JSON — the step index and any
    step's FitConfig are readable before any device work starts.
  * FORMAT=1 READ-COMPAT: each step directory IS a format=1 artifact, so
    ``FittedPSVGP.load(store/step_00000003)`` works unchanged, and
    format=1 directories keep loading exactly as before.
"""
from __future__ import annotations

import json
import os

STORE_INDEX = "store.json"
STORE_FORMAT = 2


def step_dir_name(step: int) -> str:
    """Directory name of step ``step`` inside a store ("step_00000042")."""
    if int(step) < 0:
        raise ValueError(f"store steps are >= 0, got {step}")
    return f"step_{int(step):08d}"


def is_store(path: str) -> bool:
    """True if ``path`` is a format=2 store (has a ``store.json`` index)."""
    return os.path.isfile(os.path.join(path, STORE_INDEX))


def read_index(path: str) -> dict:
    """The raw store index: ``{"format": 2, "steps": [{"step", "dir", ...}]}``.

    Pure stdlib. Raises on a missing index
    or a format this build does not read.
    """
    with open(os.path.join(path, STORE_INDEX)) as f:
        index = json.load(f)
    if index.get("format") != STORE_FORMAT:
        raise ValueError(
            f"store at {path!r} has format {index.get('format')!r}; "
            f"this build reads format {STORE_FORMAT}"
        )
    return index


def store_steps(path: str) -> list[int]:
    """The committed step ids, in commit (= ascending) order."""
    return [int(e["step"]) for e in read_index(path)["steps"]]


def step_dir(path: str, step: int | None = None) -> str:
    """Absolute directory of ``step`` (latest committed step when None) —
    a format=1 artifact directory, loadable on its own."""
    entries = read_index(path)["steps"]
    if not entries:
        raise ValueError(f"store at {path!r} has no committed steps")
    if step is None:
        entry = entries[-1]
    else:
        by_id = {int(e["step"]): e for e in entries}
        if int(step) not in by_id:
            raise KeyError(
                f"store at {path!r} has no step {step}; "
                f"committed steps: {sorted(by_id)}"
            )
        entry = by_id[int(step)]
    return os.path.join(path, entry["dir"])


def commit_step(path: str, step: int, dirname: str, meta: dict | None = None) -> None:
    """Append ``step`` -> ``dirname`` to the store index, atomically.

    The caller must have FINISHED writing the step directory first — the
    index rewrite (tmp file + ``os.replace``) is the commit point, so a
    crash before it leaves only an unindexed orphan directory. Appending
    an already-committed step, or a step id not greater than the newest
    committed one, raises (the store is append-only, strictly increasing).
    ``meta`` (plain-JSON observability: refit wall-clock, fit metrics,
    ...) is merged into the step's index entry.
    """
    os.makedirs(path, exist_ok=True)
    index_path = os.path.join(path, STORE_INDEX)
    if os.path.exists(index_path):
        index = read_index(path)
    else:
        index = {"format": STORE_FORMAT, "steps": []}
    steps = [int(e["step"]) for e in index["steps"]]
    if int(step) in steps:
        raise ValueError(
            f"step {step} is already committed in the store at {path!r} — "
            "the store is append-only; each simulation step commits once"
        )
    if steps and int(step) <= max(steps):
        raise ValueError(
            f"step {step} is older than the newest committed step "
            f"{max(steps)} — the store index is the simulation timeline "
            "and only moves forward"
        )
    entry = {"step": int(step), "dir": dirname}
    if meta:
        clash = set(meta) & set(entry)
        if clash:
            raise ValueError(f"step meta may not override index keys {sorted(clash)}")
        entry.update(json.loads(json.dumps(meta)))  # plain-JSON values only
    index["steps"].append(entry)
    tmp = index_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f, indent=2)
        f.write("\n")
    os.replace(tmp, index_path)
