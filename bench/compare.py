"""The comparison that decides ``correct`` for a training cell.

Two quantities, each leaf by leaf:

* ``grad1``: the first step's gradient as the optimizer got it, which the
  program's state after one step gives as mu / (1 - b1);
* ``change``: the parameters' change over the compared steps, of the
  leaves whose first gradient in the reference is not nought to rounding
  (at least a thousandth of the median leaf's).

A leaf's gap is that between the program's norm of the leaf and the
reference's (a gap of norms does not swing with the sign of an element
that rounding decides). ``grad1_gap`` and ``change_gap`` are the worst
leaf's gap over the reference's norm of that leaf or of the median leaf,
whichever is larger; ``grad1_gap.<leaf>`` is each leaf's gap over its own
reference norm (floored at a thousandth of the median leaf's), which
holds the small leaves that the median would hide. A cell's limits file
names the numbers it compares.
"""
from __future__ import annotations

import statistics

MOVED_SHARE = 1e-3


def norms(tree: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], leaves) -> list[float]:
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]


def moved_leaves(ref_grad1: dict[str, float]) -> list[str]:
    med = statistics.median(ref_grad1.values())
    return [k for k, v in ref_grad1.items() if v >= MOVED_SHARE * med]


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref`` hold by leaf ``grad1``, ``p0`` and ``p_end``
    (tensors); returns {number: value}."""
    g_ref = norms(ref["grad1"])
    change_prog = norms({k: prog["p_end"][k].double() - prog["p0"][k].double() for k in g_ref})
    change_ref = norms({k: ref["p_end"][k] - ref["p0"][k] for k in g_ref})
    g_prog = norms(prog["grad1"])
    floor = MOVED_SHARE * statistics.median(g_ref.values())
    out = {"grad1_gap": max(leaf_gaps(g_prog, g_ref, g_ref)),
           "change_gap": max(leaf_gaps(change_prog, change_ref, moved_leaves(g_ref)))}
    for k in g_ref:
        out[f"grad1_gap.{k}"] = abs(g_prog[k] - g_ref[k]) / max(g_ref[k], floor)
    return out
