"""repro_torch.analysis — static verification of the port's serving stack.

The port's counterpart of ``repro.analysis``, with JAX's five passes in
JAX's order:

  pass ``hlo``        the per-lane invariant manifest (``invariants.LANES``)
                      on a recorded trace of every serving program: one
                      probe request through the lane's real stages, every
                      aten op (a ``TorchDispatchMode``), kernel dispatch
                      and collective it made, on every rank of the mesh —
                      collective and kernel budgets, forbidden ops, the
                      f64 policy, host transfers. The port has no program
                      text to lower; the trace stands in for StableHLO.
  pass ``ast``        repo-rule source lint (``astlint``): RR001..RR004 —
                      nothing initializes CUDA, builds or loads a kernel
                      or joins a process group at import time; the
                      host-side routing path stays pure numpy; no bare
                      float64 in the hot paths; frozen config dataclasses
                      validate.
  pass ``contracts``  shape contracts: ``@contract`` declarations on the
                      four serving entry points, checked on fake tensors
                      (``FakeTensorMode``) and real host data.
  pass ``costs``      cost-model gates: five shape-derived metrics of every
                      ref program at JAX's scale points, fitted exponents
                      (per-rank bytes flat in P on the mesh, flops linear
                      in q_max) against ``invariants.COST_BUDGETS`` and
                      drift against the port's own baseline
                      (``analysis_costs.json`` beside this file).
  pass ``async``      race lint for the asyncio serving layer
                      (``asynclint``): RR005..RR008 — blocking calls on the
                      event loop (a CUDA synchronize among them),
                      unconfined dual-thread writes, lost tasks,
                      orphanable request futures.

``# repro: noqa-RRxxx`` on the flagged line suppresses a source finding,
as in the JAX package.

One front door::

    PYTHONPATH=src python -m repro_torch.analysis --device cpu     # all five
    PYTHONPATH=src python -m repro_torch.analysis --passes ast,async  # no device

writes ``ANALYSIS_TORCH.json`` (never the JAX lane's ``ANALYSIS.json``)
and exits 0 when clean, 1 on findings, 2 on an unknown pass, a refused
report path or a device it does not have. The program passes run on
``--device`` (``cuda`` unless told otherwise); the source passes need no
device and import no torch.

This module is stdlib-only at import time (``Finding`` and the pass
registry).
"""
from __future__ import annotations

import dataclasses

PASSES = ("hlo", "ast", "contracts", "costs", "async")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: which pass, which rule, where, and what happened.

    ``where`` is ``path:line`` for source findings, ``lane:<name>``,
    ``target:<name>`` or ``program:<name>`` for the program passes — stable
    strings a CI diff of the report can key on.
    """

    pass_name: str  # "hlo" | "ast" | "contracts" | "costs" | "async"
    rule: str  # e.g. "RR001", "HLO-FORBIDDEN-OP", "COST-BUDGET"
    where: str
    message: str

    def __post_init__(self) -> None:
        if self.pass_name not in PASSES:
            raise ValueError(f"pass_name must be one of {PASSES}, got {self.pass_name!r}")
        if not (self.rule and self.where and self.message):
            raise ValueError("rule/where/message must be non-empty")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.message}"


__all__ = ["Finding", "PASSES"]
