"""repro_torch.analysis — static verification of the port's source tree.

The port's counterpart of ``repro.analysis``, with the two passes that
read source alone (pure ``ast``; this package never imports the code it
checks):

  pass ``ast``    repo-rule source lint (``astlint``): the port's failure
                  modes as named rules RR001..RR004 — nothing initializes
                  CUDA, builds or loads a kernel or joins a process group
                  at import time; the host-side routing path stays pure
                  numpy; no bare float64 in the hot paths; frozen config
                  dataclasses validate.
  pass ``async``  race lint for the asyncio serving layer (``asynclint``):
                  RR005..RR008 — blocking calls on the event loop (a CUDA
                  synchronize among them), unconfined dual-thread writes,
                  lost tasks, orphanable request futures.

``# repro: noqa-RRxxx`` on the flagged line suppresses a finding, as in
the JAX package (the rules are the same family).

The JAX package's program passes (``hlo``, ``costs``, ``contracts`` and
their manifest ``invariants``) read XLA programs or run
``jax.eval_shape``; they have no counterpart here yet.

One front door, with no GPU and no CUDA::

    PYTHONPATH=src python -m repro_torch.analysis [--passes ast,async] [--root src/repro_torch]

writes ``ANALYSIS_TORCH.json`` (never the JAX lane's ``ANALYSIS.json``)
and exits 0 when clean, 1 on findings, 2 on an unknown pass.

This module is stdlib-only at import time (``Finding`` and the pass
registry).
"""
from __future__ import annotations

import dataclasses

PASSES = ("ast", "async")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: which pass, which rule, where, and what happened.

    ``where`` is ``path:line`` — a stable string a CI diff of the report
    can key on.
    """

    pass_name: str  # "ast" | "async"
    rule: str  # e.g. "RR001"
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
