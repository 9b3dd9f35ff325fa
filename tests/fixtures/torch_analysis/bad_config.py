"""RR004 fixture: a frozen config dataclass of the port that never
validates."""
from dataclasses import dataclass


@dataclass(frozen=True)
class SilentServeConfig:
    mode: str = "sharded"
    backend: str = "fused"
    q_max: int = -3  # an illegal value nothing will ever reject
