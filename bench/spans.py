"""The program's own spans in a window's unit records: ``unit["trace"]`` is
what ``repro_torch.trace.drain()`` returned after that fit (a fit whose
program has no tracer carries none). Lookups the span readers share."""
from __future__ import annotations


def traced(records: dict) -> list[dict]:
    """The window's units that carry spans."""
    return [u for u in records["units"] if u.get("trace", {}).get("spans")]


def named(unit: dict, name: str) -> list[dict]:
    return [s for s in unit["trace"]["spans"] if s["name"] == name]


def ms(unit: dict, name: str) -> float:
    """Host ms of the unit's spans called ``name``, summed (0 where none)."""
    return sum(s["end_ns"] - s["start_ns"] for s in named(unit, name)) / 1e6


def attr(unit: dict, name: str, key: str) -> list:
    """Attribute ``key`` of the unit's spans called ``name``, where set."""
    return [s["attrs"][key] for s in named(unit, name) if s["attrs"].get(key) is not None]
