"""The kernel wrappers' launch counters, in one registry, across CUDA graph
capture and replay.

Each wrapper keeps a dict of launches by entry, ``LAUNCHES``, made by
:func:`counter`, and adds one at every call. A call made while a graph is
captured launches nothing yet: :func:`captured_launches` takes the
capture's counts back out and returns what one replay launches, and
:func:`count_replays` adds a number of replays' launches.
"""
from __future__ import annotations

_COUNTERS: dict[str, dict] = {}  # entry -> the wrapper's LAUNCHES dict that holds it


def counter(entries: dict) -> dict:
    """Register ``entries`` ({entry: launches}, names unique across wrappers); return it."""
    if set(entries) & set(_COUNTERS):
        raise ValueError(f"launch counters already registered for {sorted(entries)}")
    _COUNTERS.update(dict.fromkeys(entries, entries))
    return entries


def counts() -> dict:
    """{entry: launches} of every registered counter."""
    return {name: c[name] for name, c in _COUNTERS.items()}


def reset() -> None:
    """Zero every registered counter."""
    for name, c in _COUNTERS.items():
        c[name] = 0


def total() -> int:
    """Every registered entry's launches, summed."""
    return sum(counts().values())


def captured_launches(before: dict) -> dict:
    """After a CUDA graph capture that began at ``before`` (:func:`counts`):
    restore the counts and return {entry: launches one replay makes} of
    the entries that launched."""
    captured = {name: n - before[name] for name, n in counts().items() if n != before[name]}
    for name, c in _COUNTERS.items():
        c[name] = before[name]
    return captured


def count_replays(captured: dict, replays: int) -> None:
    """Add the launches of ``replays`` replays of a graph whose capture
    returned ``captured`` (:func:`captured_launches`)."""
    for name, n in captured.items():
        _COUNTERS[name][name] += n * replays
