"""Launch counts of the kernel wrappers across CUDA graph capture and replay.

Each wrapper keeps a dict of launches by entry (``svgp_proj.LAUNCHES``,
``adam.LAUNCHES``, ...) and adds one at every call. A call made while a
graph is captured launches nothing yet: :func:`captured_launches` takes
the capture's counts back out and returns what one replay launches, and
:func:`count_replays` adds a number of replays' launches.
"""
from __future__ import annotations


def captured_launches(launches: dict, before: dict) -> dict:
    """After a CUDA graph capture that began with the counts ``launches``
    at ``before``: restore the counts and return the launches one replay
    makes."""
    captured = {name: launches[name] - before[name] for name in launches}
    launches.update(before)
    return captured


def count_replays(launches: dict, captured: dict, replays: int) -> None:
    """Add to ``launches`` the launches of ``replays`` replays of a graph
    whose capture returned ``captured`` (:func:`captured_launches`)."""
    for name, n in captured.items():
        launches[name] += n * replays
