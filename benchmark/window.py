"""The measured window: one client making whole calls back to back.

A call starts while the elapsed time is under `seconds`; the window ends
when the last call returns.  Work is counted over all of the window, so a
stall between or inside calls counts against the rate.
"""
from __future__ import annotations

import time


def closed_loop(call, seconds: float, clock=time.perf_counter) -> tuple[list[dict], float]:
    """Run call(i) -> dict (with "work" and "ok") back to back; return the
    calls, each with its start and end in seconds from the window's start,
    and the window's length."""
    calls: list[dict] = []
    t0 = clock()
    while clock() - t0 < seconds:
        a = clock()
        info = call(len(calls))
        b = clock()
        calls.append({**info, "start": a - t0, "end": b - t0, "wall_s": b - a})
    return calls, (calls[-1]["end"] if calls else 0.0)


def end_to_end(kind: str, calls: list[dict], window_s: float) -> float:
    """work_per_s: the work of every call that succeeded over the whole
    window; s_per_call: the window over its calls."""
    if kind == "work_per_s":
        return sum(c["work"] for c in calls if c["ok"]) / window_s
    if kind == "s_per_call":
        return window_s / len(calls)
    raise ValueError(f"unknown end-to-end kind {kind!r}")
