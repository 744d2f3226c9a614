"""Spans inside the port: the one way its modules time their parts.

`span(name, into, key)` is a context manager that adds the block's host
seconds (time.perf_counter) to `into[key]`.  While torch.profiler is
recording it also opens `record_function(name)`, so the part sits on the
profiler's clock beside the device's operations, and a trace's idle gaps
can be named by the innermost span open over them.  With nothing recording
it opens no record_function, records no CUDA event and never synchronises:
its cost is two clock reads and one check of the profiler's state.  A span
without a name is a plain timer, for counters that name no part of a trace.
The package records no CUDA event of its own: device time is read from the
profiler's trace.

`part(name)` is the span of a part of the running `asv` stage
(pipeline/asv._mark sets it with `enter_stage`): key "<stage>.<name>" in
the stage clocks' dict (pipeline/asv.STAGE_SECONDS), span "asv:<key>".
Outside a stage (classify, a test that calls a consumer directly) the key
is the bare name, in PART_SECONDS.

Rules every span keeps:
- no span inside a per-read, per-job or per-reference loop: the parts of
  such a loop's body are `Laps`, with one span around the loop or around
  each chunk of it;
- spans only on the thread that runs the pipeline: a trace's spans must
  nest (benchmark/trace.labelled), and one on another thread would not;
- a stage's parts close before the stage's clock does.
"""
from __future__ import annotations

import time

import torch

_recording = torch._C._autograd._profiler_enabled

# the parts timed outside an asv stage, by their bare names, summed
PART_SECONDS: dict[str, float] = {}

_STAGE: dict = {"into": PART_SECONDS, "prefix": ""}


class span:
    """with span(name, into, key): the block's seconds added to into[key]
    and, where `also` is a (dict, key) pair, to that entry too; a
    record_function(name) around the block while the profiler records
    (none for name None)."""

    __slots__ = ("name", "into", "key", "also", "t", "rf")

    def __init__(self, name: str | None, into: dict, key: str, also: tuple | None = None):
        self.name, self.into, self.key, self.also = name, into, key, also

    def __enter__(self):
        self.rf = None
        if self.name is not None and _recording():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t
        self.into[self.key] = self.into.get(self.key, 0.0) + dt
        if self.also is not None:
            d, k = self.also
            d[k] = d.get(k, 0.0) + dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def enter_stage(into: dict, stage: str | None) -> None:
    """The parts that follow belong to `stage` (None: to no stage) and add
    their seconds to `into`."""
    if stage is None:
        _STAGE.update(into=PART_SECONDS, prefix="")
    else:
        _STAGE.update(into=into, prefix=f"{stage}.")


def part(name: str, also: tuple | None = None) -> span:
    """The span of part `name` of the running asv stage (the module
    docstring says where it lands)."""
    key = _STAGE["prefix"] + name
    return span(f"asv:{key}" if _STAGE["prefix"] else name, _STAGE["into"], key, also)


class Laps:
    """Consecutive parts of a loop's body on the host clock, with no span:
    lap(key) adds the seconds since the previous lap (the first: since the
    Laps was made) to into[key]."""

    __slots__ = ("into", "t")

    def __init__(self, into: dict):
        self.into, self.t = into, time.perf_counter()

    def __call__(self, key: str) -> None:
        now = time.perf_counter()
        self.into[key] += now - self.t
        self.t = now
