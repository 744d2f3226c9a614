"""Reading a torch.profiler trace (Chrome trace JSON) of the window.

Device operations are the kernel, memcpy and memset events.  The device's
busy time is the union of their intervals inside the window (from the first
call span's start to the last one's end); an idle gap is a stretch of the
window that no device operation covers, named by the innermost span that
was open on the host then (the benchmark's call spans and the program's
stage marks), or `outside_the_spans`.
"""
from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
CALL_PREFIX = "bench:"


def short_name(name: str) -> str:
    """A device operation's name without return type, anonymous namespace,
    template arguments and parameters: `void (anonymous
    namespace)::sw_forward_kernel<4, true>(...)` -> sw_forward_kernel."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "_".join(name.split()[:2])
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


@dataclass
class Summary:
    window_s: float
    busy_s: float
    op_s: dict = field(default_factory=dict)    # short name -> device seconds (summed)
    gap_s: dict = field(default_factory=dict)   # span name -> idle seconds

    def top(self, d: dict, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def labelled(spans):
    """Nested host spans (start, end, name) -> disjoint (start, end, name)
    pieces, each named by the innermost span open there."""
    pieces, stack = [], []
    t = None

    def advance(to):
        nonlocal t
        while stack and stack[-1][1] <= to:
            s = stack.pop()
            if t < s[1]:
                pieces.append((t, s[1], s[2]))
            t = max(t, s[1])
        if stack and t < to:
            pieces.append((t, to, stack[-1][2]))
        t = to if t is None else max(t, to)

    for s in sorted(spans, key=lambda s: (s[0], -s[1])):
        if t is None:
            t = s[0]
        advance(s[0])
        stack.append(s)
    if stack:
        advance(max(s[1] for s in stack))
    return pieces


def summarize(events: list[dict]) -> Summary | None:
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    calls = [s for s in spans if s[2].startswith(CALL_PREFIX)]
    if not calls:
        return None
    w0, w1 = min(s[0] for s in calls), max(s[1] for s in calls)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    op_s: dict = defaultdict(float)
    ivs = []
    for e in ops:
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b > a:
            op_s[short_name(e["name"])] += (b - a) * 1e-6
            ivs.append((a, b))
    busy = union(ivs)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gap_s: dict = defaultdict(float)
    pieces = labelled(spans)
    i = 0
    for a, b in gaps:
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                gap_s[pieces[j][2]] += (hi - lo) * 1e-6
                covered += hi - lo
            j += 1
        if b - a > covered:
            gap_s["outside_the_spans"] += (b - a - covered) * 1e-6
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                   op_s=dict(op_s), gap_s=dict(gap_s))


def read_trace(path: Path) -> Summary | None:
    with open(path) as f:
        doc = json.load(f)
    return summarize(doc.get("traceEvents", []) if isinstance(doc, dict) else doc)
