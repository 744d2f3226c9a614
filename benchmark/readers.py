"""What the per-layer readers (metrics/<name>.py) share.  Each takes the
run's record and returns a number, or None where the run has nothing to
read: the harness then leaves the metric out of the result line."""
from __future__ import annotations


def _sum(record, counter: str, keys) -> float | None:
    """Sum over the window's calls of counter[key] for keys, None when no
    call recorded any of them."""
    seen, total = False, 0.0
    for c in record.calls:
        got = c["counters"].get(counter, {})
        for k in keys:
            if k in got:
                seen = True
                total += float(got[k])
    return total if seen else None


def kreads(record) -> float:
    return sum(c["work"] for c in record.calls if c["ok"]) / 1000.0


def ms_per_kread(record, counter: str, *keys: str) -> float | None:
    s = _sum(record, counter, keys)
    return None if s is None or not kreads(record) else 1e3 * s / kreads(record)


def per_call(record, counter: str, *keys: str, scale: float = 1.0) -> float | None:
    s = _sum(record, counter, keys)
    return None if s is None or not record.calls else scale * s / len(record.calls)


def device_s(record, *names: str) -> float | None:
    """Device seconds of the operations whose short name starts with one of
    names, from the trace; None without a trace or without such operations."""
    t = record.trace
    if t is None:
        return None
    hits = [v for k, v in t.op_s.items() if k.startswith(names)]
    return sum(hits) if hits else None


def idle_pct(record) -> float | None:
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
