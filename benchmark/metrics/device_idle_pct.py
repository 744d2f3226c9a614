"""The device's idle share of the window, from the profiler's timeline
(every `device_idle_pct.<cell's traffic>` metric)."""
from benchmark import readers


def read(record):
    return readers.idle_pct(record)
