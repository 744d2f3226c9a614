"""Kernels 1 and 2 (ops/csrc/sw_forward.cu, sw_walk.cu): device milliseconds
in the profiler's trace per 1,000 reads of the window."""
from benchmark import readers


def read(record):
    s = readers.device_s(record, "sw_forward_kernel", "sw_walk_kernel")
    return None if s is None or not readers.kreads(record) else 1e3 * s / readers.kreads(record)
