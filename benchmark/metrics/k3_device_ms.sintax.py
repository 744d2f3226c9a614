"""Kernel 3 (ops/csrc/sintax_scores.cu): device milliseconds in the
profiler's trace per sintax call."""
from benchmark import readers


def read(record):
    s = readers.device_s(record, "sintax_rows_kernel")
    return None if s is None or not record.calls else 1e3 * s / len(record.calls)
