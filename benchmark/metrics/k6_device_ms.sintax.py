"""Kernel 6 (ops/csrc/sintax_ref_kmers.cu, the references' k-mers on the
card): device milliseconds in the profiler's trace per sintax call; nothing
for a program without it."""
from benchmark import readers


def read(record):
    s = readers.device_s(record, "sintax_ref_kmers_kernel")
    return None if s is None or not record.calls else 1e3 * s / len(record.calls)
