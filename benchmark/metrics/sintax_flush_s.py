"""sintax's chunk flushes (span sintax:flush): ragged rows, uploads and kernel-3 launches: pipeline/sintax.SCORE_STATS["flush_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "flush_s")
