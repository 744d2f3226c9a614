"""sintax's chunk flushes (span sintax:flush): the uploads of a chunk's bases, offsets and record indices and the launches of kernels 6 and 3: pipeline/sintax.SCORE_STATS["flush_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "flush_s")
