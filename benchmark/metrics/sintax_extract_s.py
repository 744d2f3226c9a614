"""sintax's join of each chunk's reference bases into one buffer and their row offsets, for kernel 6 on the card: pipeline/sintax.SCORE_STATS["extract_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "extract_s")
