"""sintax's host k-mer extraction from the database: pipeline/sintax.SCORE_STATS["kmers_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "kmers_s")
