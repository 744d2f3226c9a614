"""sintax's reading of the database, reference by reference: the FASTA stream and the key and taxonomy lookups: pipeline/sintax.SCORE_STATS["parse_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "parse_s")
