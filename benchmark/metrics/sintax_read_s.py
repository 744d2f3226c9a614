"""sintax's reads of the database's FASTA stream, a chunk of records at a time (span sintax:read): the native stream's inflate, lines and records as the call waits for them: pipeline/sintax.SCORE_STATS["read_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "read_s")
