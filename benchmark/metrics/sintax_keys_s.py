"""sintax's key and taxonomy lookups of the database's records, record by record (laps inside span sintax:extract): pipeline/sintax.SCORE_STATS["keys_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "keys_s")
