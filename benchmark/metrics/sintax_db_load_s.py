"""sintax's load of the database by the CLI (span sintax:db_load: registry.load_database, the taxonomy file read and indexed): pipeline/sintax.SCORE_STATS["db_load_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "db_load_s")
