"""sintax's extract_kmers and np.unique of each reference: pipeline/sintax.SCORE_STATS["extract_s"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "sintax_stats", "extract_s")
