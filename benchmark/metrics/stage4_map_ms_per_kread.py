"""Stage 4's Mapping building and winner picking (ops/align_batch._best_per_pair): STAGE_SECONDS["4.map"] (span asv:4.map) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4.map")
