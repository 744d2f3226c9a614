"""Stage 1's native scan, count and merge on the main thread, and the strand filter: STAGE_SECONDS["1.count"] (span asv:1.count) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "1.count")
