"""The stage-7 route's fetch of (score, nm) and the abundances: STAGE_SECONDS["7.fetch"] (span asv:7.fetch) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "7.fetch")
