"""The stage-4 pileup route's fetch of the count matrices: STAGE_SECONDS["4p.fetch"] (span asv:4p.fetch) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4p.fetch")
