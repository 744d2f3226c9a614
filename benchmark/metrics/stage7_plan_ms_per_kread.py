"""The stage-7 route's flat plan (parallel/mesh._stage7_tie_break): STAGE_SECONDS["7.plan"] (span asv:7.plan) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "7.plan")
