"""The stage-4 pileup route's payload and flat plan (parallel/mesh._stage4_pileups): STAGE_SECONDS["4p.plan"] (span asv:4p.plan) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4p.plan")
