"""The stage-4 pileup route's uploads: the plan, the target pool and the per-pair pools: STAGE_SECONDS["4p.upload"] (span asv:4p.upload) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4p.upload")
