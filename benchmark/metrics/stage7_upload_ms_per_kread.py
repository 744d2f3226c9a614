"""The stage-7 route's uploads: the plan, the ASV pool and the rows' read and ASV ids: STAGE_SECONDS["7.upload"] (span asv:7.upload) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "7.upload")
