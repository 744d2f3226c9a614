"""The stage-7 route's tie sets and device EM (one wait an iteration): STAGE_SECONDS["7.em"] (span asv:7.em) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "7.em")
