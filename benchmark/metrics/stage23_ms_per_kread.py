"""Stages 2-3 (SNPmers and clustering): STAGE_SECONDS "2" + "3" per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "2", "3")
