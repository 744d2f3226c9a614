"""Stages 5-6 on the host (merge, chimeras): STAGE_SECONDS "5" + "6" per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "5", "6")
