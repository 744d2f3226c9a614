"""Stage 1 (split k-mers, their count and filter): host seconds by the program's stage clock (pipeline/asv.STAGE_SECONDS["1"]) per 1,000 reads of the window."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "1")
