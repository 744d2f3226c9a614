"""The stage-7 route's launch loop on the host, with the waits inside it: STAGE_SECONDS["7.launch"] (span asv:7.launch) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "7.launch")
