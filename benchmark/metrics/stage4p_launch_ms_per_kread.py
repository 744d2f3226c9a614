"""The stage-4 pileup route's launch loop on the host, with the waits inside it: STAGE_SECONDS["4p.launch"] (span asv:4p.launch) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4p.launch")
