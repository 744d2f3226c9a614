"""Stage 7's device route (tie sets, EM) and the output files: STAGE_SECONDS["7"] per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "7")
