"""Stage 4's AlignJob planning (ops/align_batch._plan_pairs): STAGE_SECONDS["4.plan"] (span asv:4.plan) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4.plan")
