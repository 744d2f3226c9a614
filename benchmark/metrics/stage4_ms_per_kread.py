"""Stage 4's consensus votes (ops/align_batch.run_jobs): STAGE_SECONDS["4"] per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4")
