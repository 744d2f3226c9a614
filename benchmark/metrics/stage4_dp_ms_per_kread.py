"""Stage 4's per-job DP route (ops/align_batch.run_jobs: packing, kernels 1-2, fetch): STAGE_SECONDS["4.dp"] (span asv:4.dp) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4.dp")
