"""Stage 1's SNPmers (and blockmers) and stage 1.5's TwinReads: STAGE_SECONDS["1.twin"] (span asv:1.twin) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "1.twin")
