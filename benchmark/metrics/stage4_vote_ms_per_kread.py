"""Stage 4's consensus votes (pipeline/stage4_consensus._vote_consensus_batch): STAGE_SECONDS["4.vote"] (span asv:4.vote) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4.vote")
