"""The CLI and the driver outside the stages: each call's wall less the sum
of its stage clocks (pipeline/asv.STAGE_SECONDS), per 1,000 reads."""
from benchmark import readers


def read(record):
    staged = readers.ms_per_kread(record, "stage_s", "1", "2", "3", "4", "4p", "5", "6", "7")
    if staged is None or not readers.kreads(record):
        return None
    return 1e3 * sum(c["wall_s"] for c in record.calls) / readers.kreads(record) - staged
