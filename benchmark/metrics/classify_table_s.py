"""classify's minimizer table (loaded from its cache beside the database) and candidates: pipeline/classify.CLASSIFY_SECONDS "table" + "candidates", seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "classify_parts_s", "table", "candidates")
