"""classify's route (flat planner, kernel 1 NM, the written hits' starts): CLASSIFY_SECONDS["route"], seconds a call."""
from benchmark import readers


def read(record):
    return readers.per_call(record, "classify_parts_s", "route")
