"""Stage 4's device pileup route (parallel/mesh.mesh_stage4_pileups) and its analysis: STAGE_SECONDS["4p"] per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "4p")
