"""On the card: the port's `asv --device cuda` against the JAX package's host
run_cluster on chip_smoke.py's 5,000 reads, in turns (host, port, port,
host, host, port) after one untimed run of each, all in one process.  Every
run's outputs must equal the first host run's, byte for byte; the wall time
of each run and the port's seconds inside its DP routes are printed as one
JSON line.

Skips without a card.  On the card (no jax there, so without this
directory's conftest):
    python -m pytest --noconftest -s -q tests/test_torch_card.py
"""
import json
import subprocess
import time

import pytest
import torch

import chip_smoke
from savont_tpu.config import ClusterArgs
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu_torch import cli
from savont_tpu_torch.ops import align_batch

from _torch_jobs import clear_caches

ORDER = ("host", "port", "port", "host", "host", "port")


def test_card_run_matches_host_run_in_turns(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fq, tpl = tmp_path / "reads.fq.gz", tmp_path / "templates.fa"
    chip_smoke.write_reads(fq, tpl, chip_smoke.main_path_rng())

    def run(side: str, out) -> tuple[float, float]:
        clear_caches()
        for k in align_batch.ROUTE_SECONDS:
            align_batch.ROUTE_SECONDS[k] = 0.0
        t0 = time.perf_counter()
        if side == "host":
            run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(out), threads=4))
        else:
            assert cli.main(["--log-level", "warn", "asv", str(fq), "-o", str(out),
                             "--device", "cuda", "-t", "4"]) == 0
            torch.cuda.synchronize()
        return time.perf_counter() - t0, sum(align_batch.ROUTE_SECONDS.values())

    first = {side: run(side, tmp_path / f"{side}_warmup")[0] for side in ("host", "port")}
    runs = []
    for i, side in enumerate(ORDER):
        wall, dp = run(side, tmp_path / f"run{i}")
        runs.append({"side": side, "wall_s": wall, "dp_route_s": dp if side == "port" else None})
        assert chip_smoke.output_digests(tmp_path / f"run{i}") == \
            chip_smoke.output_digests(tmp_path / "host_warmup")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "first_runs_s": first, "runs": runs}))
