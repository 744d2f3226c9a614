"""On the card: the port's `asv --device cuda`, with its device routes of
stages 4 and 7 ("mesh", the default) and with its per-job routes ("perjob":
--stage4-backend host --stage7-backend host), against the JAX package's host
run_cluster on chip_smoke.py's 5,000 reads ("main"), the same under the
rRNA-operon preset (--rrna-operon / rrna_operon=True) on its 10,000 operon
reads ("operon"), and on its scale phase's 100,000 reads of 48 templates
("scale"), in turns (ORDER below) after one untimed run of each, all in one
process.  Every run's outputs must equal
the first host run's, byte for byte; the wall time of each run, the port's
seconds by stage, inside its device routes (with the device milliseconds of
kernels 1 and 2 in each) and inside its per-job DP routes are printed as one
JSON line.

Skips without a card.  On the card (no jax there, so without this
directory's conftest; `-k main`, `-k operon` or `-k scale` for one sample):
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
from savont_tpu_torch.parallel import mesh
from savont_tpu_torch.pipeline import asv as port_asv

from _torch_jobs import clear_caches

ORDER = ("host", "mesh", "perjob", "perjob", "mesh", "host", "host", "mesh", "perjob")
ROUTES = {"mesh": [], "perjob": ["--stage4-backend", "host", "--stage7-backend", "host"]}


@pytest.mark.parametrize("sample", ["main", "operon", "scale"])
def test_card_run_matches_host_run_in_turns(tmp_path, sample):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fq, tpl = tmp_path / "reads.fq.gz", tmp_path / "templates.fa"
    operon = sample == "operon"
    if operon:
        chip_smoke.operon_sample(fq, tpl)
    elif sample == "scale":
        chip_smoke.scale_sample(fq, tpl)
    else:
        chip_smoke.write_reads(fq, tpl, chip_smoke.main_path_rng())
    preset = ["--rrna-operon"] if operon else []

    def run(side: str, out) -> dict:
        clear_caches()
        mesh.reset_route_stats()
        t0 = time.perf_counter()
        if side == "host":
            run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(out), threads=4,
                                    rrna_operon=operon))
            return {"side": side, "wall_s": time.perf_counter() - t0}
        assert cli.main(["--log-level", "warn", "asv", str(fq), "-o", str(out),
                         "--device", "cuda", "-t", "4", *preset, *ROUTES[side]]) == 0
        torch.cuda.synchronize()
        return {"side": side, "wall_s": time.perf_counter() - t0,
                "dp_route_s": sum(v for k, v in port_asv.STAGE_SECONDS.items()
                                  if k.endswith(".dp")),
                "device_route_s": {k: v["seconds"] for k, v in mesh.ROUTE_STATS.items()},
                "device_route_kernel_ms": {k: v["kernel_ms"] for k, v in mesh.ROUTE_STATS.items()},
                "stage_s": dict(port_asv.STAGE_SECONDS)}

    first = {side: run(side, tmp_path / f"{side}_warmup")["wall_s"]
             for side in ("host", "mesh", "perjob")}
    runs = []
    for i, side in enumerate(ORDER):
        runs.append(run(side, tmp_path / f"run{i}"))
        assert chip_smoke.output_digests(tmp_path / f"run{i}") == \
            chip_smoke.output_digests(tmp_path / "host_warmup")
        calls = [v["calls"] for v in mesh.ROUTE_STATS.values()]
        assert all(calls) if side == "mesh" else not any(calls)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"sample": sample, "card": smi, "first_runs_s": first, "runs": runs}))
