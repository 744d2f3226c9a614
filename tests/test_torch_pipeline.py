"""The port's asv slice as a whole on the CPU: `savont_tpu_torch.cli.main`
(what `python -m savont_tpu_torch` runs) with --device cpu, and the port's
run_cluster, against savont_tpu's host run_cluster on the same reads.

Tolerance: 0.  The outputs must be byte-identical."""
import pytest

from savont_tpu.config import ClusterArgs
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu_torch import cli
from savont_tpu_torch.config import ClusterArgs as PortClusterArgs
from savont_tpu_torch.ops import align_torch
from savont_tpu_torch.pipeline import asv as port_asv

from _torch_jobs import clear_caches
from test_stage4_mesh import _workload


@pytest.mark.parametrize("entry", ["cli", "run_cluster"])
def test_port_asv_cpu_byte_identical_to_host(tmp_path, entry):
    fq = _workload(tmp_path)  # 2 templates x 40 reads, L=1400
    args = dict(input_files=[str(fq)], threads=2, min_cluster_size=5)
    clear_caches()
    run_cluster(ClusterArgs(output_dir=str(tmp_path / "host"), **args))

    clear_caches()
    align_torch.reset_counters()
    if entry == "cli":
        rc = cli.main(["asv", str(fq), "-o", str(tmp_path / "port"), "--device", "cpu",
                       "-t", "2", "--min-cluster-size", "5"])
        assert rc == 0
    else:
        port_asv.run_cluster(PortClusterArgs(output_dir=str(tmp_path / "port"), device="cpu", **args))
    calls = dict(align_torch.REFERENCE_CALLS)
    # every DP of stages 4-7 went through the port's routes
    for k in ("sw_forward_nm", "sw_forward_payload", "sw_walk"):
        assert calls[k] > 0, calls
    assert align_torch.LAUNCHES["sw_forward_nm"] == 0

    for rel in ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv"):
        a = (tmp_path / "host" / rel).read_bytes()
        b = (tmp_path / "port" / rel).read_bytes()
        assert a and a == b, f"{rel} differs between the host run and the port's run"
