"""The slice as a whole on the CPU: the port's run_cluster through the
device routes of stages 4 and 7, and through the per-job consumers they
fall back to where the flat planner declines an input, on the workloads of
tests/test_stage4_mesh.py (with and without homopolymer compression) and of
tests/test_multichip.py's stage-7 test: byte-identical to each other and to
savont_tpu's host run.  And a guard on the route and kernel counters,
bounded below and above, with every ASV at NM=0 against its template.

Tolerance: 0.  The outputs are compared as bytes."""
import gzip

import numpy as np
import pytest

from savont_tpu.config import ClusterArgs
from savont_tpu.ops.encode import revcomp_bytes
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu_torch import cli
from savont_tpu_torch.config import ClusterArgs as PortClusterArgs
from savont_tpu_torch.ops import align_torch, traceback_torch
from savont_tpu_torch.parallel import mesh as port_mesh
from savont_tpu_torch.pipeline import asv as port_asv
from savont_tpu_torch.pipeline import pileup as port_pileup
from savont_tpu_torch.validate import validate_asvs

from _torch_jobs import clear_caches
from test_stage4_mesh import _workload

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
OUTPUTS = ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv")


def _stage7_workload(tmp_path):
    """The reads of tests/test_multichip.py::test_stage7_mesh_backend_end_to_end
    (two templates 4 SNPs apart, 40 reads each), and the templates."""
    rng = np.random.default_rng(17)
    t1 = bytearray(rng.choice(BASES, 1400).tobytes())
    t2 = bytearray(t1)
    for p in (160, 480, 800, 1200):
        t2[p] = b"ACGT"[(b"ACGT".index(bytes([t2[p]])) + 1) % 4]
    reads = []
    for tpl in (bytes(t1), bytes(t2)):
        for i in range(40):
            b = bytearray(tpl)
            for p in rng.choice(len(b), 2, replace=False):
                b[p] = b"ACGT"[rng.integers(4)]
            r = bytes(b)
            reads.append(revcomp_bytes(r) if i % 2 else r)
    fq = tmp_path / "reads7.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.decode()}\n+\n{'Z' * len(r)}\n")
    tpl = tmp_path / "templates7.fa"
    tpl.write_text(f">t1\n{bytes(t1).decode()}\n>t2\n{bytes(t2).decode()}\n")
    return fq, tpl


def _port_run(fq, out, **kw):
    clear_caches()
    port_asv.run_cluster(PortClusterArgs(
        input_files=[str(fq)], output_dir=str(out), threads=2, min_cluster_size=5,
        device="cpu", **kw))
    return out


@pytest.mark.parametrize("workload", ["stage4", "stage4_hpc", "stage7"])
def test_mesh_and_host_routes_byte_identical_to_the_reference(tmp_path, workload, monkeypatch):
    """The routes as planned, then with the flat planner declining every
    input, so that both stages take their per-job consumers."""
    use_hpc = workload == "stage4_hpc"
    fq = _stage7_workload(tmp_path)[0] if workload == "stage7" else _workload(tmp_path, hp=use_hpc)
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(tmp_path / "ref"), threads=2,
                            min_cluster_size=5, use_hpc=use_hpc))
    port_mesh.reset_route_stats()
    _port_run(fq, tmp_path / "mesh", use_hpc=use_hpc)  # the default routes
    st = {k: dict(v) for k, v in port_mesh.ROUTE_STATS.items()}
    assert st["stage4"]["calls"] >= 1 and st["stage7"]["calls"] >= 1, st
    assert st["stage4"]["fallbacks"] == st["stage7"]["fallbacks"] == 0, st
    monkeypatch.setattr(port_mesh, "_plan_soa_indexed", lambda *a, **k: None)
    port_mesh.reset_route_stats()
    _port_run(fq, tmp_path / "host", use_hpc=use_hpc)
    st = port_mesh.ROUTE_STATS
    assert st["stage4"]["fallbacks"] == st["stage4"]["calls"] >= 1, st
    assert st["stage7"]["fallbacks"] == st["stage7"]["calls"] >= 1, st
    for rel in OUTPUTS:
        ref = (tmp_path / "ref" / rel).read_bytes()
        assert ref, rel
        assert (tmp_path / "mesh" / rel).read_bytes() == ref, f"{rel}: mesh routes differ"
        assert (tmp_path / "host" / rel).read_bytes() == ref, f"{rel}: per-job consumers differ"


def test_route_guard_counters_bounded_and_asvs_exact(tmp_path):
    """One run through the CLI with the default routes: both device routes
    ran, a bounded number of times, each through the wrappers of kernel 1
    (both modes) and kernel 2 in a bounded number of launches (on the CPU
    the wrappers count their plain versions), no job fell to the per-job
    consumers, and both ASVs equal their templates."""
    fq, tpl = _stage7_workload(tmp_path)
    clear_caches()
    align_torch.reset_counters()
    port_mesh.reset_route_stats()
    rc = cli.main(["--log-level", "error", "asv", str(fq), "-o", str(tmp_path / "out"),
                   "--device", "cpu", "-t", "2", "--min-cluster-size", "5"])
    assert rc == 0
    st = port_mesh.ROUTE_STATS
    calls = dict(align_torch.REFERENCE_CALLS)
    # stage 4 builds pileups once per polishing pass, stage 7 breaks ties
    # once for the sample and once per input file
    assert 1 <= st["stage4"]["calls"] <= 4, st
    assert 1 <= st["stage7"]["calls"] <= 3, st
    assert st["stage4"]["fallbacks"] == 0 and st["stage7"]["fallbacks"] == 0
    assert st["stage4"]["overflow"] == 0 and align_torch.LAUNCHES["walk_overflow"] == 0
    # 80 reads: one or two plan jobs per (read, consensus) and (read, ASV)
    assert 80 <= st["stage4"]["jobs"] <= 4 * 2 * 80, st
    assert 80 <= st["stage7"]["jobs"] <= 3 * 2 * 2 * 80, st
    assert st["stage4"]["seconds"] > 0 and st["stage7"]["seconds"] > 0
    # one launch per route call at these sizes; the rest are the vote and
    # merge rounds of stages 4-6 on the per-job path
    assert st["stage7"]["calls"] <= calls["sw_forward_nm"] <= st["stage7"]["calls"] + 2, calls
    assert st["stage4"]["calls"] <= calls["sw_walk"] <= 40, calls
    assert calls["sw_walk"] == calls["sw_forward_payload"]
    assert not any(align_torch.LAUNCHES[k] for k in ("sw_forward_nm", "sw_forward_payload", "sw_walk"))
    val = validate_asvs(str(tmp_path / "out" / "final_asvs.fasta"), str(tpl))
    assert len(val) == 2 and all(v.nm == 0 for v in val), val


def test_stage4_route_counts_overflow_pairs_on_the_host(tmp_path, monkeypatch):
    """With kernel 2's run rows cut to one run, every pair whose CIGAR has
    more than one run overflows and is counted through the host oracle and
    read_pileup_indices: the matrices still equal the host route's."""
    rng = np.random.default_rng(41)
    tpl = rng.choice(BASES, 1300).tobytes()
    fq = tmp_path / "indel_reads.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i in range(24):
            b = bytearray(tpl)
            for p in rng.choice(len(b), 3, replace=False):
                b[p] = b"ACGT"[rng.integers(4)]
            if i % 3 == 0:  # a short deletion: the CIGAR has three runs
                p = int(rng.integers(60, 1220))
                del b[p : p + int(rng.integers(2, 5))]
            r = revcomp_bytes(bytes(b)) if i % 2 else bytes(b)
            f.write(f"@r{i}\n{r.decode()}\n+\n{'Z' * len(r)}\n")
    seen = {}
    real = port_pileup.generate_consensus_pileups

    def both(twin_reads, consensuses, args):
        host = port_pileup.host_consensus_pileups(twin_reads, consensuses, args)
        hp_host = [c.hp_lengths.copy() for c in consensuses]
        monkeypatch.setattr(traceback_torch, "MAXRUN", 1)
        dev = real(twin_reads, consensuses, args)
        monkeypatch.setattr(traceback_torch, "MAXRUN", 512)
        seen["overflow"] = seen.get("overflow", 0) + port_mesh.ROUTE_STATS["stage4"]["overflow"]
        for hm, dm in zip(host, dev):
            for name in ("bq", "dels", "ins_q"):
                assert np.array_equal(getattr(hm, name), getattr(dm, name)), name
        for a, c in zip(hp_host, consensuses):
            assert np.array_equal(a, c.hp_lengths)
        return dev

    monkeypatch.setattr(port_pileup, "generate_consensus_pileups", both)
    port_mesh.reset_route_stats()
    _port_run(fq, tmp_path / "o")
    assert seen["overflow"] >= 8  # the eight reads with a deletion, at least once
    assert align_torch.LAUNCHES["walk_overflow"] >= seen["overflow"]


def test_stage4_route_falls_to_the_per_job_consumer_and_counts_it(tmp_path, monkeypatch):
    fq = _workload(tmp_path, n_reads=16)
    _port_run(fq, tmp_path / "a")
    monkeypatch.setattr(port_mesh, "_plan_soa_indexed", lambda *a, **k: None)
    port_mesh.reset_route_stats()
    _port_run(fq, tmp_path / "b")
    st = port_mesh.ROUTE_STATS
    assert st["stage4"]["fallbacks"] == st["stage4"]["calls"] >= 1
    assert st["stage7"]["fallbacks"] == st["stage7"]["calls"] >= 1
    for rel in OUTPUTS:
        assert (tmp_path / "a" / rel).read_bytes() == (tmp_path / "b" / rel).read_bytes(), rel


def test_route_parts_on_the_cpu(tmp_path):
    """A run on the CPU times every part of both device routes into the
    stage clocks, and stage 7 has no EM part: its EM runs on the host."""
    port_mesh.reset_route_stats()
    _port_run(_workload(tmp_path, n_reads=16), tmp_path / "o")
    st = port_mesh.ROUTE_STATS
    assert st["stage4"]["calls"] >= 1 and st["stage7"]["calls"] >= 1
    assert st["stage4"]["seconds"] > 0.0 and st["stage7"]["seconds"] > 0.0
    parts = {k for k in port_asv.STAGE_SECONDS if "." in k}
    for name in ("4p.plan", "4p.upload", "4p.launch", "4p.fetch",
                 "7.plan", "7.upload", "7.launch", "7.fetch"):
        assert name in parts, (name, sorted(parts))
    assert "7.em" not in parts
    assert not any("kernel_ms" in v for v in port_mesh.ROUTE_STATS.values())


def test_route_fields_and_flags():
    """The routes of stages 4 and 7 have no switch: no field, no flag."""
    a = PortClusterArgs()
    assert a.device == "cuda" and a.stage1_backend == "host"
    ns = cli.build_parser().parse_args(["asv", "x.fq"])
    for stage in (4, 7):
        name = f"stage{stage}_backend"
        assert not hasattr(a, name) and not hasattr(ns, name)
        with pytest.raises(TypeError):
            PortClusterArgs(**{name: "mesh"})
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["asv", "x.fq", f"--stage{stage}-backend", "host"])
