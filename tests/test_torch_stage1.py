"""The port's stage-1 device route (`--stage1-backend mesh`: kernel 4 and the
count on the device, here their plain versions with --device cpu) against
the JAX package: read_to_split_kmers with SAVONT_DEVICE_KMERS unset (its
host scan) and set (its XLA extraction), on a seed-written fastq.gz with
'rc'-tagged reads and uneven qualities, in the exact, -b and
--aggressive-bloom modes; and a whole `asv --stage1-backend mesh --device
cpu` byte-identical to savont_tpu's host run.

Tolerance: 0."""
import gzip

import numpy as np
import pytest

from savont_tpu.config import ClusterArgs
from savont_tpu.ops.encode import revcomp_bytes
from savont_tpu.pipeline import stage1_kmers as jax_s1
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu_torch import cli
from savont_tpu_torch.config import ClusterArgs as PortClusterArgs
from savont_tpu_torch.ops import align_torch
from savont_tpu_torch.ops import kmers_torch as kt
from savont_tpu_torch.pipeline import stage1_kmers as port_s1

from _torch_jobs import clear_caches
from test_stage4_mesh import _workload

MODES = {"exact": {}, "bloom": {"bloom_filter_size": 1.0},
         "aggressive": {"bloom_filter_size": 1.0, "aggressive_bloom": True}}


def _rc_workload(path, seed=23, n_templates=3, per=24, L=700):
    """Reads of a few templates with 2-4 substitutions each, half of them
    reverse-complemented; a third of those carry cutadapt's ' rc' header
    suffix and their bases as sequenced (the counting flips them back).
    Qualities 'I' with a few low runs, and all-equal low rows.  Last, a
    sequence of its own twice and then its reverse complement: its k-mers
    pass the strand filter (counts 2 and 1) but not --aggressive-bloom's
    admission (no occurrence follows one of each strand)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    tpl = [rng.choice(bases, L).tobytes() for _ in range(n_templates)]
    with gzip.open(path, "wt") as f:
        for t, s0 in enumerate(tpl):
            for i in range(per):
                b = bytearray(s0)
                for p in rng.choice(L, int(rng.integers(2, 5)), replace=False):
                    b[p] = b"ACGT"[rng.integers(4)]
                s, tag = bytes(b), ""
                if i % 2:
                    s = revcomp_bytes(s)
                    if i % 3 == 0:
                        tag = " rc"
                q = bytearray(b"I" * len(s))
                if i % 5 == 0:
                    for p in rng.choice(len(s), 6, replace=False):
                        q[p : p + 4] = b"#" * len(q[p : p + 4])
                if i % 7 == 0:
                    q = bytearray(b"+" * len(s))
                f.write(f"@t{t}_r{i}{tag}\n{s.decode()}\n+\n{q.decode()}\n")
        u = rng.choice(bases, 300).tobytes()
        for i, s in enumerate((u, u, revcomp_bytes(u))):
            f.write(f"@u{i}\n{s.decode()}\n+\n{'I' * len(s)}\n")
    return path


@pytest.mark.parametrize("device_kmers", [False, True], ids=["jax_host", "jax_device"])
@pytest.mark.parametrize("mode", MODES)
def test_stage1_mesh_route_matches_jax(tmp_path, monkeypatch, mode, device_kmers):
    fq = _rc_workload(tmp_path / "reads.fq.gz")
    args = dict(input_files=[str(fq)], threads=2, **MODES[mode])
    if device_kmers:
        monkeypatch.setenv("SAVONT_DEVICE_KMERS", "1")
    else:
        monkeypatch.delenv("SAVONT_DEVICE_KMERS", raising=False)
    clear_caches()
    want_k, want_c = jax_s1.read_to_split_kmers(ClusterArgs(**args))
    clear_caches()
    kt.reset_counters()
    port_s1.reset_count_stats()
    got_k, got_c = port_s1.read_to_split_kmers(
        PortClusterArgs(stage1_backend="mesh", device="cpu", **args))
    assert len(want_k) > 100
    assert got_k.dtype == want_k.dtype and got_c.dtype == want_c.dtype
    assert got_k.tolist() == want_k.tolist() and got_c.tolist() == want_c.tolist()
    # the route ran kernel 4's plain version once, and counted its sizes
    st = port_s1.COUNT_STATS
    assert kt.REFERENCE_CALLS["split_kmers"] == 1 and kt.LAUNCHES["split_kmers"] == 0
    assert st["route"] == "mesh" and st["reads"] == 75 and st["positions"] > 0
    assert 0 < st["flagged"] <= st["positions"] and st["parse_encode_s"] > 0
    if mode == "exact":
        assert st["host_count_s"] == 0 and 0 < st["distinct"] <= st["flagged"]
    else:
        assert st["host_count_s"] > 0


def test_stage1_host_route_untouched(tmp_path):
    """The default route stays the host count and launches nothing."""
    fq = _rc_workload(tmp_path / "reads.fq.gz")
    clear_caches()
    kt.reset_counters()
    port_s1.reset_count_stats()
    args = PortClusterArgs(input_files=[str(fq)], threads=2, device="cpu")
    assert args.stage1_backend == "host"
    got = port_s1.read_to_split_kmers(args)
    clear_caches()
    want = jax_s1.read_to_split_kmers(ClusterArgs(input_files=[str(fq)], threads=2))
    assert all(a.tolist() == b.tolist() for a, b in zip(got, want))
    assert not any(kt.REFERENCE_CALLS.values()) and not any(kt.LAUNCHES.values())
    assert port_s1.COUNT_STATS["route"] == "host" and port_s1.COUNT_STATS["host_count_s"] > 0


def test_asv_stage1_mesh_cpu_byte_identical_to_host(tmp_path):
    fq = _workload(tmp_path)  # 2 templates x 40 reads, L=1400
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(tmp_path / "host"), threads=2,
                            min_cluster_size=5))
    clear_caches()
    kt.reset_counters()
    align_torch.reset_counters()
    rc = cli.main(["asv", str(fq), "-o", str(tmp_path / "port"), "--device", "cpu", "-t", "2",
                   "--min-cluster-size", "5", "--stage1-backend", "mesh"])
    assert rc == 0
    assert kt.REFERENCE_CALLS["split_kmers"] == 1 and align_torch.REFERENCE_CALLS["sw_forward_nm"] > 0
    for rel in ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv"):
        a = (tmp_path / "host" / rel).read_bytes()
        b = (tmp_path / "port" / rel).read_bytes()
        assert a and a == b, f"{rel} differs between the host run and the port's run"


def test_stage1_backend_is_validated():
    with pytest.raises(ValueError):
        PortClusterArgs(stage1_backend="x")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["asv", "r.fq", "--stage1-backend", "x"])
    ns = cli.build_parser().parse_args(["asv", "r.fq"])
    assert ns.stage1_backend == "host"
