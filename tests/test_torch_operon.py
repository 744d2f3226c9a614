"""The rRNA-operon preset (--rrna-operon: reads of 3,500 to 5,000 bp, DP band
128) on the port, on the CPU:

  - `savont_tpu_torch.cli.main(["asv", ..., "--rrna-operon", "--device",
    "cpu"])` against the JAX package's host run_cluster(rrna_operon=True)
    on reads of two 4,400-bp templates, with stages 4 and 7 on the port's
    device routes (their plain versions on the CPU) at band 128;
  - the stage-4 launch cut at operon sizes (length_chunks_lens);
  - kernels 1 (both modes) and 2's plain versions at operon shapes
    (4,400-bp pairs at band 128, ops_max about 9,000) against the JAX
    package's XLA forwards (sw_forward_meta(smooth=False), _forward_payload)
    and walk + RLE (sw_traceback_from_payload), and the traceback route
    against its host DP (run_jobs).

Tolerance: 0.  Outputs are bytes, every kernel output an integer."""
import gzip
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from savont_tpu.config import ClusterArgs
from savont_tpu.ops import align_jax
from savont_tpu.ops.align_batch import run_jobs
from savont_tpu.ops.encode import revcomp_bytes
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu_torch import cli
from savont_tpu_torch.ops import align_torch
from savont_tpu_torch.ops.align_torch import (
    PAYLOAD_BYTES, jobs_to_tensors, length_chunks_lens, sw_forward_reference,
)
from savont_tpu_torch.ops.traceback_torch import sw_traceback_jobs, walk_rle_reference
from savont_tpu_torch.parallel import mesh as port_mesh

from _torch_jobs import clear_caches, rand_seq, substitute

BAND = 128
OPERON_LEN = 4400
OUTPUTS = ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv")


def _operon_reads(path, n_per: int = 20, seed: int = 43):
    """Two 4,400-bp templates four SNPs apart (as tests/test_presets.py
    makes them), n_per reads of each: 0.4% substitutions, every third read
    with a 2-4 bp deletion, odd reads reverse-complemented."""
    rng = np.random.default_rng(seed)
    t1 = rand_seq(rng, OPERON_LEN)
    t2 = bytearray(t1)
    for p in (500, 1500, 2500, 3500):
        t2[p] = b"ACGT"[(b"ACGT".index(bytes([t2[p]])) + 1) % 4]
    with gzip.open(path, "wt") as f:
        for ti, tpl in enumerate((t1, bytes(t2))):
            for i in range(n_per):
                r = substitute(rng, tpl, 0.004)
                if i % 3 == 0:
                    p = int(rng.integers(200, OPERON_LEN - 200))
                    del r[p : p + int(rng.integers(2, 5))]
                r = revcomp_bytes(bytes(r)) if i % 2 else bytes(r)
                f.write(f"@operon_t{ti}_r{i}\n{r.decode()}\n+\n{'Z' * len(r)}\n")


def test_operon_cli_cpu_byte_identical_to_host(tmp_path, monkeypatch):
    fq = tmp_path / "operon.fq.gz"
    _operon_reads(fq)
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(tmp_path / "host"), threads=2,
                            rrna_operon=True, min_cluster_size=5))

    bands = []
    for name in ("sw_forward", "sw_pileup_counts"):
        real = getattr(port_mesh, name)

        def spy(*a, _real=real, _name=name, **k):
            bands.append((_name, a[4] if _name == "sw_forward" else a[10]))
            return _real(*a, **k)

        monkeypatch.setattr(port_mesh, name, spy)
    clear_caches()
    align_torch.reset_counters()
    port_mesh.reset_route_stats()
    rc = cli.main(["asv", str(fq), "-o", str(tmp_path / "port"), "--device", "cpu", "-t", "2",
                   "--rrna-operon", "--min-cluster-size", "5"])
    assert rc == 0
    for rel in OUTPUTS:
        a = (tmp_path / "host" / rel).read_bytes()
        b = (tmp_path / "port" / rel).read_bytes()
        assert a and a == b, f"{rel} differs between the host run and the port's run"
    assert (tmp_path / "port" / "final_asvs.fasta").read_text().count(">") == 2

    # stages 4 and 7 on the device routes, every planned job through them, at
    # band 128; on the CPU the kernels' plain versions, no launch
    st = port_mesh.ROUTE_STATS
    for route in ("stage4", "stage7"):
        s = st[route]
        assert s["calls"] >= 1 and s["fallbacks"] == 0, (route, s)
        assert s["jobs"] == s["planned"] > 0 and sum(s["launch_jobs"]) == s["jobs"], (route, s)
        assert max(s["launch_lq"]) >= 3500, (route, s)
    assert {name for name, _ in bands} == {"sw_forward", "sw_pileup_counts"}
    assert {b for _, b in bands} == {BAND}
    assert st["stage4"]["ops_max"] >= 2 * 3500
    assert all(align_torch.REFERENCE_CALLS[k] > 0 for k in ("sw_forward_nm", "sw_forward_payload",
                                                            "sw_walk"))
    assert not any(align_torch.LAUNCHES[k] for k in ("sw_forward_nm", "sw_forward_payload", "sw_walk"))


@pytest.mark.parametrize("n_pairs, jobs_per_pair", [(5000, 2), (3001, 1), (1200, 3)])
def test_stage4_launch_cut_keeps_pairs_whole_at_operon_sizes(n_pairs, jobs_per_pair):
    """At 3.5-5 kb queries and band 128 a job's payload is 0.45-0.64 MB, so
    the stage-4 route cuts its launches at about 1,900 jobs: every cut falls
    between pairs, every job is in one launch, and a launch passes
    PAYLOAD_BYTES by less than one pair's jobs."""
    rng = np.random.default_rng(n_pairs)
    pair_len = rng.integers(3500, 5001, n_pairs)
    owner = np.repeat(np.arange(n_pairs), jobs_per_pair)
    lens = pair_len[owner]
    chunks = length_chunks_lens(lens, BAND, payload=True, group=owner)
    assert len(chunks) >= 2
    assert np.array_equal(np.sort(np.concatenate(chunks)), np.arange(len(lens)))
    owners = [set(owner[c].tolist()) for c in chunks]
    for a in range(len(owners)):
        for b in range(a + 1, len(owners)):
            assert not owners[a] & owners[b]
    for c in chunks:
        payload = len(c) * int(lens[c].max()) * BAND
        assert payload <= PAYLOAD_BYTES + jobs_per_pair * 5000 * BAND
        # offsets into a launch's payload stay inside 32 bits
        assert payload < 2**31


@pytest.fixture(scope="module")
def operon_jobs():
    """The planner's jobs at band 128 on chip_smoke's operon kernel pairs,
    cut to a few: one template of 4,400 bp, reads with substitutions, 1-6
    and 40-60 bp deletions, both strands."""
    pairs = chip_smoke.make_pairs(np.random.default_rng(chip_smoke.OPERON_KERNEL_SEED), 1, 4,
                                  chip_smoke.OPERON_TEMPLATE_LEN)
    jobs = chip_smoke.plan(pairs, BAND)
    assert len(jobs) >= 3
    q, t, lo, tl = jobs_to_tensors(jobs, "cpu")
    assert q.shape[1] >= 4000 and q.shape[1] + t.shape[1] >= 8000
    return jobs, (q, t, lo, tl)


@pytest.fixture(scope="module")
def operon_plain(operon_jobs):
    _, x = operon_jobs
    return sw_forward_reference(*x, BAND), sw_forward_reference(*x, BAND, emit_payload=True)


def test_kernel1_plain_at_operon_shapes_equals_jax_forwards(operon_jobs, operon_plain):
    _, (q, t, lo, tl) = operon_jobs
    nm = operon_plain[0].numpy()
    payload, score, ri, bj = (a.numpy() for a in operon_plain[1])
    jq, jt, jlo, jtl = (jnp.asarray(a.numpy()) for a in (q, t, lo, tl))
    xla = align_jax.sw_forward_meta(jq, jt, jlo, jtl, band=BAND, smooth=False)
    for k, key in enumerate(("score", "q_end", "t_end", "nm")):
        np.testing.assert_array_equal(nm[:, k], np.asarray(xla[key]), err_msg=key)
    assert (nm[:, 0] > 0).all()
    fwd = jax.jit(align_jax._forward_payload, static_argnames=("band",))
    x_pay, x_score, x_ri, x_bj = fwd(jq, jt, jlo, jtl, band=BAND)
    B, Lq = q.shape
    np.testing.assert_array_equal(payload.reshape(B, Lq * BAND), np.asarray(x_pay))
    for ours, theirs in ((score, x_score), (ri, x_ri), (bj, x_bj)):
        np.testing.assert_array_equal(ours, np.asarray(theirs))


def test_kernel2_plain_at_operon_shapes_equals_jax_walk(operon_jobs, operon_plain):
    """ops_max = Lq + Lt (about 9,000), far above maxrun, where the XLA RLE
    works (it needs ops_max >= maxrun: align_jax.py:556)."""
    jobs, (q, t, lo, tl) = operon_jobs
    payload, score, ri, bj = operon_plain[1]
    B = payload.shape[0]
    ops_max = q.shape[1] + t.shape[1]
    cigar, meta = walk_rle_reference(payload, lo, score, ri, bj, BAND, ops_max)
    walk = jax.jit(partial(align_jax.sw_traceback_from_payload, band=BAND, ops_max=ops_max,
                           maxrun=chip_smoke.MAXRUN))
    ref = walk(jnp.asarray(payload.numpy().reshape(B, -1)), jnp.asarray(lo.numpy()),
               jnp.asarray(score.numpy()), jnp.asarray(ri.numpy()), jnp.asarray(bj.numpy()))
    meta = meta.numpy()
    for k, key in enumerate(("n_runs", "q_start", "q_end", "t_start", "t_end", "nm")):
        np.testing.assert_array_equal(meta[:, k], np.asarray(ref[key]), err_msg=key)
    assert (meta[:, 0] <= chip_smoke.MAXRUN).all() and (meta[:, 2] - meta[:, 1] >= 3500).all()
    np.testing.assert_array_equal(cigar.numpy().view(np.uint32), np.asarray(ref["cigar"]))

    # and the route built from both plain versions equals the host DP, CIGARs
    # included
    clear_caches()
    host = run_jobs(jobs, band=BAND)
    port = sw_traceback_jobs(jobs, BAND, device="cpu")
    for h, p in zip(host, port):
        assert h is not None and p is not None
        assert h[:5] == p[:5] and h[6] == p[6]
        assert np.array_equal(np.asarray(h[5], np.uint32), np.asarray(p[5], np.uint32))
