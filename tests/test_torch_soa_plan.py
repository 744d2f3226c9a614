"""The port's flat planner (savont_tpu_torch.ops.align_batch._plan_soa_indexed)
against savont_tpu's on the same seed-pinned inputs, array by array, and the
port's packer from the flat plan to kernel 1's tensors (align_torch.
plan_tensors, gather_rows, length_chunks_lens) against the per-job packer.

Tolerance: 0.  Every array is an integer."""
import numpy as np
import pytest
import torch

from savont_tpu.ops import align_batch as ref_batch
from savont_tpu_torch.ops import align_batch as port_batch
from savont_tpu_torch.ops import align_torch
from savont_tpu_torch.parallel.mesh import _build_target_pool

from _torch_jobs import clear_caches, indexed_pairs, rand_seq

PLAN_FIELDS = ("owner_j", "uq_j", "st_j", "tid_j", "q_cat", "q_off_j", "q_lens_j",
               "t_cat", "t_off_j", "t_lens_j", "lo_flat", "lo_off_j", "qlens_all", "band")


def _both(queries, targets, job_uq, job_ti, band, **kw):
    clear_caches()
    want = ref_batch._plan_soa_indexed(queries, targets, job_uq, job_ti, band, **kw)
    got = port_batch._plan_soa_indexed(queries, targets, job_uq, job_ti, band, **kw)
    return want, got


@pytest.mark.parametrize("seed,band", [(3, 48), (4, 64), (5, 128)])
def test_plan_equals_reference_array_by_array(seed, band):
    want, got = _both(*indexed_pairs(seed), band)
    assert len(want) == len(got) == len(PLAN_FIELDS)
    for name, w, g in zip(PLAN_FIELDS, want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
    # the set holds both strands and a corridor jump above 2
    assert set(got[2].tolist()) == {-1, 1}
    assert max(int(np.diff(port_batch.plan_job(got, k).lo).max()) for k in range(len(got[0]))) > 2


def test_plan_min_anchors_and_default_band():
    queries, targets, job_uq, job_ti = indexed_pairs(6)
    want, got = _both(queries, targets, job_uq, job_ti, None, min_anchors=4)
    for name, w, g in zip(PLAN_FIELDS, want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def test_plan_empty_and_none_as_the_reference():
    rng = np.random.default_rng(9)
    unrelated = ([rand_seq(rng, 300)], [rand_seq(rng, 300)], np.zeros(1, np.int64), np.zeros(1, np.int64))
    assert _both(*unrelated, 48) == ("empty", "empty")
    short = ([b"ACGT"], [rand_seq(rng, 300)], np.zeros(1, np.int64), np.zeros(1, np.int64))
    assert _both(*short, 48) == ("empty", "empty")
    none = ([rand_seq(rng, 300)], [rand_seq(rng, 300)], np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert _both(*none, 48) == (None, None)
    long_t = ([rand_seq(rng, 300)], [rand_seq(rng, 1 << 14)], np.zeros(1, np.int64), np.zeros(1, np.int64))
    assert _both(*long_t, 48) == (None, None)
    long_q = ([rand_seq(rng, (1 << 14) + 15)], [rand_seq(rng, 300)], np.zeros(1, np.int64), np.zeros(1, np.int64))
    assert _both(*long_q, 48) == (None, None)


def test_plan_jobs_equal_the_per_pair_planner():
    """plan_job(plan, k) is the AlignJob the per-pair planner makes for the
    same pair, in the same order."""
    queries, targets, job_uq, job_ti = indexed_pairs(7)
    clear_caches()
    plan = port_batch._plan_soa_indexed(queries, targets, job_uq, job_ti, 48)
    pairs = [(queries[a], targets[b]) for a, b in zip(job_uq.tolist(), job_ti.tolist())]
    jobs, owner = port_batch._plan_pairs(pairs, 48)
    by_owner = sorted(range(len(jobs)), key=lambda i: owner[i])  # stable: strand order kept
    assert [owner[i] for i in by_owner] == plan[0].tolist()
    for k, i in enumerate(by_owner):
        a, b = port_batch.plan_job(plan, k), jobs[i]
        assert (a.target_id, a.fwd_qlen) == (int(job_ti[owner[i]]), b.fwd_qlen)
        assert a.strand == b.strand
        for x, y in ((a.qcodes, b.qcodes), (a.tcodes, b.tcodes), (a.lo, b.lo)):
            np.testing.assert_array_equal(x, y)


def test_plan_tensors_equal_jobs_to_tensors():
    queries, targets, job_uq, job_ti = indexed_pairs(8)
    clear_caches()
    plan = port_batch._plan_soa_indexed(queries, targets, job_uq, job_ti, 48)
    dp = align_torch.plan_to_device(plan, *_build_target_pool(targets), "cpu")
    n = len(plan[0])
    for sel in (np.arange(n), np.arange(n)[::-2].copy(), np.array([n // 2])):
        got = align_torch.plan_tensors(dp, torch.from_numpy(sel))
        want = align_torch.jobs_to_tensors([port_batch.plan_job(plan, int(k)) for k in sel], "cpu")
        Lt = want[1].shape[1]
        for name, g, w in zip(("q", "t", "lo", "tlens"), got, want):
            assert g.dtype == torch.int32 and g.is_contiguous(), name
            if name == "t":  # the pool is padded to its longest target
                assert bool((g[:, Lt:] == 6).all())
                g = g[:, :Lt]
            assert torch.equal(g, w), name


def test_gather_rows_reverse_fill_and_extend():
    pool = torch.arange(100, 120, dtype=torch.uint8)
    off = torch.tensor([0, 5, 12])
    lens = torch.tensor([3, 4, 0])
    rows = align_torch.gather_rows(pool, off, lens, 5, 9)
    assert rows.tolist() == [[100, 101, 102, 9, 9], [105, 106, 107, 108, 9], [9] * 5]
    rev = align_torch.gather_rows(pool, off, lens, 5, 9, reverse=torch.tensor([True, False, True]))
    assert rev.tolist() == [[102, 101, 100, 9, 9], [105, 106, 107, 108, 9], [9] * 5]
    ext = align_torch.gather_rows(pool, off, lens, 6, 0, first=1, extend=True)
    assert ext.tolist() == [[100, 100, 101, 102, 102, 102], [105, 105, 106, 107, 108, 108], [0] * 6]


def test_length_chunks_lens_cuts_and_keeps_groups(monkeypatch):
    rng = np.random.default_rng(2)
    lens = np.repeat(rng.integers(100, 200, 20), 2)  # pairs of equal length
    group = np.repeat(np.arange(20), 2)
    monkeypatch.setattr(align_torch, "PAIRS_PER_LAUNCH", 5)
    chunks = align_torch.length_chunks_lens(lens, 48, payload=False, group=group)
    assert sorted(np.concatenate(chunks).tolist()) == list(range(40))
    assert len(chunks) > 4
    for c in chunks:
        assert len(c) % 2 == 0 and len(c) <= 6
        assert np.array_equal(group[c][0::2], group[c][1::2])
        assert np.all(np.diff(lens[c]) >= 0)
    monkeypatch.setattr(align_torch, "PAIRS_PER_LAUNCH", 16384)
    monkeypatch.setattr(align_torch, "PAYLOAD_BYTES", 4 * 200 * 48)
    for c in align_torch.length_chunks_lens(lens, 48, payload=True):
        assert len(c) == 1 or len(c) * int(lens[c].max()) * 48 <= 4 * 200 * 48
    # the per-job chunker is the same rule
    jobs = [type("J", (), {"qcodes": np.zeros(int(n))})() for n in lens]
    assert align_torch.length_chunks(jobs, 48, True) == [
        c.tolist() for c in align_torch.length_chunks_lens(lens, 48, True)]
