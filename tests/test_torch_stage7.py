"""The stage-7 device step of the port on the CPU.  Its route
(savont_tpu_torch.parallel.mesh.stage7_nm_values) against the host winners
(align_pairs_nm); the tie-set closure and EM fixed point it keeps beside the
route (ops.em: stage7_tie_sets, stage7_em, em_abundances_torch) against
savont_tpu's (_stage7_align_local / _stage7_em_local, run under jax.jit on a
one-device CPU mesh with kernel="scan", through sharded_stage7_align /
sharded_stage7_em) on the same panels, and against the host float64 EM.

Tolerances: integers (scores, NM, tie sets, counts) 0.  Abundances: 1e-6
absolute between the two float32 fixed points, which differ only in the
order of their sums, and 1e-4 absolute against the host float64 EM."""
import numpy as np
import pytest
import torch

from savont_tpu.ops import align_batch as ref_batch
from savont_tpu.ops.em import em_abundances, em_abundances_jax
from savont_tpu.parallel import mesh as ref_mesh
from savont_tpu_torch.ops import align_torch
from savont_tpu_torch.ops.em import em_abundances_torch, stage7_em, stage7_tie_sets
from savont_tpu_torch.parallel import mesh as port_mesh

from _torch_jobs import clear_caches, panel_rows, rand_seq, stage7_panels, substitute

BAND = 64
EM_ITERS = 500


def _workload(seed: int, n_reads: int = 12, n_asvs: int = 3, length: int = 300):
    """Reads of n_asvs close variants (substitutions only, so corridors
    advance by at most 1 per row and the reference's smoothing changes
    nothing), each a candidate of two ASVs; odd reads reverse-complemented;
    one read unrelated to everything."""
    from savont_tpu.ops.encode import revcomp_bytes

    rng = np.random.default_rng(seed)
    base = bytearray(rand_seq(rng, length))
    asvs = []
    for k in range(n_asvs):
        t = bytearray(base)
        for p in range(30 + 13 * k, length - 20, 90):
            t[p] = b"ACGT"[(b"ACGT".index(bytes([t[p]])) + 1 + k) % 4]
        asvs.append(bytes(t))
    pairs, pr, pa, reads = [], [], [], []
    for r in range(n_reads):
        read = bytes(substitute(rng, asvs[r % n_asvs], 0.02))
        if r == n_reads - 1:
            read = rand_seq(rng, length)
        if r % 2:
            read = revcomp_bytes(read)
        reads.append(read)
        for a in sorted({r % n_asvs, (r + 1) % n_asvs}):
            pairs.append((read, asvs[a]))
            pr.append(r)
            pa.append(a)
    return pairs, np.asarray(pr, np.int64), np.asarray(pa, np.int64), asvs, reads


def _ref_plan(pairs):
    qry, tgt = {}, {}
    uq = np.array([qry.setdefault(q, len(qry)) for q, _ in pairs], np.int64)
    ti = np.array([tgt.setdefault(t, len(tgt)) for _, t in pairs], np.int64)
    clear_caches()
    return ref_batch._plan_soa_indexed(list(qry), list(tgt), uq, ti, BAND), list(tgt)


@pytest.mark.parametrize("seed", [31, 32])
def test_tie_sets_and_em_equal_the_jax_closures(seed):
    pairs, pr, pa, asvs, _reads = _workload(seed)
    n_reads, n_asvs = int(pr.max()) + 1, len(asvs)
    plan, tgt = _ref_plan(pairs)
    pn = stage7_panels(plan, pr, pa, n_reads, tgt)

    mesh1 = ref_mesh.make_mesh(1)
    nm_r, score_r, tie_r = (np.asarray(a) for a in ref_mesh.sharded_stage7_align(mesh1, BAND, "scan")(
        pn["q"], pn["lo"], pn["slot_tid"], pn["slot_asv"], pn["t_pool"], pn["tlens_pool"]))
    abund_r, count_r = ref_mesh.sharded_stage7_em(mesh1, n_asvs, EM_ITERS, 0.01)(
        tie_r, pn["slot_asv"])

    # the port on the same (smoothed) rows, flat, in the panels' slot order
    rows = panel_rows(pn)
    rf, order = pn["rows_flat"], pn["order"]
    out = align_torch.sw_forward(rows["q"], rows["t"], rows["lo"], rows["tlens"], BAND)
    score, nm = out[:, 0].contiguous(), out[:, 3].contiguous()
    np.testing.assert_array_equal(score.numpy(), score_r.reshape(-1)[rf])
    np.testing.assert_array_equal(nm.numpy(), nm_r.reshape(-1)[rf])
    row_read = torch.from_numpy(pr[plan[0][order]])
    row_asv = torch.from_numpy(pa[plan[0][order]])
    in_tie = stage7_tie_sets(score, nm, row_read, row_asv, n_asvs)
    np.testing.assert_array_equal(in_tie.numpy(), tie_r.reshape(-1)[rf])
    assert not tie_r.reshape(-1)[np.setdiff1d(np.arange(tie_r.size), rf)].any()
    assert 0 < int(in_tie.sum()) < len(rf)

    stats = {}
    abund, count = stage7_em(in_tie, row_read, row_asv, n_asvs, EM_ITERS, stats=stats)
    assert count == int(count_r) == n_reads - 1  # the unrelated read is unassigned
    assert 1 <= stats["iters"] <= EM_ITERS
    np.testing.assert_allclose(abund.numpy(), np.asarray(abund_r), rtol=0, atol=1e-6)
    assert abs(float(abund.sum()) - 1.0) < 1e-5


def test_tie_set_rules_on_a_hand_made_case():
    """Invalid rows never win; a (read, ASV) keeps its highest score, the
    earliest row on ties; the tie set is the winners at the read's least NM;
    a read without a valid row has no tie set."""
    score = torch.tensor([10, 10, 12, 0, 8, 8, 0, 9], dtype=torch.int32)
    nm = torch.tensor([3, 1, 5, 0, 2, 2, 0, 7], dtype=torch.int32)
    read = torch.tensor([0, 0, 0, 0, 1, 1, 2, 3])
    asv = torch.tensor([0, 0, 1, 2, 0, 1, 0, 1])
    tie = stage7_tie_sets(score, nm, read, asv, 3)
    # read 0: ASV 0's winner is row 0 (first of the equal scores, NM 3), ASV
    # 1's row 2 (NM 5): the tie set is row 0 alone, although row 1 has NM 1
    assert tie.tolist() == [True, False, False, False, True, True, False, True]
    abund, count = stage7_em(tie, read, asv, 3, 100)
    assert count == 3 and abs(float(abund.sum()) - 1) < 1e-6
    empty = stage7_tie_sets(score[:0], nm[:0], read[:0], asv[:0], 3)
    assert empty.shape == (0,)
    abund0, count0 = stage7_em(empty, read[:0], asv[:0], 3, 100)
    assert count0 == 0 and abund0.tolist() == pytest.approx([1 / 3] * 3)


@pytest.mark.parametrize("seed", [33, 34])
def test_route_equals_host_winners(seed):
    """stage7_nm_values on raw corridors against the per-job consumer's
    winners: NM per pair, -1 where none aligned."""
    from savont_tpu_torch.ops.align_batch import align_pairs_nm

    pairs, pr, pa, asvs, reads = _workload(seed, n_reads=14)
    clear_caches()
    port_mesh.reset_route_stats()
    nm_vals = port_mesh.stage7_nm_values(reads, asvs, pr, pa, band=BAND, device="cpu")
    st = port_mesh.ROUTE_STATS["stage7"]
    assert (st["calls"], st["fallbacks"]) == (1, 0) and st["jobs"] >= len(pairs) - 2
    assert nm_vals.dtype == np.int64 and nm_vals.shape == (len(pairs),)
    host = align_pairs_nm(pairs, band=BAND, device="cpu")
    assert [-1 if m is None else m.nm for m in host] == nm_vals.tolist()
    assert int((nm_vals >= 0).sum()) >= len(pairs) - 2
    assert (nm_vals == -1).any()  # the unrelated read aligns to nothing


def test_em_abundances_torch_against_jax_and_host():
    rng = np.random.default_rng(35)
    n_items, n_groups = 6, 40
    groups = []
    for _ in range(n_groups):
        members = tuple(sorted(rng.choice(n_items, int(rng.integers(1, 4)), replace=False).tolist()))
        groups.append((members, float(rng.integers(1, 30))))
    from savont_tpu.ops.em import groups_to_rows

    gids, iids, w = groups_to_rows(groups)
    total = float(w.sum())
    conv = 0.01 / total
    want64 = em_abundances(gids, iids, w, n_items, total, conv, 1000)
    want32 = np.asarray(em_abundances_jax(gids, iids, w.astype(np.float32), n_items, total, conv, 1000))
    stats = {}
    got = em_abundances_torch(torch.from_numpy(gids), torch.from_numpy(iids),
                              torch.from_numpy(w.astype(np.float32)), n_items, total, conv, 1000,
                              stats).numpy()
    assert got.dtype == np.float32 and stats["iters"] >= 1
    np.testing.assert_allclose(got, want32, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.astype(np.float64), want64, rtol=0, atol=1e-4)


def test_route_falls_to_the_per_job_consumer_and_counts_it(monkeypatch):
    """When the flat planner declines, the route takes the per-job consumer
    on the same device, gives the same answer and counts the fallback."""
    _pairs, pr, pa, asvs, reads = _workload(36, n_reads=6)
    args = (reads, asvs, pr, pa)
    clear_caches()
    nm_vals = port_mesh.stage7_nm_values(*args, band=BAND, device="cpu")
    port_mesh.reset_route_stats()
    monkeypatch.setattr(port_mesh, "_plan_soa_indexed", lambda *a, **k: None)
    nm_vals2 = port_mesh.stage7_nm_values(*args, band=BAND, device="cpu")
    st = port_mesh.ROUTE_STATS["stage7"]
    assert (st["calls"], st["fallbacks"]) == (1, 1)
    assert st["jobs"] == int((nm_vals2 >= 0).sum())
    np.testing.assert_array_equal(nm_vals, nm_vals2)
