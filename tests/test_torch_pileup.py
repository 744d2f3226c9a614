"""The device pileup counts (savont_tpu_torch.ops.pileup_torch) on the CPU,
where kernels 1 and 2 run as their plain versions: against savont_tpu's
align_jax.sw_pileup_counts on the same panels (one and two candidate slots
per pair, with and without the homopolymer histogram; queries of 260 bp and
more, one with a corridor jump above 2), and against the host's
read_pileup_indices over the host oracle's alignments.

Tolerance: 0.  Every count is an integer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from savont_tpu.ops import align_batch as ref_batch
from savont_tpu.ops import align_jax
from savont_tpu.ops.encode import revcomp_bytes
from savont_tpu_torch.ops import pileup_torch
from savont_tpu_torch.ops.align_batch import plan_job
from savont_tpu_torch.ops.host_dp import run_jobs_host
from savont_tpu_torch.pipeline.pileup import NQ, read_pileup_indices

from _torch_jobs import clear_caches, indexed_pairs, panel_rows, rand_seq, stage4_panels, substitute

BAND = 48


def _workload(seed: int, both_strands: bool, use_hp: bool):
    """(payload, owners, targets): every pair's read bytes, qualities (the
    16 binned values and beyond) and homopolymer run lengths.  With
    both_strands one target is s + revcomp(s), so its reads chain on both
    strands and their pairs hold two candidate jobs."""
    rng = np.random.default_rng(seed)
    queries, targets, job_uq, job_ti = indexed_pairs(seed, n_queries=8, length=300)
    reads = [queries[a] for a in job_uq.tolist()]
    owners = job_ti.tolist()
    if both_strands:
        s = rand_seq(rng, 180)
        targets = targets + [s + revcomp_bytes(s)]
        for _ in range(3):
            reads.append(bytes(substitute(rng, targets[-1], 0.03)))
            owners.append(len(targets) - 1)
    payload = []
    for r in reads:
        qual = (33 + 3 * rng.integers(0, 21, len(r))).astype(np.uint8)
        hp = rng.integers(1, 80, len(r)).astype(np.uint8) if use_hp else None
        payload.append((r, qual, hp))
    assert min(len(r) for r in reads) >= 230 and max(len(r) for r in reads) >= 260
    return payload, np.asarray(owners, np.int64), targets


def _plan(payload, owners, targets):
    clear_caches()
    plan = ref_batch._plan_soa_indexed(
        [p[0] for p in payload], targets, np.arange(len(payload), dtype=np.int64), owners, BAND)
    assert plan is not None and plan != "empty"
    return plan


def _host_counts(plan, payload, targets, roff, use_hp):
    """read_pileup_indices over the host oracle's winner of every pair."""
    total_L = int(roff[-1])
    want = {"bq": np.zeros(total_L * NQ * 2, np.int64), "dels": np.zeros(total_L, np.int64),
            "ins": np.zeros(total_L * NQ, np.int64), "hph": np.zeros(total_L * 64, np.int64)}
    res = run_jobs_host([plan_job(plan, k) for k in range(len(plan[0]))], BAND)
    best: dict[int, int] = {}
    for k, r in enumerate(res):
        pi = int(plan[0][k])
        if r is not None and (pi not in best or r[0] > res[best[pi]][0]):
            best[pi] = k
    for pi, k in best.items():
        _s, q0, _q1, t0, _t1, cigar, _nm = res[k]
        seq, qual, hp = payload[pi]
        if int(plan[2][k]) == -1:
            seq, qual, hp = revcomp_bytes(seq), qual[::-1], (hp[::-1] if hp is not None else None)
        ci = int(plan[3][k])
        ref = np.frombuffer(targets[ci], dtype=np.uint8)
        bq_i, del_i, ins_i, hp_i = read_pileup_indices(ref, seq, qual, hp, cigar, t0, q0)
        o = int(roff[ci])
        np.add.at(want["bq"], o * NQ * 2 + bq_i, 1)
        np.add.at(want["dels"], o + del_i, 1)
        np.add.at(want["ins"], o * NQ + ins_i, 1)
        if hp_i is not None:
            np.add.at(want["hph"], o * 64 + hp_i, 1)
    return want, len(best)


@pytest.mark.parametrize("use_hp", [False, True])
@pytest.mark.parametrize("both_strands", [False, True])
def test_pileup_counts_equal_jax_and_host(both_strands, use_hp):
    payload, owners, targets = _workload(21, both_strands, use_hp)
    plan = _plan(payload, owners, targets)
    roff = np.concatenate(([0], np.cumsum([len(t) for t in targets]))).astype(np.int64)
    total_L = int(roff[-1])
    pn = stage4_panels(plan, payload, roff, targets, use_hp)
    slots = pn["C"]
    assert slots == (2 if both_strands else 1)
    assert max(int(np.diff(plan_job(plan, k).lo).max()) for k in range(len(plan[0]))) > 2
    Lq, Lt = pn["q"].shape[1], pn["t_pool"].shape[1]
    ops_max = Lq + Lt

    # the JAX package: (pairs x slots) panel rows, empty slots included
    tid = np.clip(pn["slot_tid"], 0, None)
    ref = align_jax.sw_pileup_counts(
        jnp.asarray(pn["q"]), jnp.asarray(pn["t_pool"][tid]), jnp.asarray(pn["lo"]),
        jnp.asarray(pn["tlens_pool"][tid]), jnp.asarray(pn["lvl"]), jnp.asarray(pn["hp"]),
        jnp.asarray(pn["off"]), total_L, NQ, BAND, ops_max, slots=slots, use_hp=use_hp,
    )

    # the port: the occupied rows, flat, each with its pair id
    rows = panel_rows(pn, ("q", "lo", "lvl", "hp"))
    rf = pn["rows_flat"]
    out = pileup_torch.sw_pileup_counts(
        rows["q"], rows["t"], rows["lo"], rows["tlens"], rows["lvl"], rows["hp"],
        torch.from_numpy(pn["off"][rf]), torch.from_numpy(rf // slots),
        total_L, NQ, BAND, ops_max, use_hp,
    )
    assert out["overflow"].numel() == 0
    got = {k: v.numpy() for k, v in pileup_torch.strip_sinks(
        {k: out[k] for k in pileup_torch.COUNT_KEYS if k in out}).items()}
    for k in ("bq", "dels", "ins") + (("hph",) if use_hp else ()):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert int(out[k][-1]) >= 0  # the sink holds what the reference drops
    np.testing.assert_array_equal(out["score"].numpy(), np.asarray(ref["score"])[rf])
    assert ("hph" in out) == use_hp

    want, n_winners = _host_counts(plan, payload, targets, roff, use_hp)
    assert int(out["is_win"].sum()) == n_winners > 0
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} against the host")
    assert got["bq"].sum() > 200 * n_winners and got["dels"].sum() > 0 and got["ins"].sum() >= 0


def test_pair_winner_is_the_first_maximum():
    score = torch.tensor([5, 5, 0, 7, 9, 9, 9, 0, 3], dtype=torch.int32)
    pair = torch.tensor([4, 4, 6, 6, 9, 9, 9, 2, 1])
    win = pileup_torch.pair_winners(score, pair)
    assert win.tolist() == [True, False, False, True, True, False, False, False, True]


def test_overflow_rows_are_listed_not_counted():
    """With maxrun below a winner's run count the row is reported in
    `overflow` and left out of the counts; the others are counted."""
    payload, owners, targets = _workload(23, False, False)
    plan = _plan(payload, owners, targets)
    roff = np.concatenate(([0], np.cumsum([len(t) for t in targets]))).astype(np.int64)
    total_L = int(roff[-1])
    pn = stage4_panels(plan, payload, roff, targets, False)
    rows = panel_rows(pn, ("q", "lo", "lvl", "hp"))
    rf = pn["rows_flat"]
    args = (rows["q"], rows["t"], rows["lo"], rows["tlens"], rows["lvl"], rows["hp"],
            torch.from_numpy(pn["off"][rf]), torch.from_numpy(rf // pn["C"]),
            total_L, NQ, BAND, pn["q"].shape[1] + pn["t_pool"].shape[1], False)
    full = pileup_torch.sw_pileup_counts(*args)
    n_runs = full["meta"][:, 0]
    cut = int(n_runs[full["is_win"]].median())
    part = pileup_torch.sw_pileup_counts(*args, maxrun=cut)
    over = part["overflow"].tolist()
    assert over == torch.nonzero(full["is_win"] & (n_runs > cut))[:, 0].tolist() and over
    assert 0 < int(part["bq"][:-1].sum()) < int(full["bq"][:-1].sum())
    # adding the overflow rows' own counts gives the full counts again
    rest = pileup_torch.new_count_buffers(total_L, NQ, False, "cpu")
    sel = torch.tensor(over)
    sub = pileup_torch.sw_pileup_counts(
        *(a[sel].contiguous() if isinstance(a, torch.Tensor) else a for a in args), acc=rest)
    assert sub["overflow"].numel() == 0
    for k in ("bq", "dels", "ins"):
        assert torch.equal(part[k][:-1] + rest[k][:-1], full[k][:-1]), k
