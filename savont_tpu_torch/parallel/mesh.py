"""The all-device routes of stages 1, 4 and 7, on one device or over ranks.

Counterparts of the JAX package's parallel/mesh.py mesh_stage4_pileups and
mesh_stage7_tie_break (its SAVONT_STAGE4_BACKEND / SAVONT_STAGE7_BACKEND =
mesh configuration).  Both plan their pairs with the flat planner
(ops/align_batch._plan_soa_indexed), pack kernel 1's tensors from the flat
plan on the device (ops/align_torch.plan_tensors) and keep what follows the
alignment on the device too:

  stage 4  kernel 1 (payload mode) + kernel 2 + the count-matrix scatter
           (ops/pileup_torch), the counts accumulated across launches and
           fetched once at the end;
  stage 7  kernel 1 (NM mode), the per-(read, ASV) winner and tie-set
           closure, and the EM fixed point in float32 (ops/em.
           em_abundances_torch).

Neither route is one fetch from end to end: the host reads device values,
and so waits for the device, at these points.  Each launch of either route
waits for its padded query length (int(lens.max()) in stage 4's loop and in
ops/align_torch.plan_tensors) and for kernel 1's input check
(_check_forward_inputs: two any() over lo).  A stage-4 launch also waits in
ops/pileup_torch.sw_pileup_counts for the pair winners' count
(pair_winners), kernel 2's input check (walk_rle), the scatter's largest
run count (add_pileup_counts), the two torch.nonzero of the rows it counts
and of the overflow rows, and the overflow list (.tolist() below).  Stage 7
waits at the tie sets' segment counts (int(grp.max()), int(rd.max())), once
an EM iteration (ops/em.py), and at the fetch of (score, nm).

The reference packs (rows, slots) panels with empty slots, a shape its
static-shape compiler needs; here the jobs stay flat rows with an owner
index, and winners are segment reductions over the owners.  Its chunked and
packed step variants, its corridor smoothing with the host realign, and its
split of stage 4 by corridor jump exist for the TPU's link latency and its
kernel's limits; kernel 1 here runs raw corridors at any jump, so each route
has one path.

Under a process group (parallel/distributed.py: one rank a card, every rank
running the same host pipeline) each route runs its kernels on the rank's
share and one collective makes the result whole on every rank, as the
reference's shard_map over the mesh does:

  stage 4  a contiguous range of the flat plan's pairs a rank, balanced by
           payload cells (a pair's strand jobs stay together: its winner is
           picked among them); all_reduce(SUM) of the integer count
           buffers, and of the host counts of kernel-2 overflows.  Exact.
  stage 7  a contiguous range of whole pairs a rank, balanced by cells;
           all_gather of (score, nm) in plan order, then the tie sets and
           the EM on the whole arrays on every rank.  The reference psums
           the EM's numerators over the mesh at every iteration instead.
           Here the arrays are tiny, a collective an iteration would add a
           wait to each on top of the one it has (ops/em.py), and an EM run
           whole on every rank equals one rank's exactly.

When the flat planner declines an input (None: sizes outside its packed key
widths) a route hands the work to the per-job consumers, which launch the
same kernels on the same device, on every rank alike; ROUTE_STATS counts
that.

Stage 1's split-k-mer count (split_kmer_count) runs kernel 4 over the whole
batch and sorts and counts on the device; with group=True over the ranks
with the reference's all_to_all by key owner.  sharded_classify_nm gives
classify's (Q, R) NM matrices, the references split over the ranks.  No
default path takes either of these two, as in the reference.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..constants import EM_MAX_ITERATIONS
from ..device import resolve_device
from ..ops import traceback_torch
from ..ops.align import resolve_band
from ..ops.align_batch import _plan_soa_indexed, align_pairs_nm_values_indexed, plan_job
from ..ops.align_torch import (
    LAUNCHES, PartClock, events_ms, gather_rows, kernel_events, length_chunks_lens,
    plan_tensors, plan_to_device, sw_forward,
)
from ..ops.em import em_abundances_torch
from ..ops.encode import _RC_TABLE
from ..ops.host_dp import run_jobs_host
from ..ops.kmers_torch import BARE, flagged_on_device
from ..ops.pileup_torch import new_count_buffers, strip_sinks, sw_pileup_counts
from ..tracing import part, span
from . import distributed
from .distributed import all_gather_rows, all_reduce_, all_to_all_rows, my_share

log = logging.getLogger("savont")

EM_CONV = 0.01  # the fixed point stops below EM_CONV / assigned reads, as the host EM does

# per route: calls, calls that fell to the per-job consumers (the planner
# returned None), wall seconds inside, device milliseconds of its launches of
# kernels 1 and 2 (CUDA events around each launch, read after the route's
# last fetch; 0.0 on the CPU), plan jobs made by the flat planner and run by
# this rank, the launch cut (per launch of kernel 1 its jobs and padded
# query length; stage 4: the largest ops_max its kernel-2 launches took), and
# of the last call the EM iterations (stage 7) and the pairs whose CIGAR
# overflowed kernel 2 and were counted on the host (stage 4); em_max_abs_diff is the largest difference between the device EM's
# abundances and the host float64 EM's (em_cross_check)
ROUTE_STATS = {
    "stage4": {"calls": 0, "fallbacks": 0, "seconds": 0.0, "kernel_ms": 0.0, "planned": 0,
               "jobs": 0, "launch_jobs": [], "launch_lq": [], "ops_max": 0, "overflow": 0},
    "stage7": {"calls": 0, "fallbacks": 0, "seconds": 0.0, "kernel_ms": 0.0, "planned": 0,
               "jobs": 0, "launch_jobs": [], "launch_lq": [], "em_iters": 0,
               "em_max_abs_diff": 0.0},
}


def reset_route_stats() -> None:
    for d in ROUTE_STATS.values():
        for k in d:
            d[k] = type(d[k])()


def _ext_codes(b: bytes) -> np.ndarray:
    """ACGT (either case) -> 0..3; every other byte keeps its value.  In the
    DP these behave as ascii_to_align_codes' codes do (only codes < 4 can
    match), while equal codes mean equal bases, which the pileup's is_ref
    column needs."""
    return _EXT_LUT[0, np.frombuffer(bytes(b), dtype=np.uint8)]


def _ext_luts() -> np.ndarray:
    """(2, 257) int32: row 0 maps a byte to its _ext_codes code, row 1 to the
    code of its complement (encode.revcomp_bytes' table); index 256, the
    padding of a gathered row, maps to the query padding code 5."""
    fwd = np.arange(257, dtype=np.int32)
    for ch, c in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
        fwd[ch] = c
    rc = fwd[np.append(np.frombuffer(_RC_TABLE, dtype=np.uint8), 256)]
    fwd[256] = rc[256] = 5
    return np.stack([fwd, rc])


_EXT_LUT = _ext_luts()


def _build_target_pool(tgt_bytes: list[bytes], ext: bool = False):
    """(t_pool (T, Lt) int32 padded with 6, tlens_pool (T,) int32) from the
    unique target bytes: the pool the routes gather each job's target from
    on the device.  Codes are ascii_to_align_codes', or with `ext` the
    raw-byte codes of _ext_codes."""
    from ..ops.align import ascii_to_align_codes

    t_list = tgt_bytes or [b"A"]
    Lt = max(len(tb) for tb in t_list)
    t_pool = np.full((len(t_list), Lt), 6, dtype=np.int32)
    for i, tb in enumerate(t_list):
        t_pool[i, : len(tb)] = _ext_codes(tb) if ext else ascii_to_align_codes(tb)
    tlens_pool = np.fromiter((len(tb) for tb in t_list), np.int32, len(t_list))
    return t_pool, tlens_pool


# ── stage 7: NM tie-break + EM ──────────────────────────────────────────────


def stage7_tie_sets(score, nm, row_read, row_asv, n_asvs: int):
    """Tie-set closure over flat job rows (the reference's
    _stage7_align_local after its forward): a row is valid when its score
    is positive; the winner of a (read, ASV) is its highest score, the
    earliest row on ties; a read's tie set is its winners at its least NM.
    score / nm int32 and row_read / row_asv int64 tensors of one length, in
    plan order.  Returns in_tie (bool)."""
    n = score.shape[0]
    dev = score.device
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    valid = score > 0
    key = score.long() * n - torch.arange(n, device=dev)
    _, grp = torch.unique(row_read * n_asvs + row_asv, return_inverse=True)
    lowest = torch.iinfo(torch.int64).min
    best = torch.full((int(grp.max()) + 1,), lowest, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, grp, torch.where(valid, key, lowest), "amax", include_self=True)
    winner = valid & (key == best[grp])
    big = 1 << 20
    _, rd = torch.unique(row_read, return_inverse=True)
    nm_eff = torch.where(winner, nm.long(), big)
    best_nm = torch.full((int(rd.max()) + 1,), big, dtype=torch.int64, device=dev)
    best_nm.scatter_reduce_(0, rd, nm_eff, "amin", include_self=True)
    return winner & (nm_eff == best_nm[rd])


def stage7_em(in_tie, row_read, row_asv, n_asvs: int, em_iters: int, conv: float = EM_CONV,
              stats: dict | None = None):
    """EM fixed point over the tie sets (the reference's _stage7_em_local):
    every assigned read weighs 1, responsibilities are proportional to the
    abundances inside its tie set, uniform start, stop at em_iters or when
    the largest change falls below conv / assigned reads.  Returns (abund
    (n_asvs,) float32 on the rows' device, assigned read count)."""
    rd_all = row_read[in_tie]
    if rd_all.numel() == 0:
        return torch.full((n_asvs,), 1.0 / n_asvs, dtype=torch.float32, device=in_tie.device), 0
    reads, rd = torch.unique(rd_all, return_inverse=True)
    count = int(reads.numel())
    abund = em_abundances_torch(
        rd, row_asv[in_tie], torch.ones(count, dtype=torch.float32, device=in_tie.device),
        n_asvs, float(count), conv / count, em_iters, stats,
    )
    return abund, count


def _winners(n_pairs: int, owner: np.ndarray, score: np.ndarray) -> np.ndarray:
    """Per input pair the plan index of its best job (highest score, first
    plan position on ties: align_pairs_nm's rule), -1 where no job
    aligned."""
    out = np.full(n_pairs, -1, dtype=np.int64)
    ok = np.flatnonzero(score > 0)
    if len(ok):
        sel = ok[np.lexsort((ok, -score[ok].astype(np.int64), owner[ok]))]
        ow = owner[sel]
        first = sel[np.concatenate(([True], ow[1:] != ow[:-1]))]
        out[owner[first]] = first
    return out


def em_cross_check(host_abund: np.ndarray, device_abund: np.ndarray) -> float:
    """max |host float64 EM - device float32 EM| over the abundances, kept in
    ROUTE_STATS for whoever reads the route's counters."""
    delta = float(np.abs(np.asarray(host_abund, dtype=np.float64)
                         - np.asarray(device_abund, dtype=np.float64)).max())
    ROUTE_STATS["stage7"]["em_max_abs_diff"] = delta
    return delta


def mesh_stage7_tie_break(
    read_seqs: list[bytes],
    asv_seqs: list[bytes],
    qi: np.ndarray,
    ca: np.ndarray,
    n_asvs: int,
    band: int | None = None,
    device="cuda",
    em_iters: int | None = None,
):
    """The device route of stage 7 over the candidate pairs (read_seqs[qi[k]],
    asv_seqs[ca[k]]), the indexed form align_pairs_nm_values_indexed takes:
    plan them with the flat planner, run every job through kernel 1 (NM
    mode) on `device`, close the tie sets and run the EM fixed point there.

    Returns (nm_vals, device_abund, assigned_count):
      nm_vals       (len(qi),) int64, the NM of each pair's winning job, -1
        where none aligned: align_pairs_nm_values_indexed's array.
      device_abund  (n_asvs,) float32 numpy, the device EM's abundances.
        They reach no output: the emitted depths come from the host float64
        EM, and the caller only logs the difference (em_cross_check).
    """
    stats = ROUTE_STATS["stage7"]
    stats["calls"] += 1
    with span(None, stats, "seconds"):
        with kernel_events() as events:
            out = _stage7_tie_break(read_seqs, asv_seqs, qi, ca, n_asvs, band, device, em_iters,
                                    stats)
        stats["kernel_ms"] += events_ms(events)  # after the route's fetches: no wait
    return out


def _stage7_tie_break(read_seqs, asv_seqs, qi, ca, n_asvs, band, device, em_iters, stats):
    band = resolve_band(band)
    if em_iters is None:
        em_iters = EM_MAX_ITERATIONS
    dev = resolve_device(device)
    qi = np.asarray(qi, dtype=np.int64)
    ca = np.asarray(ca, dtype=np.int64)
    with part("plan"):
        plan = _plan_soa_indexed(read_seqs, asv_seqs, qi, ca, band) if len(qi) else "empty"

    nm_vals = None
    if plan is None:
        # per-job consumer: the same kernel on the same device.  It gives one
        # winner per pair, so every aligned pair is a row of equal score
        stats["fallbacks"] += 1
        log.warning("stage-7 device route: the flat planner declined %d pairs; "
                    "taking the per-job consumer on %s", len(qi), dev)
        nm_vals = align_pairs_nm_values_indexed(read_seqs, asv_seqs, qi, ca, band, device=dev)
        owner_j = np.flatnonzero(nm_vals >= 0)
        nm = torch.from_numpy(nm_vals[owner_j].astype(np.int32)).to(dev)
        score = torch.ones_like(nm)
        stats["jobs"] += len(owner_j)  # on every rank: the fallback is not shared
    elif plan == "empty":
        owner_j = np.zeros(0, dtype=np.int64)
        score = nm = torch.zeros(0, dtype=torch.int32, device=dev)
    else:
        owner_j, q_lens_j, band = plan[0], plan[6], plan[13]
        with part("upload"):
            dp = plan_to_device(plan, *_build_target_pool(asv_seqs), dev)
        with part("launch"):
            # this rank's jobs: a contiguous range of whole pairs, balanced
            # by cells (all of them without a process group)
            lo, hi, sizes = my_share(q_lens_j * band, group=owner_j)
            stats["planned"] += len(owner_j)
            out = torch.empty((hi - lo, 4), dtype=torch.int32, device=dev)
            for sel in length_chunks_lens(q_lens_j[lo:hi], band, payload=False):
                sel_t = torch.from_numpy(sel).to(dev)
                stats["launch_jobs"].append(len(sel))
                stats["launch_lq"].append(int(q_lens_j[lo + sel].max()))
                out[sel_t] = sw_forward(*plan_tensors(dp, sel_t + lo), band)
            # every rank's (score, nm) in plan order
            out = all_gather_rows(out[:, [0, 3]].contiguous(), sizes)
            score, nm = out[:, 0].contiguous(), out[:, 1].contiguous()
        stats["jobs"] += hi - lo

    with part("upload"):
        row_read = torch.from_numpy(qi[owner_j]).to(dev)
        row_asv = torch.from_numpy(ca[owner_j]).to(dev)
    with part("em"):
        in_tie = stage7_tie_sets(score, nm, row_read, row_asv, n_asvs)
        em_stats: dict = {}
        abund, count = stage7_em(in_tie, row_read, row_asv, n_asvs, em_iters, stats=em_stats)
    stats["em_iters"] = em_stats.get("iters", 0)

    with part("fetch"):
        if nm_vals is None:
            fetched = torch.stack([score, nm]).cpu().numpy()  # the result's fetch
            win = _winners(len(qi), owner_j, fetched[0])
            nm_vals = np.where(win >= 0, fetched[1][win], -1).astype(np.int64)
        abund = abund.cpu().numpy()
    return nm_vals, abund, count


# ── stage 4: pileup count matrices ──────────────────────────────────────────


def _count_on_host(plan, k: int, band: int, payload, consensuses, roff, nq: int, counts) -> None:
    """Count plan job k, whose CIGAR overflowed kernel 2's run rows, through
    the host oracle's alignment and pipeline/pileup.read_pileup_indices."""
    from ..ops.encode import revcomp_bytes
    from ..pipeline.pileup import read_pileup_indices

    (r,) = run_jobs_host([plan_job(plan, k)], band)
    if r is None:
        return
    _score, q0, _q1, t0, _t1, cigar, _nm = r
    pi, ci = int(plan[0][k]), int(plan[3][k])
    seq, qual, hp = payload[pi]
    if int(plan[2][k]) == -1:
        seq, qual, hp = revcomp_bytes(seq), qual[::-1], (hp[::-1] if hp is not None else None)
    bq_i, del_i, ins_i, hp_i = read_pileup_indices(
        consensuses[ci].sequence, seq, qual, hp if "hph" in counts else None, cigar, t0, q0)
    o = int(roff[ci])
    np.add.at(counts["bq"], o * nq * 2 + bq_i, 1)
    np.add.at(counts["dels"], o + del_i, 1)
    np.add.at(counts["ins"], o * nq + ins_i, 1)
    if hp_i is not None:
        np.add.at(counts["hph"], o * 64 + hp_i, 1)


def mesh_stage4_pileups(twin_reads, consensuses, args):
    """The device route of stage 4's pileup construction, on args.device.

    Mirrors pipeline/pileup.host_consensus_pileups exactly: the same payload
    (homopolymer-compressed per read under use_hpc), the same winner rule
    (highest score, earliest plan job), the same count-matrix semantics.
    The alignment, the traceback walk and the scatter run on the device in
    launches cut by payload bytes, with the counts accumulated there and
    fetched once; each launch still waits for the device where the module
    docstring says.  Returns the PileupMatrix list and sets every consensus'
    hp_lengths, as the host route does."""
    stats = ROUTE_STATS["stage4"]
    stats["calls"] += 1
    stats["overflow"] = 0
    with span(None, stats, "seconds"):
        with kernel_events() as events:
            pms = _stage4_pileups(twin_reads, consensuses, args, stats)
        stats["kernel_ms"] += events_ms(events)  # after the route's last fetch: no wait
    return pms


def _stage4_pileups(twin_reads, consensuses, args, stats):
    from ..pipeline.pileup import (
        NQ, PileupMatrix, _median_from_hist, _pileup_payload, host_consensus_pileups, qlevel,
    )

    band = resolve_band(None)
    dev = resolve_device(args.device)
    use_hp = bool(args.use_hpc)

    with part("plan"):  # the pairs' payload, then the flat plan
        owners, payload = _pileup_payload(twin_reads, consensuses, args)
        tgt_pool_bytes = [cons.sequence.tobytes() for cons in consensuses]
        plan = _plan_soa_indexed(
            [p[0] for p in payload], tgt_pool_bytes,
            np.arange(len(payload), dtype=np.int64), np.asarray(owners, dtype=np.int64), band,
        ) if payload else "empty"
    L_flat = np.fromiter((len(c.sequence) for c in consensuses), np.int64, len(consensuses))
    roff = np.zeros(len(consensuses) + 1, dtype=np.int64)
    np.cumsum(L_flat, out=roff[1:])
    total_L = max(int(roff[-1]), 1)
    if plan is None:
        # per-job consumer: the same kernels on the same device
        stats["fallbacks"] += 1
        log.warning("stage-4 device route: the flat planner declined %d pairs; "
                    "taking the per-job consumer on %s", len(payload), dev)
        return host_consensus_pileups(twin_reads, consensuses, args)

    # host-side totals, in the device buffers' layout
    counts = {k: np.zeros(v.numel(), dtype=np.int64)
              for k, v in strip_sinks(new_count_buffers(total_L, NQ, use_hp, "cpu")).items()}

    if plan != "empty":
        owner_j, st_j, tid_j, q_lens_j, band = plan[0], plan[2], plan[3], plan[6], plan[13]
        # this rank's jobs: a contiguous range of whole pairs (a pair's
        # winner is picked across its strand jobs in one launch), balanced
        # by payload cells; all of them without a process group
        lo_j, hi_j, _ = my_share(q_lens_j * band, group=owner_j)
        stats["planned"] += len(owner_j)
        stats["jobs"] += hi_j - lo_j
        with part("upload"):
            dp = plan_to_device(plan, *_build_target_pool(tgt_pool_bytes, ext=True), dev)

            # per-pair pools: the read's bytes, quality levels and clamped
            # homopolymer run lengths, each uploaded once; a job's oriented rows
            # are gathered from them on the device (backward for strand -1)
            def up(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

            p_len = np.fromiter((len(p[0]) for p in payload), np.int64, len(payload))
            p_off = np.zeros(len(payload) + 1, dtype=np.int64)
            np.cumsum(p_len, out=p_off[1:])
            seq_cat = up(np.frombuffer(bytearray(b"".join(p[0] for p in payload)), dtype=np.uint8),
                         np.uint8)
            lvl_cat = up(qlevel(np.concatenate([p[1] for p in payload])), np.uint8)
            hp_cat = (up(np.minimum(np.concatenate([p[2] for p in payload]), 63), np.uint8)
                      if use_hp else None)
            lut = up(_EXT_LUT, np.int32)
            src_off = up(p_off[owner_j], np.int64)
            rev = up(st_j == -1, bool)
            off_j = up(roff[tid_j], np.int32)
            pair_j = up(owner_j, np.int64)

            acc = new_count_buffers(total_L, NQ, use_hp, dev)
        with part("launch"):
            Lt = dp["t_pool"].shape[1]
            for sel in length_chunks_lens(q_lens_j[lo_j:hi_j], band, payload=True,
                                          group=owner_j[lo_j:hi_j]):
                sel = sel + lo_j
                sel_t = torch.from_numpy(sel).to(dev)
                lens = dp["q_lens"][sel_t]
                Lq = int(lens.max())
                stats["launch_jobs"].append(len(sel))
                stats["launch_lq"].append(Lq)
                so, rv = src_off[sel_t], rev[sel_t]
                q = lut[rv.long()[:, None], gather_rows(seq_cat, so, lens, Lq, 256, reverse=rv).long()]
                lvl = gather_rows(lvl_cat, so, lens, Lq, 0, reverse=rv)
                hp = gather_rows(hp_cat, so, lens, Lq, 0, reverse=rv) if use_hp else lvl
                q, t, lo, tl = plan_tensors(dp, sel_t, q=q.contiguous())
                stats["ops_max"] = max(stats["ops_max"], Lq + Lt)
                out = sw_pileup_counts(
                    q, t, lo, tl, lvl, hp, off_j[sel_t], pair_j[sel_t],
                    total_L, NQ, band, Lq + Lt, use_hp, acc=acc, maxrun=traceback_torch.MAXRUN,
                )
                # CIGARs longer than kernel 2's run rows: counted on the host
                for row in out["overflow"].tolist():
                    _count_on_host(plan, int(sel[row]), band, payload, consensuses, roff, NQ, counts)
                    stats["overflow"] += 1
            LAUNCHES["walk_overflow"] += stats["overflow"]
            acc = strip_sinks(acc)
            if distributed.active():
                # every rank's counts, device buffers and host overflow counts
                # alike: integer sums, exact in any order
                for v in acc.values():
                    all_reduce_(v, "sum")
                host = torch.from_numpy(np.concatenate(list(counts.values())))
                all_reduce_(host, "sum")
                ends = np.cumsum([len(v) for v in counts.values()])
                counts = dict(zip(counts, np.split(host.numpy(), ends[:-1])))
        with part("fetch"):
            for k, v in acc.items():  # the counts' one fetch
                counts[k] += v.cpu().numpy()

    pms = []
    for ci, cons in enumerate(consensuses):
        L = len(cons.sequence)
        o = int(roff[ci])
        pms.append(
            PileupMatrix(
                ref=cons.sequence.copy(),
                bq=counts["bq"][o * NQ * 2 : (o + L) * NQ * 2].reshape(L, NQ, 2),
                dels=counts["dels"][o : o + L],
                ins_q=counts["ins"][o * NQ : (o + L) * NQ].reshape(L, NQ),
                hp_hist=counts["hph"][o * 64 : (o + L) * 64].reshape(L, 64) if use_hp else None,
            )
        )
    # median homopolymer length per position -> the consensus' hp_lengths
    for cons, pm in zip(consensuses, pms):
        if pm.hp_hist is not None:
            cons.hp_lengths = _median_from_hist(pm.hp_hist)
        else:
            cons.hp_lengths = np.ones(len(cons.sequence), dtype=np.uint8)
    return pms


# ── stage-1 split-k-mer count ─────────────────────────────────────────────


def count_flagged(flagged: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What ops.kmers.count_flagged_kmers computes, on flagged's device:
    the bare k-mers (bit 63 cleared) ascending, int64, and counts (n, 2)
    int32, column 1 the occurrences flagged forward-canonical.  One sort of
    (bare << 1) | flag (a bare k-mer has at most 62 bits; the flagged value
    sorted as signed would put the flagged keys first), the run lengths,
    and a fold of the two strands of each k-mer into one row."""
    packed = torch.sort(((flagged & BARE) << 1) | (flagged < 0).long()).values
    runs, n = torch.unique_consecutive(packed, return_counts=True)
    kmers, row = torch.unique_consecutive(runs >> 1, return_inverse=True)
    counts = torch.zeros((kmers.shape[0], 2), dtype=torch.int32, device=flagged.device)
    counts[row, runs & 1] = n.int()
    return kmers, counts


def _to_owners(flagged: torch.Tensor) -> torch.Tensor:
    """Send each flagged key to the rank that owns it, the low 32 bits of
    its bare k-mer modulo the world (the reference's klo % n_dev), with one
    all_to_all_rows; returns the keys this rank owns."""
    owner = (flagged & 0xFFFFFFFF) % distributed.world()
    order = torch.argsort(owner, stable=True)
    send = torch.bincount(owner, minlength=distributed.world())
    return all_to_all_rows(flagged[order], send.tolist())[0]


def _gather_tables(kmers: torch.Tensor, counts: torch.Tensor):
    """The owners' disjoint tables, gathered on every rank and merged in key
    order."""
    n = torch.tensor([kmers.shape[0]], dtype=torch.int64, device=kmers.device)
    sizes = all_gather_rows(n, [1] * distributed.world()).tolist()
    kmers, counts = all_gather_rows(kmers, sizes), all_gather_rows(counts, sizes)
    order = torch.argsort(kmers)
    return kmers[order], counts[order]


def split_kmer_count(code_list, phred_list, k: int, min_bq: int, device,
                     stats: dict | None = None, group: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Stage 1's strand-split count of the flagged canonical split k-mers of
    every read, on `device`: (bare k-mers ascending, uint64; counts (n, 2)
    uint32 indexed by the strand flag), what ops.kmers.count_flagged_kmers
    returns for the reads' split_kmer_mid lists.

    The reads are uploaded once; kernel 4 extracts every position's key
    and validity, the valid keys are compacted on the device
    (flagged_on_device), sorted and counted there (count_flagged), and the
    table is fetched once.

    With `group`, the count runs over the process group's ranks, as the
    reference's sharded_split_kmer_count (savont_tpu/parallel/mesh.py:1333)
    runs over its mesh: each rank extracts a contiguous range of the reads
    (balanced by bases), sends every key to its owner with one all_to_all
    (_to_owners), counts what it owns, and the owners' disjoint tables are
    gathered and merged on every rank.  No default path takes it, as none
    takes the reference's.  With `stats`, the
    parts' seconds are added to upload_s, kernel4_s, compact_s,
    sort_count_s and fetch_s, and the sizes to positions, flagged (this
    rank's) and distinct."""
    dev = resolve_device(device)
    clock = PartClock(dev)
    if group:
        lo, hi, _ = my_share(np.fromiter((len(c) for c in code_list), np.int64, len(code_list)))
        code_list = code_list[lo:hi]
        phred_list = phred_list[lo:hi] if phred_list is not None else None
    batch, flagged, _ = flagged_on_device(code_list, phred_list, k, min_bq, dev, clock)
    kmers, counts = count_flagged(_to_owners(flagged) if group else flagged)
    if group:
        kmers, counts = _gather_tables(kmers, counts)
    clock.mark("sort_count_s")
    out = kmers.cpu().numpy().view(np.uint64), counts.cpu().numpy().view(np.uint32)
    clock.mark("fetch_s")
    if stats is not None:
        clock.add_to(stats)
        stats["positions"] += batch.n_pos
        stats["flagged"] += flagged.shape[0]
        stats["distinct"] += len(out[0])
    return out


# ── classify's (Q, R) NM matrices over ranks ────────────────────────────


def sharded_classify_nm(queries: list[bytes], refs: list[bytes], band: int = 128,
                        device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """The reference's sharded_classify_nm (savont_tpu/parallel/mesh.py:917):
    every query against every reference, the references split over the
    process group's ranks (contiguous; all of them without a group).  Each
    rank plans its (query, reference) pairs with the flat planner and runs
    every job through kernel 1 (NM mode) on raw corridors, as classify's
    route does (ops/align_batch.classify_nm_slabs); a pair's value is its
    best job's (highest score, the earliest job on ties).  The rank's
    columns are gathered along R.

    Returns (nm, score), (Q, R) int32 each: -1 / 0 where a pair did not
    align.  Held to align_pairs_nm, not to the reference's matrices, which
    come from smoothed corridors.  Only tests call it, as in the
    reference."""
    from ..ops.align_batch import classify_nm_launches, classify_nm_slabs

    dev = resolve_device(device)
    n_q = len(queries)
    r0, r1, sizes = my_share(np.ones(len(refs)))
    mine = r1 - r0
    # pair k is (query k // mine, reference r0 + k % mine)
    qi = np.repeat(np.arange(n_q, dtype=np.int64), mine)
    ti = np.tile(np.arange(r0, r1, dtype=np.int64), n_q)
    cols = np.zeros((mine * n_q, 2), dtype=np.int32)
    cols[:, 0] = -1
    for s, plan, dp in classify_nm_slabs(queries, refs, qi, ti, band, dev):
        out = torch.empty((len(plan[0]), 4), dtype=torch.int32, device=dev)
        for sel_t, tensors in classify_nm_launches(plan, dp, band, dev):
            out[sel_t] = sw_forward(*tensors, band)
        out = out.cpu().numpy()  # one fetch a slab
        win = _winners(len(qi) - s, plan[0], out[:, 0])
        ok = np.flatnonzero(win >= 0)
        cols[s + ok] = out[win[ok]][:, [3, 0]]
    # (mine, Q, 2) for this rank's references; every rank's, along R
    local = torch.from_numpy(cols.reshape(n_q, mine, 2).transpose(1, 0, 2).copy()).to(dev)
    full = all_gather_rows(local, sizes).cpu().numpy().transpose(1, 0, 2)
    return np.ascontiguousarray(full[:, :, 0]), np.ascontiguousarray(full[:, :, 1])
