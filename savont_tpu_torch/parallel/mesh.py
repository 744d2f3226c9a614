"""The all-device routes of stages 1, 4 and 7, on one device or over ranks.

Counterparts of the JAX package's parallel/mesh.py mesh_stage4_pileups and
mesh_stage7_tie_break (its SAVONT_STAGE4_BACKEND / SAVONT_STAGE7_BACKEND =
mesh configuration), and the only routes of stages 4 and 7.  Both plan
their pairs with the flat planner (ops/align_batch._plan_soa_indexed) and
pack kernel 1's tensors from the flat plan on the device
(ops/align_torch.plan_tensors):

  stage 4  kernel 1 (payload mode) + kernel 2 + the count-matrix scatter
           (ops/pileup_torch), the counts accumulated across launches and
           fetched once at the end;
  stage 7  kernel 1 (NM mode) and one fetch of (score, nm); each pair's
           winning job is picked on the host (_winners).  The tie sets and
           the EM run on the host (pipeline/stage7_em.py), whose float64 EM
           gives the emitted depths.

Neither route is one fetch from end to end: the host reads device values,
and so waits for the device, at these points.  Each launch of either route
waits for its padded query length (int(lens.max()) in stage 4's loop and in
ops/align_torch.plan_tensors) and for kernel 1's input check
(_check_forward_inputs: two any() over lo).  A stage-4 launch also waits in
ops/pileup_torch.sw_pileup_counts for the pair winners' count
(pair_winners), kernel 2's input check (walk_rle), the scatter's largest
run count (add_pileup_counts), the two torch.nonzero of the rows it counts
and of the overflow rows, and the overflow list (.tolist() below).  Stage 7
waits at nothing else but its one fetch of (score, nm).

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
           all_gather of (score, nm) in plan order, then the winners on the
           whole arrays on every rank.

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

from ..device import resolve_device
from ..ops import traceback_torch
from ..ops.align import resolve_band
from ..ops.align_batch import _plan_soa_indexed, align_pairs_nm_values_indexed, plan_job
from ..ops.align_torch import (
    LAUNCHES, gather_rows, length_chunks_lens, plan_tensors, plan_to_device, sw_forward,
)
from ..ops.encode import _RC_TABLE
from ..ops.host_dp import run_jobs_host
from ..ops.kmers_torch import BARE, flagged_on_device
from ..ops.pileup_torch import new_count_buffers, strip_sinks, sw_pileup_counts
from ..tracing import part, span
from . import distributed
from .distributed import all_gather_rows, all_reduce_, all_to_all_rows, my_share

log = logging.getLogger("savont")

# per route: calls, calls that fell to the per-job consumers (the planner
# returned None), wall seconds inside, plan jobs made by the flat planner and
# run by this rank, the launch cut (per launch of kernel 1 its jobs and
# padded query length; stage 4: the largest ops_max its kernel-2 launches
# took), and of the last stage-4 call the pairs whose CIGAR overflowed
# kernel 2 and were counted on the host
ROUTE_STATS = {
    "stage4": {"calls": 0, "fallbacks": 0, "seconds": 0.0, "planned": 0, "jobs": 0,
               "launch_jobs": [], "launch_lq": [], "ops_max": 0, "overflow": 0},
    "stage7": {"calls": 0, "fallbacks": 0, "seconds": 0.0, "planned": 0, "jobs": 0,
               "launch_jobs": [], "launch_lq": []},
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


# ── stage 7: NM tie-break ───────────────────────────────────────────────────


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


def stage7_nm_values(
    read_seqs: list[bytes],
    asv_seqs: list[bytes],
    qi: np.ndarray,
    ca: np.ndarray,
    band: int | None = None,
    device="cuda",
) -> np.ndarray:
    """The device route of stage 7 over the candidate pairs (read_seqs[qi[k]],
    asv_seqs[ca[k]]), the indexed form align_pairs_nm_values_indexed takes:
    plan them with the flat planner, run every job through kernel 1 (NM
    mode) on `device` and fetch (score, nm) once.

    Returns (len(qi),) int64, the NM of each pair's winning job (highest
    score, the earliest plan job on ties), -1 where none aligned:
    align_pairs_nm_values_indexed's array."""
    stats = ROUTE_STATS["stage7"]
    stats["calls"] += 1
    with span(None, stats, "seconds"):
        return _stage7_nm_values(read_seqs, asv_seqs, qi, ca, band, device, stats)


def _stage7_nm_values(read_seqs, asv_seqs, qi, ca, band, device, stats):
    band = resolve_band(band)
    dev = resolve_device(device)
    qi = np.asarray(qi, dtype=np.int64)
    ca = np.asarray(ca, dtype=np.int64)
    with part("plan"):
        plan = _plan_soa_indexed(read_seqs, asv_seqs, qi, ca, band) if len(qi) else "empty"
    if plan is None:
        # per-job consumer: the same kernel on the same device
        stats["fallbacks"] += 1
        log.warning("stage-7 device route: the flat planner declined %d pairs; "
                    "taking the per-job consumer on %s", len(qi), dev)
        nm_vals = align_pairs_nm_values_indexed(read_seqs, asv_seqs, qi, ca, band, device=dev)
        stats["jobs"] += int(np.count_nonzero(nm_vals >= 0))  # on every rank: not shared
        return nm_vals
    if plan == "empty":  # no pair, or no job: nothing aligned
        return np.full(len(qi), -1, dtype=np.int64)

    owner_j, q_lens_j, band = plan[0], plan[6], plan[13]
    with part("upload"):
        dp = plan_to_device(plan, *_build_target_pool(asv_seqs), dev)
    with part("launch"):
        # this rank's jobs: a contiguous range of whole pairs, balanced by
        # cells (all of them without a process group)
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
    stats["jobs"] += hi - lo
    with part("fetch"):
        score, nm = out.cpu().numpy().T  # the result's fetch
        win = _winners(len(qi), owner_j, score)
        return np.where(win >= 0, nm[win], -1).astype(np.int64)


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
    hp_lengths, as the per-job consumer does."""
    stats = ROUTE_STATS["stage4"]
    stats["calls"] += 1
    stats["overflow"] = 0
    with span(None, stats, "seconds"):
        return _stage4_pileups(twin_reads, consensuses, args, stats)


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
    takes the reference's.  With `stats`, the sizes are added to positions,
    flagged (this rank's) and distinct."""
    dev = resolve_device(device)
    if group:
        lo, hi, _ = my_share(np.fromiter((len(c) for c in code_list), np.int64, len(code_list)))
        code_list = code_list[lo:hi]
        phred_list = phred_list[lo:hi] if phred_list is not None else None
    batch, flagged, _ = flagged_on_device(code_list, phred_list, k, min_bq, dev)
    kmers, counts = count_flagged(_to_owners(flagged) if group else flagged)
    if group:
        kmers, counts = _gather_tables(kmers, counts)
    out = kmers.cpu().numpy().view(np.uint64), counts.cpu().numpy().view(np.uint32)
    if stats is not None:
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
