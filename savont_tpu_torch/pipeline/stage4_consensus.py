"""Stage 4: consensus generation + pileup-based Bayesian polishing.

Reference: alignment.rs:190-1153.  The spoa POA graph (C++ FFI) is replaced
by a batch-friendly seed + iterative pileup-vote consensus: pick the
90th-percentile-length read as template, batch-align the top-quality reads
to it with the banded kernel, and take the quality-weighted majority at each
column (including short insertions).  The reference's own Bayesian polish
(which only FLAGS positions; the base calls come from the consensus) then
runs unchanged on pileups of up to 250 reads.

All alignments across ALL clusters are batched into single banded-DP sweeps
(ops/align_batch), so each DP launch on the card carries thousands of pairs.
"""
from __future__ import annotations

import logging
from collections import Counter

import numpy as np

from ..config import ClusterArgs
from ..constants import MAX_SEQS_POA
from ..core import ConsensusSequence, TwinRead
from ..ops.align import Mapping
from ..ops.encode import (
    homopolymer_compress,
    homopolymer_compress_with_quality,
    revcomp_bytes,
)
from ..tracing import part

log = logging.getLogger("savont")


def _read_seq_and_qual(tr: TwinRead) -> tuple[bytes, np.ndarray]:
    """ASCII sequence + per-base expanded binned qualities
    (alignment.rs:231-258)."""
    return tr.seq_bytes(), tr.expanded_qual_ascii()


# per-level accuracy 1 - 10^(-3*level/10); same doubles as the elementwise
# power the per-read formula produced (levels are 0..15, table padded to 64)
_ACC_LUT = 1.0 - np.power(10.0, -(np.arange(64, dtype=np.float64) * 3.0) / 10.0)


def _avg_qual_batch(trs: list[TwinRead]) -> np.ndarray:
    """Mean per-BIN accuracy for many reads in one LUT gather + segmented
    sums (alignment.rs:239-245).  Reads without qualities -> 1.0.
    Per-read values are memoized on the TwinRead (they do not depend on
    the cluster), so repeated per-cluster calls only gather floats."""
    out = np.ones(len(trs), dtype=np.float64)
    miss = [
        i for i, tr in enumerate(trs)
        if getattr(tr, "_avg_qual_cache", None) is None
        and tr.qual_levels is not None and len(tr.qual_levels)
    ]
    if miss:
        lens = np.fromiter((len(trs[i].qual_levels) for i in miss), np.int64, len(miss))
        starts = np.zeros(len(miss), dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        flat = np.concatenate([trs[i].qual_levels for i in miss])
        acc = _ACC_LUT[flat]
        vals = np.add.reduceat(acc, starts) / lens
        for i, v in zip(miss, vals.tolist()):
            trs[i]._avg_qual_cache = v
    for i, tr in enumerate(trs):
        v = getattr(tr, "_avg_qual_cache", None)
        if v is not None:
            out[i] = v
    return out


def _avg_qual(tr: TwinRead) -> float:
    """Single-read wrapper over _avg_qual_batch (same values)."""
    return float(_avg_qual_batch([tr])[0])


# ── consensus via template + weighted column vote (spoa replacement) ─────────


def _vote_consensus(
    template: bytes,
    oriented: list[tuple[bytes, np.ndarray]],
    mappings: list[Mapping],
) -> bytes:
    """Quality-weighted majority vote against the template (one round)."""
    n = len(template)
    t_arr = np.frombuffer(template, dtype=np.uint8)
    base_w = np.zeros((n, 4), dtype=np.float64)
    del_w = np.zeros(n, dtype=np.float64)
    cov_w = np.zeros(n, dtype=np.float64)
    ins_votes: dict[int, Counter] = {}
    code = {65: 0, 67: 1, 71: 2, 84: 3}

    code_tab = np.full(256, -1, dtype=np.int8)
    for b, c in code.items():
        code_tab[b] = c

    # one batched CIGAR walk across ALL reads, then one weighted bincount
    # per matrix (per-read walks were the stage-4 consensus hotspot)
    if mappings:
        from .pileup import batched_cigar_walk

        slen = np.fromiter((len(s) for s, _ in oriented), np.int64, len(oriented))
        s_off = np.zeros(len(oriented) + 1, dtype=np.int64)
        np.cumsum(slen, out=s_off[1:])
        seq_cat = np.frombuffer(b"".join(s for s, _ in oriented), dtype=np.uint8)
        qual_cat = np.concatenate([q for _, q in oriented])
        q0s = [
            m.query_start if m.strand == 1 else len(oriented[i][0]) - m.query_end
            for i, m in enumerate(mappings)
        ]
        ops, tpos, qpos, base_read, run_read, run_lens, run_ops, run_start = (
            batched_cigar_walk([m.cigar for m in mappings],
                               [m.target_start for m in mappings], q0s)
        )

        is_m = ops == 0
        tm, qm, rd = tpos[is_m], qpos[is_m], base_read[is_m]
        # loud bounds check (the per-read walk raised IndexError on a
        # malformed CIGAR; the flat gather would silently read a
        # neighboring read's bases)
        if bool((qm >= slen[rd]).any()):
            raise IndexError("CIGAR M run exceeds oriented query length")
        qi = s_off[rd] + qm
        w = qual_cat[qi].astype(np.float64)
        c = code_tab[seq_cat[qi]]
        good = c >= 0
        is_d = ops == 2
        td, rdd = tpos[is_d], base_read[is_d]
        # empty-qual reads: slen-1 == -1 would gather the previous read's
        # last byte; pin to offset 0 (the old per-read code used a fixed
        # 63.0 — an empty oriented read cannot reach here with M/D ops)
        qd = s_off[rdd] + np.minimum(qpos[is_d], np.maximum(slen[rdd] - 1, 0))
        wd = qual_cat[qd].astype(np.float64)

        base_w.reshape(-1)[:] = np.bincount(
            tm[good] * 4 + c[good].astype(np.int64), weights=w[good], minlength=n * 4
        )
        del_w[:] = np.bincount(td, weights=wd, minlength=n)
        cov_w[:] = np.bincount(
            np.concatenate((tm, td)), weights=np.concatenate((w, wd)), minlength=n
        )

        # insertion runs (python loop over rare events)
        ins_r = np.flatnonzero(run_ops == 1)
        for x in ins_r:
            rs = int(run_start[x])
            tp, qp = int(tpos[rs]), int(qpos[rs])
            if tp - 1 >= 0:
                r = int(run_read[x])
                seg = seq_cat[s_off[r] + qp : s_off[r] + qp + int(run_lens[x])]
                ins_votes.setdefault(tp - 1, Counter())[seg.tobytes()] += float(
                    qual_cat[s_off[r] + qp]
                )

    return _vote_finish(t_arr, base_w, del_w, cov_w, ins_votes)


def _vote_finish(
    t_arr: np.ndarray,
    base_w: np.ndarray,
    del_w: np.ndarray,
    cov_w: np.ndarray,
    ins_votes: dict[int, Counter],
) -> bytes:
    """Column decisions + insertion splicing from accumulated vote weights
    (shared by the NumPy and native accumulation paths)."""
    n = len(t_arr)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    best_c = np.argmax(base_w, axis=1)
    best_v = base_w[np.arange(n), best_c]
    base_sum = base_w.sum(axis=1)
    drop = (cov_w > 0) & (del_w > base_sum)  # majority deletion: drop column
    use_vote = (cov_w > 0) & ~drop & (best_v > 0)
    out_arr = np.where(use_vote, bases[best_c], t_arr)

    accepted_ins = {}
    for i, iv in ins_votes.items():
        ins_seq, w = iv.most_common(1)[0]
        if w * 2 > cov_w[i] and cov_w[i] > 0:
            accepted_ins[i] = ins_seq
    if not accepted_ins:
        return out_arr[~drop].tobytes()
    out = bytearray()
    prev = 0
    for i in sorted(accepted_ins):
        seg = out_arr[prev : i + 1][~drop[prev : i + 1]]
        out.extend(seg.tobytes())
        out.extend(accepted_ins[i])
        prev = i + 1
    out.extend(out_arr[prev:][~drop[prev:]].tobytes())
    return bytes(out)


_CODE_TAB_I8 = np.full(256, -1, dtype=np.int8)
for _b, _c in ((65, 0), (67, 1), (71, 2), (84, 3)):
    _CODE_TAB_I8[_b] = _c


def _vote_consensus_batch(
    templates: list[bytes],
    oriented_list: list[list[tuple[bytes, np.ndarray]]],
    mappings_list: list[list[Mapping]],
    threads: int = 0,
) -> list[bytes]:
    """All clusters' vote accumulation in ONE native scatter call
    (native/pileup.cpp vote_accum_batch; int64 weight sums equal the NumPy
    float64 bincounts exactly since ASCII weights are integers).  Insertion
    runs are located with run-level segmented cumsums (no per-base walk) and
    voted in global run order — the same Counter insertion order as the
    per-cluster path.  Falls back to per-cluster _vote_consensus."""
    import ctypes

    from .pileup import _get_pileup_lib

    if not templates:
        return []
    lib = _get_pileup_lib()
    if lib is None or not hasattr(lib, "vote_accum_batch_ok"):
        _bind_vote(lib)
    if lib is None or not getattr(lib, "vote_accum_batch_ok", False):
        return [
            _vote_consensus(t, o, m)
            for t, o, m in zip(templates, oriented_list, mappings_list)
        ]

    n_cons = len(templates)
    tmpl_len = np.fromiter((len(t) for t in templates), np.int64, n_cons)
    tmpl_off = np.zeros(n_cons + 1, dtype=np.int64)
    np.cumsum(tmpl_len, out=tmpl_off[1:])
    total_L = int(tmpl_off[-1])

    seqs: list[bytes] = []
    quals: list[np.ndarray] = []
    cigars: list[np.ndarray] = []
    t0s: list[int] = []
    q0s: list[int] = []
    job_off = np.zeros(n_cons + 1, dtype=np.int64)
    for ci in range(n_cons):
        for (oseq, oqual), m in zip(oriented_list[ci], mappings_list[ci]):
            seqs.append(oseq)
            quals.append(oqual)
            cigars.append(np.asarray(m.cigar, dtype=np.uint32))
            t0s.append(m.target_start)
            q0s.append(
                m.query_start if m.strand == 1 else len(oseq) - m.query_end
            )
        job_off[ci + 1] = len(seqs)

    slen = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    s_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(slen, out=s_off[1:])
    seq_cat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    qual_cat = (
        np.ascontiguousarray(np.concatenate(quals), dtype=np.uint8)
        if quals
        else np.zeros(0, np.uint8)
    )
    n_runs = np.fromiter((len(c) for c in cigars), np.int64, len(cigars))
    cig_off = np.zeros(len(cigars) + 1, dtype=np.int64)
    np.cumsum(n_runs, out=cig_off[1:])
    cig_cat = (
        np.ascontiguousarray(np.concatenate(cigars), dtype=np.uint32)
        if cigars
        else np.zeros(0, np.uint32)
    )
    t0_a = np.asarray(t0s, dtype=np.int64)
    q0_a = np.asarray(q0s, dtype=np.int64)

    base_w = np.zeros(total_L * 4, dtype=np.int64)
    del_w = np.zeros(total_L, dtype=np.int64)
    cov_w = np.zeros(total_L, dtype=np.int64)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    lib.vote_accum_batch(
        ptr(seq_cat, ctypes.c_uint8), ptr(s_off, ctypes.c_int64),
        ptr(qual_cat, ctypes.c_uint8),
        ptr(cig_cat, ctypes.c_uint32), ptr(cig_off, ctypes.c_int64),
        ptr(t0_a, ctypes.c_int64), ptr(q0_a, ctypes.c_int64),
        ptr(job_off, ctypes.c_int64), ctypes.c_int64(n_cons),
        ptr(tmpl_off, ctypes.c_int64),
        ptr(_CODE_TAB_I8, ctypes.c_int8),
        ptr(base_w, ctypes.c_int64), ptr(del_w, ctypes.c_int64),
        ptr(cov_w, ctypes.c_int64), ctypes.c_int32(threads),
    )

    # insertion events from run-level segmented cumsums (rare; Counter order
    # == global run order == the per-cluster loop's order)
    ins_by_cons: dict[int, dict[int, Counter]] = {}
    if len(cig_cat):
        lens = (cig_cat >> np.uint32(4)).astype(np.int64)
        ops = (cig_cat & np.uint32(0xF)).astype(np.int64)
        t_adv = lens * (ops != 1)
        q_adv = lens * (ops != 2)
        ct = np.cumsum(t_adv)
        cq = np.cumsum(q_adv)
        et = ct - t_adv
        eq = cq - q_adv
        run_job = np.repeat(np.arange(len(cigars)), n_runs)
        first = cig_off[:-1]
        et0 = et[np.minimum(first, max(len(et) - 1, 0))]
        eq0 = eq[np.minimum(first, max(len(eq) - 1, 0))]
        tpos_run = t0_a[run_job] + et - et0[run_job]
        qpos_run = q0_a[run_job] + eq - eq0[run_job]
        ins_idx = np.flatnonzero((ops == 1) & (tpos_run > 0))
        if len(ins_idx):
            job_cons = np.repeat(np.arange(n_cons), np.diff(job_off))
            for x in ins_idx.tolist():
                j = int(run_job[x])
                ci = int(job_cons[j])
                tp, qp, ln = int(tpos_run[x]), int(qpos_run[x]), int(lens[x])
                seg = seq_cat[s_off[j] + qp : s_off[j] + qp + ln]
                w = float(qual_cat[s_off[j] + qp]) if s_off[j] + qp < s_off[j + 1] else 0.0
                ins_by_cons.setdefault(ci, {}).setdefault(tp - 1, Counter())[
                    seg.tobytes()
                ] += w

    out: list[bytes] = []
    for ci in range(n_cons):
        o = int(tmpl_off[ci])
        L = int(tmpl_len[ci])
        out.append(
            _vote_finish(
                np.frombuffer(templates[ci], dtype=np.uint8),
                base_w[o * 4 : (o + L) * 4].reshape(L, 4),
                del_w[o : o + L],
                cov_w[o : o + L],
                ins_by_cons.get(ci, {}),
            )
        )
    return out


def _bind_vote(lib) -> None:
    """Declare vote_accum_batch argtypes once per process."""
    import ctypes

    if lib is None:
        return
    try:
        fn = lib.vote_accum_batch
    except AttributeError:
        lib.vote_accum_batch_ok = False
        return
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    fn.restype = None
    fn.argtypes = [
        u8p, i64p, u8p, u32p, i64p, i64p, i64p, i64p,
        ctypes.c_int64, i64p, i8p, i64p, i64p, i64p, ctypes.c_int32,
    ]
    lib.vote_accum_batch_ok = True


def align_and_consensus(
    twin_reads: list[TwinRead], clusters: list[list[int]], args: ClusterArgs
) -> list[ConsensusSequence]:
    """alignment.rs:218-405, with alignments batched across all clusters."""
    # per-cluster prep.  Seed/candidate selection needs only lengths and
    # binned qualities — decode (seq_bytes / expanded_qual_ascii, both
    # memoized on the TwinRead) happens lazily for the <= MAX_SEQS_POA
    # reads actually aligned, not every cluster member.
    class _Lazy:
        __slots__ = ("trs", "fn")

        def __init__(self, trs, fn):
            self.trs, self.fn = trs, fn

        def __getitem__(self, i):
            return self.fn(self.trs[i])

    # per-read accuracies for every cluster member in ONE vector pass,
    # sliced per cluster below (the per-cluster _avg_qual_batch calls were
    # 3 Python loops over every member each)
    members = [twin_reads[rid] for cluster in clusters for rid in cluster]
    all_avgq = _avg_qual_batch(members)
    all_len = np.fromiter((len(tr.codes) for tr in members), np.int64, len(members))
    c_off = np.zeros(len(clusters) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in clusters], out=c_off[1:])
    ctx = []
    for ci, cluster in enumerate(clusters):
        trs = members[c_off[ci] : c_off[ci + 1]]
        avgq = all_avgq[c_off[ci] : c_off[ci + 1]]
        lens = all_len[c_off[ci] : c_off[ci + 1]]
        # seed: sorted((len, i)) picked at the 90th percentile — lexsort by
        # (len, index) is the same stable (len, i) order
        by_len = np.lexsort((np.arange(len(trs)), lens))
        seed_idx = int(by_len[int(len(trs) * 0.9)])
        # order: stable sort by descending accuracy (ties keep index order,
        # matching sorted(key=-avgq[i]))
        order = np.argsort(-avgq, kind="stable")[:MAX_SEQS_POA]
        cands = sorted(int(i) for i in order if i != seed_idx)
        ctx.append({
            "seqs": _Lazy(trs, lambda tr: tr.seq_bytes()),
            "quals": _Lazy(trs, lambda tr: tr.expanded_qual_ascii()),
            "trs": trs, "seed": seed_idx, "cands": cands,
        })
    # one batched decode + qual expansion for every read that will align
    sel: list = []
    for c in ctx:
        sel.append(c["trs"][c["seed"]])
        sel.extend(c["trs"][i] for i in c["cands"])
    TwinRead.warm_seq_bytes(sel)
    TwinRead.warm_qual_ascii(sel)

    # round 1: align candidates to seed, batched over all clusters
    # (indexed form: seeds pool per cluster, reads as their own queries —
    # no per-pair tuples or bytes-keyed dedup; identical results)
    from ..ops.align_batch import align_pairs_indexed

    queries, owners, ti_list = [], [], []
    seeds = [c["seqs"][c["seed"]] for c in ctx]
    for cid, c in enumerate(ctx):
        for i in c["cands"]:
            queries.append(c["seqs"][i])
            ti_list.append(cid)
            owners.append((cid, i))
    res = align_pairs_indexed(
        queries, seeds, np.arange(len(queries)), np.asarray(ti_list, np.int64),
        device=args.device,
    )

    oriented_by_cluster: dict[int, list[tuple[bytes, np.ndarray]]] = {}
    mappings_by_cluster: dict[int, list[Mapping]] = {}
    for (cid, i), m in zip(owners, res):
        if m is None:
            continue
        c = ctx[cid]
        if m.strand == -1:
            o = (revcomp_bytes(c["seqs"][i]), c["quals"][i][::-1])
        else:
            o = (c["seqs"][i], c["quals"][i])
        oriented_by_cluster.setdefault(cid, []).append(o)
        mappings_by_cluster.setdefault(cid, []).append(m)

    templates: dict[int, bytes] = {
        cid: c["seqs"][c["seed"]] for cid, c in enumerate(ctx)
    }

    if args.use_hpc:
        # The reference HPC-compresses every ORIENTED read (with min-run
        # quality, utils.rs:135-184) and runs the consensus in HPC space
        # (alignment.rs:357-377).  Orientation above used raw space, like
        # the reference's aligner.map; the vote's CIGARs must live in HPC
        # space, so compress reads + seed templates and realign.
        for cid in list(oriented_by_cluster):
            oriented_by_cluster[cid] = [
                (hs.tobytes(), hq)
                for hs, hq, _ in (
                    homopolymer_compress_with_quality(
                        np.frombuffer(s, dtype=np.uint8), q
                    )
                    for s, q in oriented_by_cluster[cid]
                )
            ]
        for cid in range(len(ctx)):
            hpc, _ = homopolymer_compress(
                np.frombuffer(templates[cid], dtype=np.uint8), True
            )
            templates[cid] = hpc.tobytes()
        qh, th, ownh = [], [], []
        tpl_pool = [templates[cid] for cid in range(len(ctx))]
        for cid in range(len(ctx)):
            for slot, (oseq, _) in enumerate(oriented_by_cluster.get(cid, [])):
                qh.append(oseq)
                th.append(cid)
                ownh.append((cid, slot))
        resh = align_pairs_indexed(
            qh, tpl_pool, np.arange(len(qh)), np.asarray(th, np.int64),
            device=args.device,
        )
        ori_h: dict[int, list] = {}
        mps_h: dict[int, list] = {}
        for (cid, slot), m in zip(ownh, resh):
            if m is None or m.strand == -1:  # already oriented; flips are noise
                continue
            ori_h.setdefault(cid, []).append(oriented_by_cluster[cid][slot])
            mps_h.setdefault(cid, []).append(m)
        oriented_by_cluster, mappings_by_cluster = ori_h, mps_h

    voted_ids = [cid for cid in range(len(ctx)) if mappings_by_cluster.get(cid)]
    with part("vote"):
        voted = _vote_consensus_batch(
            [templates[cid] for cid in voted_ids],
            [oriented_by_cluster[cid] for cid in voted_ids],
            [mappings_by_cluster[cid] for cid in voted_ids],
            args.threads,
        )
    templates.update(zip(voted_ids, voted))

    # round 2: re-align oriented reads to round-1 templates, batched
    queries2, owners2, ti2 = [], [], []
    templates_list = [templates[cid] for cid in range(len(ctx))]
    for cid in range(len(ctx)):
        for slot, (oseq, _) in enumerate(oriented_by_cluster.get(cid, [])):
            queries2.append(oseq)
            ti2.append(cid)
            owners2.append((cid, slot))
    res2 = align_pairs_indexed(
        queries2, templates_list, np.arange(len(queries2)), np.asarray(ti2, np.int64),
        device=args.device,
    )
    ori2: dict[int, list] = {}
    mps2: dict[int, list] = {}
    for (cid, slot), m in zip(owners2, res2):
        if m is None:
            continue
        oseq, oqual = oriented_by_cluster[cid][slot]
        if m.strand == -1:  # template flipped orientation (rare) — skip read
            continue
        ori2.setdefault(cid, []).append((oseq, oqual))
        mps2.setdefault(cid, []).append(m)

    voted2 = [cid for cid in range(len(ctx)) if mps2.get(cid)]
    with part("vote"):
        voted = _vote_consensus_batch(
            [templates[cid] for cid in voted2],
            [ori2[cid] for cid in voted2],
            [mps2[cid] for cid in voted2],
            args.threads,
        )
    templates.update(zip(voted2, voted))

    out: list[tuple[int, bytes, int, list[int]]] = []
    for cid, cluster in enumerate(clusters):
        template = templates[cid]
        if args.use_hpc:
            hpc, _ = homopolymer_compress(np.frombuffer(template, dtype=np.uint8), True)
            template = hpc.tobytes()
        if len(template) < 40:  # 2*buffer check (alignment.rs:378-381)
            log.warning("consensus for cluster %d too short (%d bp)", cid, len(template))
            continue
        out.append((cid, template, len(cluster), list(cluster)))

    out.sort(key=lambda x: -x[2])  # depth desc, stable
    res_list = [
        ConsensusSequence(
            sequence=np.frombuffer(seq, dtype=np.uint8).copy(),
            hp_lengths=np.ones(len(seq), dtype=np.uint8),
            depth=depth,
            id=cid,
            cluster=cluster,
        )
        for cid, seq, depth, cluster in out
    ]
    log.info("Stage 4a: %d consensus sequences", len(res_list))
    return res_list
