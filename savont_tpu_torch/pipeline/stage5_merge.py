"""Stage 5: consensus dedup + merge (alignment.rs:97-188, 1155-1510)."""
from __future__ import annotations

import logging

import numpy as np

from ..config import ClusterArgs
from ..core import ConsensusSequence
from ..ops.align import TargetIndex
from ..ops.align_batch import map_batch
from ..ops.encode import revcomp_bytes
from ..ops.kmers import minimizer_sketch_batch

log = logging.getLogger("savont")


def _has_homopolymer_context(seq: np.ndarray, pos: int, window: int) -> bool:
    """Run of length > 2 within +-window of pos (alignment.rs:75-95)."""
    n = len(seq)
    if n == 0:
        return False
    start = max(pos - window, 0)
    end = min(pos + window + 1, n)
    if end <= start + 2:
        return False
    for i in range(start, max(end - 2, start)):
        if i + 2 < n and seq[i] == seq[i + 1] == seq[i + 2]:
            return True
    return False


def calculate_adjusted_errors(
    cigar,
    query_seq: np.ndarray,
    target_seq: np.ndarray,
    query_start: int,
    target_start: int,
) -> int:
    """Gap-collapsed, end-buffered, homopolymer-aware error count
    (alignment.rs:101-188).  Mismatch counting is vectorized per M run;
    indel runs (rare) keep the scalar homopolymer-context checks."""
    from ..ops.align import cigar_lens_ops

    lens, ops = cigar_lens_ops(cigar)
    if len(lens) == 0:
        return 0
    errors = 0
    buffer = 35
    q_adv = np.where(ops != 2, lens, 0)
    t_adv = np.where(ops != 1, lens, 0)
    qp_run = query_start + np.cumsum(q_adv) - q_adv
    tp_run = target_start + np.cumsum(t_adv) - t_adv

    is_m = ops == 0
    if is_m.any():
        ml = lens[is_m]
        within = np.arange(int(ml.sum())) - np.repeat(np.cumsum(ml) - ml, ml)
        qpos = np.repeat(qp_run[is_m], ml) + within
        tpos = np.repeat(tp_run[is_m], ml) + within
        ok = (qpos < len(query_seq)) & (tpos < len(target_seq))
        qb = query_seq[qpos[ok]]
        tb = target_seq[tpos[ok]]
        qo = qpos[ok]
        n_char = ord("N")
        errors += int(
            (
                (qb != tb) & (qb != n_char) & (tb != n_char)
                & (qo > buffer) & (qo + buffer < len(query_seq))
            ).sum()
        )

    for r in np.flatnonzero(~is_m):
        op, length = int(ops[r]), int(lens[r])
        qp, tp = int(qp_run[r]), int(tp_run[r])
        in_hp = _has_homopolymer_context(query_seq, qp, 2) or _has_homopolymer_context(target_seq, tp, 2)
        if op == 1:
            if not in_hp and qp > buffer and qp + length + buffer < len(query_seq):
                errors += 1 if length < 10 else length
        else:
            if not in_hp and tp > buffer and tp + length + buffer < len(target_seq):
                errors += 1 if length < 10 else length
    return errors


def _adjusted_errors_native(
    cigars, q_arrs, t_arrs, q_starts, t_starts, n_runs: np.ndarray, buffer: int
) -> np.ndarray | None:
    """ONE native CIGAR walk per job (native/pileup.cpp adjusted_errors_batch)
    — no per-base M-run index streams.  None -> NumPy batch path."""
    import ctypes

    from .pileup import _get_pileup_lib

    lib = _get_pileup_lib()
    if lib is None or not hasattr(lib, "adjusted_errors_batch"):
        return None
    n = len(cigars)
    cig_off = np.zeros(n + 1, np.int64)
    np.cumsum(n_runs, out=cig_off[1:])
    cig_cat = np.ascontiguousarray(
        np.concatenate([np.asarray(c, np.uint32) for c in cigars])
    )

    def _pool(arrs):
        ids: dict[int, int] = {}
        idx = np.empty(n, np.int64)
        uniq: list[np.ndarray] = []
        for i, a in enumerate(arrs):
            j = ids.get(id(a))
            if j is None:
                j = ids[id(a)] = len(uniq)
                uniq.append(np.ascontiguousarray(a, np.uint8))
            idx[i] = j
        plens = np.fromiter((len(a) for a in uniq), np.int64, len(uniq))
        off = np.zeros(len(uniq) + 1, np.int64)
        np.cumsum(plens, out=off[1:])
        cat = np.concatenate(uniq) if uniq else np.zeros(0, np.uint8)
        return cat, np.ascontiguousarray(off[:-1][idx]), np.ascontiguousarray(plens[idx])

    q_cat, q_off_j, q_len_j = _pool(q_arrs)
    t_cat, t_off_j, t_len_j = _pool(t_arrs)
    qs = np.ascontiguousarray(np.asarray(q_starts, np.int64))
    ts = np.ascontiguousarray(np.asarray(t_starts, np.int64))
    errors = np.zeros(n, np.int64)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    lib.adjusted_errors_batch(
        ptr(cig_cat, ctypes.c_uint32), ptr(cig_off, ctypes.c_int64),
        ptr(q_cat, ctypes.c_uint8), ptr(q_off_j, ctypes.c_int64), ptr(q_len_j, ctypes.c_int64),
        ptr(t_cat, ctypes.c_uint8), ptr(t_off_j, ctypes.c_int64), ptr(t_len_j, ctypes.c_int64),
        ptr(qs, ctypes.c_int64), ptr(ts, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_int64(buffer),
        ptr(errors, ctypes.c_int64), ctypes.c_int32(0),
    )
    return errors


def calculate_adjusted_errors_batch(
    cigars: list, q_arrs: list[np.ndarray], t_arrs: list[np.ndarray],
    q_starts, t_starts,
) -> np.ndarray:
    """Batched twin of calculate_adjusted_errors: ONE concatenated CIGAR-run
    pass drives the vectorized M-run mismatch counts for every job (the
    per-call numpy glue was ~1k dispatch rounds in the stage-5 all-vs-all);
    indel runs (rare) keep the scalar homopolymer-context checks.
    Bit-identical totals (tests/test_classify_sintax_export.py)."""
    from ..ops.align import cigar_lens_ops

    n = len(cigars)
    errors = np.zeros(n, dtype=np.int64)
    if n == 0:
        return errors
    buffer = 35
    n_runs = np.fromiter((len(c) for c in cigars), np.int64, n)
    if int(n_runs.sum()) == 0:
        return errors
    native = _adjusted_errors_native(cigars, q_arrs, t_arrs, q_starts, t_starts, n_runs, buffer)
    if native is not None:
        return native
    cg = np.concatenate([np.asarray(c, np.uint32) for c in cigars])
    run_job = np.repeat(np.arange(n), n_runs)
    lens, ops = cigar_lens_ops(cg)
    q_adv = np.where(ops != 2, lens, 0)
    t_adv = np.where(ops != 1, lens, 0)
    Eq = np.cumsum(q_adv) - q_adv
    Et = np.cumsum(t_adv) - t_adv
    first_run = np.cumsum(n_runs) - n_runs
    has = n_runs > 0
    q_base = np.zeros(n, np.int64)
    t_base = np.zeros(n, np.int64)
    q_base[has] = Eq[first_run[has]]
    t_base[has] = Et[first_run[has]]
    qs = np.asarray(q_starts, np.int64)
    ts = np.asarray(t_starts, np.int64)
    qp_run = qs[run_job] + Eq - q_base[run_job]
    tp_run = ts[run_job] + Et - t_base[run_job]

    # sequence pools, deduped by object identity (fwd consensuses repeat
    # across jobs; rc variants are cached by the caller)
    def _pool(arrs):
        ids: dict[int, int] = {}
        idx = np.empty(n, np.int64)
        uniq: list[np.ndarray] = []
        for i, a in enumerate(arrs):
            j = ids.get(id(a))
            if j is None:
                j = ids[id(a)] = len(uniq)
                uniq.append(a)
            idx[i] = j
        plens = np.fromiter((len(a) for a in uniq), np.int64, len(uniq))
        off = np.zeros(len(uniq) + 1, np.int64)
        np.cumsum(plens, out=off[1:])
        cat = np.concatenate(uniq) if uniq else np.zeros(0, np.uint8)
        return cat, off[:-1][idx], plens[idx]

    q_cat, q_off_j, q_len_j = _pool(q_arrs)
    t_cat, t_off_j, t_len_j = _pool(t_arrs)

    is_m = ops == 0
    if is_m.any():
        ml = lens[is_m]
        mj = run_job[is_m]
        within = np.arange(int(ml.sum())) - np.repeat(np.cumsum(ml) - ml, ml)
        ej = np.repeat(mj, ml)
        qpos = np.repeat(qp_run[is_m], ml) + within
        tpos = np.repeat(tp_run[is_m], ml) + within
        ok = (qpos < q_len_j[ej]) & (tpos < t_len_j[ej])
        qpo, tpo, ejo = qpos[ok], tpos[ok], ej[ok]
        qb = q_cat[q_off_j[ejo] + qpo]
        tb = t_cat[t_off_j[ejo] + tpo]
        n_char = ord("N")
        cond = (
            (qb != tb) & (qb != n_char) & (tb != n_char)
            & (qpo > buffer) & (qpo + buffer < q_len_j[ejo])
        )
        if cond.any():
            errors += np.bincount(ejo[cond], minlength=n)
    for r in np.flatnonzero(~is_m).tolist():
        j = int(run_job[r])
        op, length = int(ops[r]), int(lens[r])
        qp, tp = int(qp_run[r]), int(tp_run[r])
        qseq, tseq = q_arrs[j], t_arrs[j]
        in_hp = _has_homopolymer_context(qseq, qp, 2) or _has_homopolymer_context(tseq, tp, 2)
        if op == 1:
            if not in_hp and qp > buffer and qp + length + buffer < len(qseq):
                errors[j] += 1 if length < 10 else length
        else:
            if not in_hp and tp > buffer and tp + length + buffer < len(tseq):
                errors[j] += 1 if length < 10 else length
    return errors


def remove_similar_seqs_kmers(consensuses: list[ConsensusSequence]) -> list[ConsensusSequence]:
    """Drop consensuses whose full (w=10,k=21) sketch over [25, len-25] of the
    HPC sequence is contained in a consensus with > 2x depth
    (alignment.rs:1155-1201).  Sequences shorter than 100 bp are dropped
    entirely (the reference never re-adds them)."""
    keep_ids = [i for i, c in enumerate(consensuses) if len(c.sequence) >= 100]
    batch = minimizer_sketch_batch(
        [consensuses[i].sequence[25 : len(consensuses[i].sequence) - 25] for i in keep_ids],
        10, 21,
    )
    sketches: dict[int, np.ndarray] = {}
    kmer_index: dict[int, set[int]] = {}
    for i, (vals, _) in zip(keep_ids, batch):
        sketches[i] = vals
        for v in vals:
            kmer_index.setdefault(int(v), set()).add(i)
    kept = []
    for i in sorted(sketches):
        minis = sketches[i]
        if len(minis) == 0:
            kept.append(consensuses[i])
            continue
        cands = {
            j
            for j in kmer_index.get(int(minis[0]), set())
            if consensuses[j].depth // 2 > consensuses[i].depth
        }
        for v in minis[1:]:
            if not cands:
                break
            cands &= kmer_index.get(int(v), set())
        if not cands:
            kept.append(consensuses[i])
    return kept


def merge_similar_consensuses(
    consensuses: list[ConsensusSequence],
    low_qual: list[ConsensusSequence],
    args: ClusterArgs,
) -> list[ConsensusSequence]:
    """alignment.rs:1206-1510.  Returns (merged, reusable_all_vs_all_hits):
    the second element is the stage-5 all-vs-all map_batch result when it is
    still valid for the returned list (no merges, order preserved), else
    None — stage-6 chimera detection reuses it instead of re-aligning."""
    if not consensuses:
        return consensuses, None

    prev = len(consensuses)
    consensuses = remove_similar_seqs_kmers(consensuses)
    log.info("Stage 5 dedup: %d -> %d consensuses", prev, len(consensuses))

    for c in consensuses:
        c.decompress()

    # alignment.rs:1224-1228: post-dedup snapshot for indexing/debugging
    from pathlib import Path

    from .outputs import write_consensus_fasta

    write_consensus_fasta(
        consensuses,
        Path(args.output_dir) / "temp" / "polished_consensuses.fasta",
        "polished",
    )
    index = TargetIndex([c.get_decompressed() for c in consensuses])

    # (b) merge low-quality consensuses in (NM <= 10); note the reference
    # zeroes appended_depth when rebuilding consensuses below, so this only
    # affects logs — kept for structural parity.
    for lc in low_qual:
        lc.decompress()
    lq_hits = map_batch(
        index, [lc.get_decompressed() for lc in low_qual], max_hits=1, device=args.device
    )
    for lc, hits in zip(low_qual, lq_hits):
        if hits and hits[0].nm <= 10:
            consensuses[hits[0].target_id].appended_depth += lc.depth

    # (c) all-vs-all with adjusted errors (batched)
    mappings: list[tuple[int, int, int, int]] = []  # (q, t, adj_nm, t_depth)
    all_hits = map_batch(
        index, [c.get_decompressed() for c in consensuses], max_hits=75, no_diag=True,
        device=args.device,
    )
    jobs: list[tuple[int, Mapping]] = []  # type: ignore[name-defined]
    q_arrs_j, t_arrs_j, qs_j, ts_j, cigs = [], [], [], [], []
    rc_cache: dict[int, np.ndarray] = {}
    for qi, cons in enumerate(consensuses):
        qseq = cons.get_decompressed()
        for m in all_hits[qi]:
            if m.query_end - m.query_start < len(qseq) * 3 // 4 or m.nm > 30:
                continue
            tseq = consensuses[m.target_id].get_decompressed()
            if m.strand == -1:
                rq = rc_cache.get(qi)
                if rq is None:
                    rq = rc_cache[qi] = np.frombuffer(
                        revcomp_bytes(qseq.tobytes()), dtype=np.uint8
                    )
                q_arrs_j.append(rq)
                qs_j.append(len(qseq) - m.query_end)
            else:
                q_arrs_j.append(qseq)
                qs_j.append(m.query_start)
            t_arrs_j.append(tseq)
            ts_j.append(m.target_start)
            cigs.append(m.cigar)
            jobs.append((qi, m))
    adjs = calculate_adjusted_errors_batch(cigs, q_arrs_j, t_arrs_j, qs_j, ts_j)
    for (qi, m), adj in zip(jobs, adjs.tolist()):
        adj = min(int(adj), m.nm)
        mappings.append((qi, m.target_id, adj, consensuses[m.target_id].depth))

    # merge decisions (alignment.rs:1364-1444)
    merge_map: dict[int, int] = {}
    for qi in range(len(consensuses)):
        qd = consensuses[qi].depth
        valid: list[tuple[int, int, int]] = []
        for (q, t, nm, td) in mappings:
            if q != qi or t == qi:
                continue
            rel = qd / td
            thresh = 0.5 ** (nm * 0.75 + 1.25)
            if nm == 0:
                thresh = 0.999999
                if qd == td:
                    if qi > t:
                        valid.append((t, nm, td))
                    continue
            if rel < thresh or 1.0 / rel < thresh:
                valid.append((t, nm, td))
        if not valid:
            continue
        q_to_ref = []
        ref_to_q = []
        for t, nm, td in valid:
            if consensuses[t].depth == qd:
                if nm == 0 and qi > t:
                    merge_map[qi] = t
                continue
            if consensuses[t].depth > qd:
                q_to_ref.append((t, nm, td))
            else:
                ref_to_q.append(t)
        if q_to_ref:
            q_to_ref.sort(key=lambda x: -x[2])
            merge_map[qi] = q_to_ref[0][0]
        for t in ref_to_q:
            if t not in merge_map:
                merge_map[t] = qi

    # resolve chains (alignment.rs:1450-1459)
    merged_into: dict[int, int] = {}
    for qi in list(merge_map):
        t = merge_map[qi]
        seen = {qi}
        while t in merge_map and t not in seen:
            seen.add(t)
            t = merge_map[t]
        merged_into[qi] = t

    new_clusters = [list(c.cluster) for c in consensuses]
    for qi, t in merged_into.items():
        new_clusters[t].extend(new_clusters[qi])
        new_clusters[qi] = []

    out: list[ConsensusSequence] = []
    for idx, cons in enumerate(consensuses):
        if new_clusters[idx]:
            nc = ConsensusSequence(
                sequence=cons.sequence,
                hp_lengths=cons.hp_lengths,
                depth=len(new_clusters[idx]),
                id=cons.id,
                cluster=new_clusters[idx],
            )
            nc.decompress()
            out.append(nc)
    out.sort(key=lambda c: -c.depth)
    log.info("Stage 5 merge: %d -> %d consensuses (%d merges)", len(consensuses), len(out), len(merged_into))
    # When nothing merged and the order survived, the all-vs-all hits above
    # are exactly what stage-6 chimera detection would recompute over the
    # same index/queries — hand them over (valid only while the max_hits=75
    # cap cannot bind: one hit per (target, best strand) caps at n-1).
    reusable = (
        not merged_into
        and len(out) == len(consensuses)
        and len(consensuses) <= 76
        and all(a.sequence is b.sequence for a, b in zip(out, consensuses))
    )
    # the hits travel TAGGED with the exact list object they are valid for;
    # stage-6 checks identity (not just length) before trusting them
    return out, ((all_hits, out) if reusable else None)
