"""Stage 7: EM depth refinement (alignment.rs:1512-2304)."""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..config import ClusterArgs
from ..constants import EM_MAX_ITERATIONS, EM_MINIMIZER_RATIO_BASE, EM_RATIO_THRESHOLD
from ..core import ConsensusSequence, KmerGlobalInfo, TwinRead
from ..ops.align import TargetIndex
from ..ops.align_batch import map_batch
from ..ops.em import em_abundances, groups_to_rows
from ..ops.encode import U64
from ..tracing import part

log = logging.getLogger("savont")


def _run_em(eq_classes: dict[tuple[int, ...], int], n_asvs: int, total_assigned: int) -> np.ndarray:
    """Standard EM over equivalence classes (alignment.rs:1951-2003).

    Vectorized bincount form (ops/em.py); bit-identical to the dict loop
    because accumulation row order matches dict iteration order."""
    gids, iids, weights = groups_to_rows((asvs, count) for asvs, count in eq_classes.items())
    return em_abundances(gids, iids, weights, n_asvs, float(total_assigned), 0.01 / total_assigned, EM_MAX_ITERATIONS)


def _apply_depths(consensuses: list[ConsensusSequence], abund: np.ndarray, total: int) -> list[ConsensusSequence]:
    for i, c in enumerate(consensuses):
        c.depth = int(round(abund[i] * total))
    out = [c for c in consensuses if c.depth > 0]
    log.info("Stage 7: %d ASVs remain after EM (dropped %d zero-depth)", len(out), len(consensuses) - len(out))
    return out


def _sorted_starts(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(unique values, segment starts) of a SORTED index array — what
    np.unique(return_index=True) returns, without re-sorting."""
    if len(idx) == 0:
        return idx[:0], np.zeros(0, np.int64)
    starts = np.flatnonzero(np.concatenate(([True], idx[1:] != idx[:-1])))
    return idx[starts], starts


def _seg_column_counts(mat: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per-segment column sums of a (Q, A) 0/1 matrix.

    Fast path: 1-D np.add.reduceat over 8-column groups viewed as u64
    byte lanes (valid while a segment is shorter than 256 rows — no
    byte-lane overflow).  Rows of longer segments are overwritten with an
    exact per-segment sum.  2-D reduceat is pathologically slow (generic
    per-segment per-column inner loop); this stays one contiguous pass."""
    q, a = mat.shape
    if q == 0 or len(starts) == 0:
        return np.zeros((len(starts), a), np.int64)
    seg_lens = np.diff(np.append(starts, q))
    long_segs = np.flatnonzero(seg_lens >= 256)
    if len(long_segs):
        # byte lanes overflow on long segments; sum those few exactly and
        # let the fast path fill the rest (reduceat segments are
        # independent, so overflowed long-segment rows are just overwritten
        # — never a matrix-wide int64 cumsum, which is an 8x blowup)
        out = _seg_column_counts_fast(mat, starts, a)
        ends = np.append(starts[1:], q)
        for s in long_segs:
            out[s] = mat[starts[s] : ends[s]].sum(axis=0, dtype=np.int64)
        return out
    return _seg_column_counts_fast(mat, starts, a)


def _seg_column_counts_fast(mat: np.ndarray, starts: np.ndarray, a: int) -> np.ndarray:
    q = mat.shape[0]
    out = np.empty((len(starts), a), np.int64)
    m8 = mat.astype(np.uint8, copy=False)
    for g in range(0, a, 8):
        w = min(8, a - g)
        if w == 8:
            blk = np.ascontiguousarray(m8[:, g : g + 8])
        else:
            blk = np.zeros((q, 8), np.uint8)
            blk[:, :w] = m8[:, g : g + w]
        sums = np.add.reduceat(blk.reshape(-1).view(np.uint64), starts)
        out[:, g : g + w] = sums.view(np.uint8).reshape(-1, 8)[:, :w]
    return out


def _expand_ranges(sorted_keys: np.ndarray, queries: np.ndarray):
    """searchsorted range expansion: for each query return flat (query_idx,
    hit_idx) pairs over matching entries in sorted_keys."""
    left = np.searchsorted(sorted_keys, queries, side="left")
    right = np.searchsorted(sorted_keys, queries, side="right")
    counts = right - left
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    qi = np.repeat(np.arange(len(queries)), counts)
    starts = np.repeat(left, counts)
    within = np.arange(total) - np.repeat(np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    return qi, starts + within


def _numpy_mask_join(
    keys: np.ndarray, masks: np.ndarray, q_mini: np.ndarray,
    rm_of: np.ndarray, n_asvs: int, mm_counts: np.ndarray,
) -> None:
    """NumPy fallback of the native mini_mask_join: one searchsorted over
    the query stream, one unpackbits per 8 ASVs, byte-lane segment sums.
    Writes into mm_counts in place (same counts as the native kernel)."""
    if not (len(q_mini) and len(keys)):
        return
    pos = np.minimum(np.searchsorted(keys, q_mini), len(keys) - 1)
    hm = np.where(keys[pos] == q_mini, masks[pos], np.uint64(0))
    bit_groups = []
    for g in range((n_asvs + 7) // 8):
        byte = ((hm >> np.uint64(8 * g)) & np.uint64(0xFF)).astype(np.uint8)
        bit_groups.append(np.unpackbits(byte[:, None], axis=1, bitorder="little"))
    bits = (
        np.concatenate(bit_groups, axis=1)[:, :n_asvs]
        if len(bit_groups) > 1
        else bit_groups[0][:, :n_asvs]
    )
    urm, urm_start = _sorted_starts(rm_of)
    mm_counts[urm] = _seg_column_counts(bits, urm_start)


def _all_snpmer_candidates(
    read_list: list[TwinRead],
    asv_trs: list[TwinRead],
    k: int,
    c_rate: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tied-lowest-mismatch candidates per read, globally vectorized
    (alignment.rs:1779-1836 semantics).  Returns flat arrays
    (read_idx, asv_idx, lowest_mm) over all candidate pairs — one row per
    (read, tied-best ASV)."""
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    mask = U64(np.uint64(0xFFFFFFFFFFFFFFFF) ^ np.uint64(3 << (k - 1)))
    n_asvs = len(asv_trs)
    n_reads = len(read_list)
    if n_asvs == 0 or n_reads == 0:
        return empty

    # (unique splitmer) x ASV table: per ASV at most one full kmer per
    # splitmer (DEDUP_SNPMERS holds for ASV TwinReads too), so the join is
    # one searchsorted + a (Q, A) table gather — no (read-snpmer, asv-entry)
    # row expansion (the expansion materialized ~25M-row index arrays at
    # 100k reads and dominated stage 7)
    asv_sm, asv_km, asv_id = [], [], []
    for ai, atr in enumerate(asv_trs):
        _, kms = atr.snpmers_vec()
        asv_sm.append(kms & mask)
        asv_km.append(kms)
        asv_id.append(np.full(len(kms), ai, dtype=np.int32))
    asv_sm = np.concatenate(asv_sm) if asv_sm else np.zeros(0, U64)
    asv_km = np.concatenate(asv_km) if asv_km else np.zeros(0, U64)
    asv_id = np.concatenate(asv_id) if asv_id else np.zeros(0, np.int32)
    keys_sm, pos_k = np.unique(asv_sm, return_inverse=True)
    K = len(keys_sm)

    # flat read snpmer queries
    read_km = [tr.snpmer_kmers() for tr in read_list]
    read_of = np.repeat(np.arange(n_reads), [len(x) for x in read_km])
    q_km = np.concatenate(read_km) if read_km else np.zeros(0, U64)
    if len(q_km) == 0 or K == 0:
        return empty

    # fast path needs at most one full kmer per (splitmer, ASV) cell —
    # scan-time DEDUP_SNPMERS gives this for real TwinReads; synthetic
    # inputs may violate it and take the row-expansion path below
    cell = pos_k.astype(np.int64) * max(n_asvs, 1) + asv_id
    if len(np.unique(cell)) == len(cell):
        table_km = np.zeros((max(K, 1), n_asvs), dtype=U64)
        table_present = np.zeros((max(K, 1), n_asvs), dtype=bool)
        table_km[pos_k, asv_id] = asv_km
        table_present[pos_k, asv_id] = True
        q_sm = q_km & mask
        pos = np.minimum(np.searchsorted(keys_sm, q_sm), K - 1)
        hit_key = keys_sm[pos] == q_sm
        pres = table_present[pos] & hit_key[:, None]  # (Q, A)
        mism = pres & (table_km[pos] != q_km[:, None])
        # segment-reduce per read (read_of is sorted by construction)
        ur, ustart = _sorted_starts(read_of)
        mm_seg = _seg_column_counts(mism, ustart)
        hit_seg = _seg_column_counts(pres, ustart)
        mismatches = np.zeros((n_reads, n_asvs), dtype=np.int64)
        has_hit = np.zeros((n_reads, n_asvs), dtype=bool)
        mismatches[ur] = mm_seg
        has_hit[ur] = hit_seg > 0
    else:
        order = np.argsort(asv_sm, kind="stable")
        asv_sm_s, asv_km_s, asv_id_s = asv_sm[order], asv_km[order], asv_id[order]
        qi, hi = _expand_ranges(asv_sm_s, q_km & mask)
        if len(qi) == 0:
            return empty
        r_ids = read_of[qi]
        a_ids = asv_id_s[hi].astype(np.int64)
        is_match = q_km[qi] == asv_km_s[hi]
        flat = (r_ids * n_asvs + a_ids) * 2 + is_match
        counts = np.bincount(flat, minlength=n_reads * n_asvs * 2).reshape(n_reads, n_asvs, 2)
        mismatches = counts[:, :, 0]
        has_hit = counts.sum(axis=2) > 0
    if not has_hit.any():
        return empty

    # minimizer match counts.  ASV minimizer sets are deduped, so a read/ASV
    # shared count is a set-membership count: build one sorted global key
    # table with a per-key ASV membership bitmask, then ONE searchsorted per
    # query + per-ASV weighted bincounts.  This avoids materializing the
    # (query, asv) pair expansion, which was the stage-7 hotspot at 20k reads
    # (10M pairs, ~2.3 s) — the bitmask join does the same in ~0.3 s.
    per_asv_unique = [np.unique(atr.minimizer_kmers()) for atr in asv_trs]
    asv_mini_sizes = np.array([len(u) for u in per_asv_unique], dtype=np.int64)

    from ..ops.kmers_native import (
        mini_mask_join_native,
        sort_unique_batch_flat_native,
    )

    flat_res = sort_unique_batch_flat_native([tr.minimizer_kmers() for tr in read_list])
    mm_counts = None
    if n_asvs <= 64:
        keys = np.unique(np.concatenate(per_asv_unique)) if per_asv_unique else np.zeros(0, U64)
        masks = np.zeros(len(keys), dtype=U64)
        for ai, u in enumerate(per_asv_unique):
            masks[np.searchsorted(keys, u)] |= np.uint64(1 << ai)
    if flat_res is not None and n_asvs <= 64:
        # one threaded native bitmask join; read_minis never materialized
        q_flat, q_start, q_cnt = flat_res
        mm_counts = mini_mask_join_native(keys, masks, q_flat, q_start, q_cnt, n_asvs)
    if mm_counts is not None:
        read_mini_sizes = q_cnt.astype(np.int64)
    else:
        if flat_res is not None:
            q_flat, q_start, q_cnt = flat_res
            read_minis = [
                q_flat[s : s + c] for s, c in zip(q_start.tolist(), q_cnt.tolist())
            ]
        else:
            read_minis = [np.unique(tr.minimizer_kmers()) for tr in read_list]
        read_mini_sizes = np.fromiter((len(x) for x in read_minis), np.int64, n_reads)
        rm_of = np.repeat(np.arange(n_reads), read_mini_sizes)
        q_mini = np.concatenate(read_minis) if read_minis else np.zeros(0, U64)
        mm_counts = np.zeros((n_reads, n_asvs), dtype=np.int64)
        if n_asvs <= 64:
            _numpy_mask_join(keys, masks, q_mini, rm_of, n_asvs, mm_counts)
        else:
            amini = np.concatenate(per_asv_unique) if per_asv_unique else np.zeros(0, U64)
            amini_id = np.repeat(np.arange(n_asvs, dtype=np.int64), asv_mini_sizes)
            order = np.argsort(amini, kind="stable")
            amini, amini_id = amini[order], amini_id[order]
            qi2, hi2 = _expand_ranges(amini, q_mini)
            if len(qi2):
                flat2 = rm_of[qi2] * n_asvs + amini_id[hi2]
                mm_counts += np.bincount(flat2, minlength=n_reads * n_asvs).reshape(n_reads, n_asvs)

    min_ratio = EM_MINIMIZER_RATIO_BASE ** k
    denom = np.minimum(read_mini_sizes[:, None], asv_mini_sizes[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        mini_ok = (mm_counts > 0) & (mm_counts / np.maximum(denom, 1) >= min_ratio)
        ratio = mismatches / np.maximum(mm_counts, 1) / c_rate
    eligible = has_hit & mini_ok & (ratio <= EM_RATIO_THRESHOLD)

    # per read: tied-lowest-mismatch eligible ASVs, fully vectorized
    big = np.iinfo(np.int64).max
    masked_mm = np.where(eligible, mismatches, big)
    lowest = masked_mm.min(axis=1)
    keep = eligible & (masked_mm == lowest[:, None])
    r_ids2, a_ids2 = np.nonzero(keep)
    return r_ids2.astype(np.int64), a_ids2.astype(np.int64), lowest[r_ids2]


def refine_asv_depths_with_em(
    twin_reads: list[TwinRead],
    consensuses: list[ConsensusSequence],
    kmer_info: KmerGlobalInfo,
    args: ClusterArgs,
    build_asv_twin_reads,
    sample_filter: int | None = None,
) -> tuple[list[ConsensusSequence], dict[tuple[int, ...], int], int]:
    """SNPmer-candidate + alignment-tie-break EM (alignment.rs:1716-2033).

    build_asv_twin_reads: callable returning the ASVs as TwinReads.
    sample_filter: if set, only reads with that file_idx participate
    (per-sample quantification, alignment.rs:2038-2209) and depths are NOT
    applied; returns (consensuses unchanged, eq_classes, total).
    """
    if not consensuses:
        return consensuses, {}, 0
    eq_classes: dict[tuple[int, ...], int] = {}
    unambig = np.zeros(len(consensuses), dtype=np.int64)
    ambig = np.zeros(len(consensuses), dtype=np.int64)
    leq10 = np.zeros(len(consensuses), dtype=np.int64)
    total_assigned = 0
    filtered = 0
    mapping_lines: list[str] = []

    with part("candidates"):  # the SNPmer candidates and their reads' bytes
        asv_trs: list[TwinRead] = build_asv_twin_reads()
        k = args.kmer_size
        asv_seqs = [a.seq_bytes() for a in asv_trs]
        # gather candidates for all reads, then batch the tie-break alignments
        read_list = [
            tr for tr in twin_reads if sample_filter is None or tr.file_idx == sample_filter
        ]
        cr, ca, _cm = _all_snpmer_candidates(read_list, asv_trs, k, args.c)
        # the reference maps ASV-as-query against a read index
        # (alignment.rs:1841-1855); NM of the optimal local alignment is
        # orientation-symmetric, and read-as-query lets the ASV target
        # indexes be cached (one per ASV instead of one per read).
        # Indexed form: decompress each candidate read once, keep (query,
        # target) id arrays — the aligner plans straight off them
        ur, qi = np.unique(cr, return_inverse=True)
        cand_trs = [read_list[int(r)] for r in ur.tolist()]
        TwinRead.warm_seq_bytes(cand_trs)  # one batched decode for all misses
        read_seqs = [tr.seq_bytes() for tr in cand_trs]
    # stage 7 reads only NM: the device route (kernel 1, NM mode) returns
    # one flat int64 array (-1 = unaligned), the winners align_pairs_nm
    # picks; the tie sets and the EM below run on the host
    from ..parallel.mesh import stage7_nm_values

    nm_vals = stage7_nm_values(read_seqs, asv_seqs, qi, ca, device=args.device)

    ok = nm_vals >= 0
    nm_all = np.where(ok, nm_vals, 0)
    rr, aa, nm, mm = cr[ok], ca[ok], nm_all[ok], _cm[ok]
    if len(rr) == 0:
        # no read has an aligned candidate (possible per-sample when one
        # file's reads all fail candidate selection); the caller guards
        # total == 0
        if sample_filter is None:
            _write_read_asv_mappings(
                Path(args.output_dir) / "temp" / "read_to_asv_mappings.tsv", []
            )
        log.info("Stage 7: 0 reads assigned, %d filtered, 0 eq classes", len(read_list))
        return consensuses, eq_classes, 0
    order = np.lexsort((aa, nm, rr))
    rr, aa, nm, mm = rr[order], aa[order], nm[order], mm[order]
    starts = np.flatnonzero(np.concatenate(([True], rr[1:] != rr[:-1])))
    ends = np.append(starts[1:], len(rr))
    # tied-best prefix per read (rows sorted by nm, then asv, within read)
    best_nm_per = nm[starts]
    seg_id = np.repeat(np.arange(len(starts)), ends - starts)
    in_best = nm == best_nm_per[seg_id]
    best_len = np.bincount(seg_id, weights=in_best, minlength=len(starts)).astype(np.int64)

    total_assigned = len(starts)
    filtered = len(read_list) - total_assigned
    if sample_filter is None:
        singles = best_len == 1
        unambig += np.bincount(aa[starts[singles]], minlength=len(consensuses))
        multi_rows = in_best & np.repeat(~singles, ends - starts)
        ambig += np.bincount(aa[multi_rows], minlength=len(consensuses))
        leq_rows = in_best & np.repeat(best_nm_per <= 10, ends - starts)
        leq10 += np.bincount(aa[leq_rows], minlength=len(consensuses))
        cons_ids = [c.id for c in consensuses]
        # alignment.rs:1871-1884: up to 5 aligned candidates per read in
        # ascending-NM order, columns = read, asv, SNPmer mismatches, NM
        pos_in_seg = np.arange(len(rr)) - starts[seg_id]
        bi = np.flatnonzero(pos_in_seg < 5)
        # plain-int rows via tolist: str() of np scalars is ~3x a python
        # int, and the per-row attribute chain cost ~0.5 s at 100k reads
        mapping_lines.extend(
            f"{read_list[r].id}\tasv:{cons_ids[a]}\t{m}\t{n}\n"
            for r, a, m, n in zip(
                rr[bi].tolist(), aa[bi].tolist(), mm[bi].tolist(), nm[bi].tolist()
            )
        )
    # NOTE: eq-class insertion order is LOAD-BEARING — _run_em's bincount
    # accumulation row order matches dict iteration order, and f64 addition
    # order changes last-ulp abundances.  Keep the first-occurrence-in-read-
    # order dict build; do not replace with np.unique (which sorts).
    bits = max(1, int(len(consensuses) + 1).bit_length())
    if int(best_len.max()) * bits <= 63:
        # pack each read's (ascending-ASV) tied-best set into one int64
        # ((a+1) per position, 0-terminated) and count with a dict over
        # ints — same first-occurrence order, no 100k-iteration slice loop
        rows_b = np.flatnonzero(in_best)
        seg_start = np.zeros(len(best_len), np.int64)
        np.cumsum(best_len[:-1], out=seg_start[1:])
        pos = np.arange(len(rows_b), dtype=np.int64) - np.repeat(seg_start, best_len)
        vals = (aa[rows_b].astype(np.int64) + 1) << (pos * bits)
        packed = np.add.reduceat(vals, seg_start)
        from collections import Counter

        for key, count in Counter(packed.tolist()).items():
            t = []
            while key:
                t.append((key & ((1 << bits) - 1)) - 1)
                key >>= bits
            eq_classes[tuple(t)] = count
    else:
        eq_counts: dict[bytes, int] = {}
        for s, e, bl in zip(starts, ends, best_len):
            key = aa[s : s + bl].tobytes()
            eq_counts[key] = eq_counts.get(key, 0) + 1
        for key, count in eq_counts.items():
            eq_classes[tuple(np.frombuffer(key, dtype=aa.dtype).tolist())] = count

    if sample_filter is None:
        _write_read_asv_mappings(
            Path(args.output_dir) / "temp" / "read_to_asv_mappings.tsv", mapping_lines
        )
    log.info("Stage 7: %d reads assigned, %d filtered, %d eq classes", total_assigned, filtered, len(eq_classes))
    if not eq_classes:
        return consensuses, eq_classes, total_assigned

    if sample_filter is None:
        for i, c in enumerate(consensuses):
            c.unambig_best_read_map_count = int(unambig[i])
            c.ambig_read_map_count = int(ambig[i])
            c.num_map_leq_10nm = int(leq10[i])
        abund = _run_em(eq_classes, len(consensuses), total_assigned)
        consensuses = _apply_depths(consensuses, abund, total_assigned)
    return consensuses, eq_classes, total_assigned


def _write_read_asv_mappings(path, lines):
    """temp/read_to_asv_mappings.tsv.  EM path (alignment.rs:1871-1884):
    up to 5 aligned candidates per read in ascending-NM order,
    `read\tasv:<id>\t<snpmer_mismatches>\t<nm>`.  Low-poly path
    (alignment.rs:1597-1600): `read\tasv:<id>\t<best_nm>` per tied-best."""
    with open(path, "w") as f:
        f.writelines(lines)


def refine_asv_depths_with_minimap(
    twin_reads: list[TwinRead],
    consensuses: list[ConsensusSequence],
    args: ClusterArgs,
    sample_filter: int | None = None,
) -> tuple[list[ConsensusSequence], dict[tuple[int, ...], int], int]:
    """Low-polymorphism path: pure alignment mapping with mapq>0 gate
    (alignment.rs:1520-1712)."""
    if not consensuses:
        return consensuses, {}, 0
    index = TargetIndex([c.get_decompressed() for c in consensuses])
    eq_classes: dict[tuple[int, ...], int] = {}
    unambig = np.zeros(len(consensuses), dtype=np.int64)
    ambig = np.zeros(len(consensuses), dtype=np.int64)
    leq10 = np.zeros(len(consensuses), dtype=np.int64)
    total_assigned = 0
    filtered = 0
    mapping_lines: list[str] = []
    read_list = [tr for tr in twin_reads if sample_filter is None or tr.file_idx == sample_filter]
    all_hits = map_batch(index, [tr.seq_bytes() for tr in read_list], device=args.device)
    for tr, raw_hits in zip(read_list, all_hits):
        hits = [m for m in raw_hits if m.mapq > 0]
        if not hits:
            filtered += 1
            continue
        best_nm = min(m.nm for m in hits)
        best_set = sorted({m.target_id for m in hits if m.nm == best_nm})
        if sample_filter is None:
            mapping_lines.extend(
                f"{tr.id}\tasv:{consensuses[a].id}\t{best_nm}\n" for a in best_set
            )
            if len(best_set) == 1:
                unambig[best_set[0]] += 1
            else:
                for a in best_set:
                    ambig[a] += 1
            if best_nm <= 10:
                for a in best_set:
                    leq10[a] += 1
        eq_classes[tuple(best_set)] = eq_classes.get(tuple(best_set), 0) + 1
        total_assigned += 1

    if sample_filter is None:
        _write_read_asv_mappings(
            Path(args.output_dir) / "temp" / "read_to_asv_mappings.tsv", mapping_lines
        )
    log.info("Stage 7 (low-poly): %d assigned, %d filtered", total_assigned, filtered)
    if not eq_classes:
        return consensuses, eq_classes, total_assigned
    if sample_filter is None:
        for i, c in enumerate(consensuses):
            c.unambig_best_read_map_count = int(unambig[i])
            c.ambig_read_map_count = int(ambig[i])
            c.num_map_leq_10nm = int(leq10[i])
        abund = _run_em(eq_classes, len(consensuses), total_assigned)
        consensuses = _apply_depths(consensuses, abund, total_assigned)
    return consensuses, eq_classes, total_assigned


def compute_per_sample_depths(
    twin_reads: list[TwinRead],
    n_samples: int,
    consensuses: list[ConsensusSequence],
    kmer_info: KmerGlobalInfo,
    args: ClusterArgs,
    build_asv_twin_reads,
) -> list[list[int]]:
    """Per-sample EM (alignment.rs:2038-2304)."""
    n_asvs = len(consensuses)
    result = [[0] * n_samples for _ in range(n_asvs)]
    if n_asvs == 0 or n_samples == 0:
        return result
    for s in range(n_samples):
        if args.low_polymorphism:
            _, eq, total = refine_asv_depths_with_minimap(twin_reads, consensuses, args, sample_filter=s)
        else:
            _, eq, total = refine_asv_depths_with_em(
                twin_reads, consensuses, kmer_info, args, build_asv_twin_reads, sample_filter=s
            )
        if not eq or total == 0:
            continue
        abund = _run_em(eq, n_asvs, total)
        for i in range(n_asvs):
            result[i][s] = int(round(abund[i] * total))
    return result
