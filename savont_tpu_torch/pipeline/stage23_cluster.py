"""Stages 2-3: greedy k-mer clustering (LSH) + SNPmer sub-clustering with
iterative consensus reclustering.  Reference: asv_cluster.rs.

The greedy outer loops are order-dependent by design and stay on the host
(thousands of iterations); the per-candidate similarity math is vectorized.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..config import ClusterArgs
from ..constants import (
    KMER_CLUSTER_THRESHOLD,
    LSH_BUCKET_SIZE,
    LSH_NUM_TABLES,
    TOP_N_LSH_CANDIDATES,
)
from ..core import TwinRead
from ..ops.encode import U64

log = logging.getLogger("savont")


def _split_mask(k: int) -> U64:
    return U64(np.uint64(0xFFFFFFFFFFFFFFFF) ^ np.uint64(3 << (k - 1)))


# ── Stage 2: greedy k-mer (LSH) clustering ──────────────────────────────────


def cluster_reads_by_kmers(twin_reads: list[TwinRead], args: ClusterArgs) -> list[list[int]]:
    """asv_cluster.rs:72-249.  Sequential greedy over reads (quality order);
    candidates from 20 LSH tables; verification by exact minimizer
    containment ratio^(1/k) > 0.950."""
    k = args.kmer_size
    assignment_arr = _cluster_native(twin_reads, k)
    if assignment_arr is not None:
        clusters_map: dict[int, list[int]] = {}
        for read_id, rep in enumerate(assignment_arr):
            clusters_map.setdefault(int(rep), []).append(read_id)
        clusters = [sorted(c) for c in clusters_map.values()]
        clusters.sort(key=lambda c: (-len(c), c[0]))
        clusters = [c for c in clusters if len(c) >= args.min_cluster_size]
        log.info(
            "Stage 2: %d reps, %d clusters >= min size",
            len(set(int(a) for a in assignment_arr)), len(clusters),
        )
        return clusters

    # Python greedy path consumes per-read signature LISTS, which the
    # native batch compute no longer materializes — fill them on demand
    from ..core import ensure_lsh_signature_lists

    ensure_lsh_signature_lists(twin_reads)
    bucket_index: list[dict[int, list[int]]] = [dict() for _ in range(LSH_NUM_TABLES)]
    assignment: dict[int, int] = {}
    representatives: list[int] = []
    rep_kmer_sets: dict[int, np.ndarray] = {}  # rep -> sorted unique kmers
    rep_vec_len: dict[int, int] = {}

    for read_id, read in enumerate(twin_reads):
        sigs = read.lsh_signatures
        hits: dict[int, int] = {}
        for t in range(LSH_NUM_TABLES):
            sig = sigs[t] if t < len(sigs) else None
            if sig is None:
                continue
            for cand in bucket_index[t].get(sig, ()):  # type: ignore[arg-type]
                hits[cand] = hits.get(cand, 0) + 1

        best_rep = None
        if hits:
            # sort by (hits desc, cand_id desc) — asv_cluster.rs:111
            candidates = sorted(hits.items(), key=lambda x: (-x[1], -x[0]))
            max_hits = candidates[0][1]
            to_check = []
            for cand, h in candidates:
                if h == max_hits or len(to_check) < TOP_N_LSH_CANDIDATES:
                    to_check.append(cand)
                else:
                    break

            read_set = np.unique(read.minimizer_kmers())
            best_sim = 0.0
            for cand in to_check:
                rep_set = rep_kmer_sets[cand]  # sorted unique
                # membership via binary search (np.isin re-sorts both sides)
                if len(rep_set) == 0 or len(read_set) == 0:
                    count = 0
                else:
                    idx = np.searchsorted(rep_set, read_set)
                    idx[idx == len(rep_set)] = len(rep_set) - 1
                    count = int((rep_set[idx] == read_set).sum())
                denom = max(len(read_set), rep_vec_len[cand])
                if denom == 0:
                    continue
                sim = (count / denom) ** (1.0 / k)
                if sim > best_sim:
                    best_sim = sim
                    best_rep = cand
            if best_sim <= KMER_CLUSTER_THRESHOLD:
                best_rep = None

        if best_rep is not None:
            assignment[read_id] = best_rep
        else:
            for t in range(LSH_NUM_TABLES):
                sig = sigs[t] if t < len(sigs) else None
                if sig is not None:
                    bucket_index[t].setdefault(sig, []).append(read_id)
            assignment[read_id] = read_id
            representatives.append(read_id)
            km = read.minimizer_kmers()
            rep_kmer_sets[read_id] = np.unique(km)
            rep_vec_len[read_id] = len(km)

    clusters_map: dict[int, list[int]] = {}
    for read_id, rep in assignment.items():
        clusters_map.setdefault(rep, []).append(read_id)
    clusters = [sorted(c) for c in clusters_map.values()]
    clusters.sort(key=lambda c: (-len(c), c[0]))
    clusters = [c for c in clusters if len(c) >= args.min_cluster_size]
    log.info("Stage 2: %d reps, %d clusters >= min size", len(representatives), len(clusters))
    return clusters


def _cluster_native(twin_reads: list[TwinRead], k: int) -> np.ndarray | None:
    """Native greedy LSH clustering (same semantics; see kmerscan.cpp
    lsh_greedy_cluster).  None -> use the Python loop."""
    from ..ops.kmers_native import lsh_greedy_cluster_native

    from ..core import cached_lsh_matrix

    n = len(twin_reads)
    cached = cached_lsh_matrix(twin_reads)
    if cached is not None:
        # matrices straight from the batch compute (per-read validity, all
        # tables valid or none — same shape the list walk produced)
        m_sigs, m_valid = cached
        sigs = m_sigs
        valid = np.repeat(m_valid[:, None], LSH_NUM_TABLES, axis=1)
    else:
        # cache miss (different list object than the batch compute saw):
        # recompute the matrices natively — compute_lsh_signatures_batch no
        # longer materializes per-read lists when the native lib exists, so
        # the list walk below only serves reads whose signatures were
        # filled by the per-read Python fallback
        from ..ops.kmers_native import lsh_batch_native

        res = lsh_batch_native(
            [tr.mini_kmers_all for tr in twin_reads],
            LSH_NUM_TABLES, LSH_BUCKET_SIZE, 1,
        )
        if res is not None:
            m_sigs, m_valid = res
            sigs = m_sigs
            valid = np.repeat(m_valid[:, None], LSH_NUM_TABLES, axis=1)
        else:
            sigs = np.zeros((n, LSH_NUM_TABLES), dtype=np.uint64)
            valid = np.zeros((n, LSH_NUM_TABLES), dtype=np.uint8)
            for i, tr in enumerate(twin_reads):
                for t, s in enumerate(tr.lsh_signatures[:LSH_NUM_TABLES]):
                    if s is not None:
                        sigs[i, t] = s
                        valid[i, t] = 1
    return lsh_greedy_cluster_native(
        sigs, valid, [tr.minimizer_kmers() for tr in twin_reads],
        KMER_CLUSTER_THRESHOLD**k, TOP_N_LSH_CANDIDATES,
    )


# ── Stage 3: greedy SNPmer sub-clustering ───────────────────────────────────


def compare_blockmers(tr1: TwinRead, tr2: TwinRead, l: int) -> tuple[int, int]:
    """Blockmer (matches, mismatches) by shared anchor (asv_cluster.rs:797-827)."""
    _, kms2 = tr2.blockmers_vec()
    map2 = {int(km) >> (2 * l): int(km) for km in kms2}
    matches = mismatches = 0
    _, kms1 = tr1.blockmers_vec()
    for km in kms1:
        other = map2.get(int(km) >> (2 * l))
        if other is not None:
            if other == int(km):
                matches += 1
            else:
                mismatches += 1
    return matches, mismatches


def _subcluster_postprocess(
    cluster: list[int], local_asn, min_cluster_size: int
) -> list[list[int]]:
    """Local greedy assignments -> sorted, size-filtered sub-cluster lists
    (shared by the single- and multi-cluster native paths)."""
    cmap: dict[int, list[int]] = {}
    for i, rep in enumerate(local_asn):
        cmap.setdefault(cluster[int(rep)], []).append(cluster[i])
    local = [sorted(c) for c in cmap.values()]
    local.sort(key=lambda c: (-len(c), c[0]))
    return [c for c in local if len(c) >= min_cluster_size]


def _snpmer_subcluster(
    cluster: list[int],
    twin_reads: list[TwinRead],
    k: int,
    min_cluster_size: int,
    args: ClusterArgs | None = None,
) -> list[list[int]]:
    """Greedy zero-mismatch SNPmer clustering within one k-mer cluster
    (asv_cluster.rs:593-693).  Uses UNFILTERED snpmer_kmers().  With
    --use-blockmers, compatible candidates are additionally validated by
    blockmer comparison (asv_cluster.rs:499-556: best candidate by fewest
    blockmer mismatches must have <= 1)."""
    use_blockmers = args is not None and args.use_blockmers
    blockmer_l = args.blockmer_length if args is not None else 3
    mask = _split_mask(k)
    # NOTE: --use-blockmers takes the Python greedy loop below (the native
    # subcluster kernel has no blockmer-validation variant) — correctness
    # is identical, but stage 3 is O(cluster * reps) Python at scale.
    if not use_blockmers:
        from ..ops.kmers_native import snpmer_subcluster_native

        local_asn = snpmer_subcluster_native(
            [np.asarray(twin_reads[r].snpmer_kmers(), dtype=np.uint64) for r in cluster],
            int(mask),
        )
        if local_asn is not None:
            return _subcluster_postprocess(cluster, local_asn, min_cluster_size)
    assignment: dict[int, int] = {}
    rep_size: dict[int, int] = {}
    representatives: list[int] = []
    # flat sorted index over all representative snpmers: splitmer-sorted
    # (searchsorted range scans instead of a Python dict walk per snpmer)
    idx_sm = np.zeros(0, dtype=np.uint64)
    idx_km = np.zeros(0, dtype=np.uint64)
    idx_rep = np.zeros(0, dtype=np.int64)

    for read_id in cluster:
        snps = np.asarray(twin_reads[read_id].snpmer_kmers(), dtype=np.uint64)
        compat: list[tuple[int, int, int]] = []
        if len(idx_sm) and len(snps):
            sms = snps & mask
            lo = np.searchsorted(idx_sm, sms, side="left")
            hi = np.searchsorted(idx_sm, sms, side="right")
            runs = hi - lo
            nz = runs > 0
            if nz.any():
                lo_nz, runs_nz = lo[nz], runs[nz]
                total = int(runs_nz.sum())
                flat = np.repeat(lo_nz, runs_nz) + (
                    np.arange(total) - np.repeat(np.cumsum(runs_nz) - runs_nz, runs_nz)
                )
                hit_rep = idx_rep[flat]
                hit_match = idx_km[flat] == np.repeat(snps[nz], runs_nz)
                m = np.bincount(hit_rep[hit_match], minlength=0)
                mm_ids = np.unique(hit_rep[~hit_match])
                m_ids = np.flatnonzero(m)
                good = np.setdiff1d(m_ids, mm_ids, assume_unique=True)
                compat = [(-int(m[cand]), rep_size[int(cand)], int(cand)) for cand in good]
        rep = None
        if compat:
            compat.sort()
            if use_blockmers:
                bcands = [
                    (cand, *compare_blockmers(twin_reads[read_id], twin_reads[cand], blockmer_l))
                    for _, _, cand in compat
                ]
                bcands.sort(key=lambda x: (x[2], -x[1]))
                if bcands[0][2] <= 1:
                    rep = bcands[0][0]
            else:
                rep = compat[0][2]
        if rep is not None:
            assignment[read_id] = rep
            rep_size[rep] = rep_size.get(rep, 0) + 1
        else:
            representatives.append(read_id)
            if len(snps):
                new_sm = snps & mask
                order = np.argsort(new_sm, kind="stable")  # np.insert needs
                new_sm, new_km = new_sm[order], snps[order]  # sorted values
                ins = np.searchsorted(idx_sm, new_sm, side="right")
                idx_sm = np.insert(idx_sm, ins, new_sm)
                idx_km = np.insert(idx_km, ins, new_km)
                idx_rep = np.insert(idx_rep, ins, read_id)
            assignment[read_id] = read_id
            rep_size[read_id] = 1

    cluster_map: dict[int, list[int]] = {}
    for read_id, rep in assignment.items():
        cluster_map.setdefault(rep, []).append(read_id)
    local = [sorted(c) for c in cluster_map.values()]
    local.sort(key=lambda c: (-len(c), c[0]))
    return [c for c in local if len(c) >= min_cluster_size]


# ── Consensus SNPmer machinery for reclustering ─────────────────────────────


@dataclass
class ConsensusPoly:
    position: int
    splitmer: int
    kmer: int
    count: int


def build_consensus_snpmers(
    cluster: list[int],
    twin_reads: list[TwinRead],
    k: int,
    top_n: int | None = None,
    marker: str = "snpmer",
    l: int = 3,
) -> list[ConsensusPoly]:
    """asv_cluster.rs:840-894 (SNPmer) / 905-963 (blockmer) — per splitmer
    (masked k-mer, or anchor for blockmers): most common FULL k-mer from the
    FILTERED snpmers_vec / blockmers_vec view, kept if count >=
    max(len(cluster)/6, 1); median position; sorted by (position, splitmer).

    Tie-break on equal counts: larger kmer value (the reference's
    FxHashMap::max_by_key tie order is unspecified; this is deterministic).
    """
    mask = _split_mask(k)
    n_use = len(cluster) if top_n is None else min(len(cluster), top_n)
    pos_arrs, km_arrs = [], []
    for read_id in cluster[:n_use]:
        if marker == "blockmer":
            pos, kms = twin_reads[read_id].blockmers_vec()
        else:
            pos, kms = twin_reads[read_id].snpmers_vec()
        pos_arrs.append(np.asarray(pos, dtype=np.int64))
        km_arrs.append(np.asarray(kms, dtype=np.uint64))
    if not pos_arrs:
        return []
    allp = np.concatenate(pos_arrs)
    allk = np.concatenate(km_arrs)
    if len(allk) == 0:
        return []
    # per full kmer: count + median position (positions sorted in-segment)
    order = np.lexsort((allp, allk))
    allp, allk = allp[order], allk[order]
    starts = np.flatnonzero(np.concatenate(([True], allk[1:] != allk[:-1])))
    counts = np.diff(np.append(starts, len(allk)))
    ukm = allk[starts]
    medians = allp[starts + counts // 2]
    sms = (ukm >> np.uint64(2 * l)) if marker == "blockmer" else (ukm & mask)
    # per splitmer: variant with max (count, kmer); keep if count >= min_count
    o2 = np.lexsort((ukm, counts, sms))
    sms, ukm, counts, medians = sms[o2], ukm[o2], counts[o2], medians[o2]
    last = np.flatnonzero(np.concatenate((sms[1:] != sms[:-1], [True])))
    min_count = max(len(cluster) // 6, 1)
    keep = last[counts[last] >= min_count]
    out = [
        ConsensusPoly(int(medians[i]), int(sms[i]), int(ukm[i]), int(counts[i]))
        for i in keep
    ]
    out.sort(key=lambda cp: (cp.position, cp.splitmer))
    return out


def compare_consensus(c1: list[ConsensusPoly], c2: list[ConsensusPoly]) -> tuple[int, int]:
    """asv_cluster.rs:968-994."""
    idx = {cp.splitmer: cp.kmer for cp in c2}
    matches = mismatches = 0
    for cp in c1:
        km = idx.get(cp.splitmer)
        if km is not None:
            if km == cp.kmer:
                matches += 1
            else:
                mismatches += 1
    return matches, mismatches


def _concordant(c1: list[ConsensusPoly], c2: list[ConsensusPoly]) -> bool:
    m, mm = compare_consensus(c1, c2)
    return mm == 0 and m >= min(len(c1), max(len(c2), 2))


def _flat_marker_table(
    twin_reads: list[TwinRead], marker: str
) -> tuple[np.ndarray, np.ndarray]:
    """Per-read FILTERED marker k-mers flattened once for the native
    recluster/reassign kernels: (km_flat, koff) indexed by global read id."""
    kms = []
    for tr in twin_reads:
        _, km = tr.blockmers_vec() if marker == "blockmer" else tr.snpmers_vec()
        kms.append(np.asarray(km, dtype=np.uint64))
    koff = np.zeros(len(kms) + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(a) for a in kms), np.int64, len(kms)), out=koff[1:])
    flat = np.concatenate(kms) if kms else np.zeros(0, np.uint64)
    return flat, koff


def _recluster_one_round(
    clusters: list[list[int]], twin_reads: list[TwinRead], k: int,
    marker: str = "snpmer", l: int = 3, flat=None,
) -> tuple[list[list[int]], int]:
    """Merge concordant clusters, larger-first (asv_cluster.rs:1146-1270)."""
    if flat is not None and not log.isEnabledFor(5):
        out = _recluster_one_round_native(clusters, k, marker, l, flat)
        if out is not None:
            return out
    allc = [(c, build_consensus_snpmers(c, twin_reads, k, marker=marker, l=l)) for c in clusters if c]
    allc.sort(key=lambda x: (-len(x[0]), x[0][0] if x[0] else 0))
    merged_flag = [False] * len(allc)
    needs_rebuild = [False] * len(allc)
    merged_clusters: list[list[int]] = []
    num_merges = 0

    for i in range(len(allc)):
        if merged_flag[i]:
            continue
        if needs_rebuild[i]:
            allc[i] = (allc[i][0], build_consensus_snpmers(allc[i][0], twin_reads, k, marker=marker, l=l))
            needs_rebuild[i] = False
        for j in range(i + 1, len(allc)):
            if merged_flag[j]:
                continue
            ci, cj = allc[i][1], allc[j][1]
            concordant = _concordant(ci, cj) and _concordant(cj, ci)
            m, mm = compare_consensus(ci, cj)
            # TRACE: pairwise cluster comparison dump
            log.log(5, "recluster cmp sizes (%d,%d): matches=%d mismatches=%d concordant=%s",
                    len(allc[i][0]), len(allc[j][0]), m, mm, concordant)
            max_len = max(len(allc[i][0]), len(allc[j][0]))
            min_len = min(len(allc[i][0]), len(allc[j][0]))
            if mm == 0 and m > min(len(ci), len(cj)) * 0.975 and max_len // min_len > 50:
                concordant = True
            if mm == 0 and max_len // min_len > 500 and min_len <= 2:
                concordant = True
            if concordant:
                allc[i][0].extend(allc[j][0])
                needs_rebuild[i] = True
                merged_flag[j] = True
                num_merges += 1
        if needs_rebuild[i]:
            allc[i] = (allc[i][0], build_consensus_snpmers(allc[i][0], twin_reads, k, marker=marker, l=l))
        merged_clusters.append(list(allc[i][0]))

    merged_clusters.sort(key=lambda c: (-len(c), c[0] if c else 0))
    return merged_clusters, num_merges


def _recluster_one_round_native(
    clusters: list[list[int]], k: int, marker: str, l: int, flat
) -> tuple[list[list[int]], int] | None:
    """Native twin of _recluster_one_round: consensus build + greedy merge
    pass in C++ (the wasted post-merge rebuilds are skipped — their result
    is never observed)."""
    from ..ops.kmers_native import recluster_round_native

    live = [c for c in clusters if c]
    if not live:
        return [], 0
    live.sort(key=lambda c: (-len(c), c[0]))
    km_flat, koff = flat
    sizes = np.fromiter((len(c) for c in live), np.int64, len(live))
    members = np.fromiter(
        (r for c in live for r in c), np.int64, int(sizes.sum())
    )
    m_off = np.zeros(len(live) + 1, dtype=np.int64)
    np.cumsum(sizes, out=m_off[1:])
    res = recluster_round_native(
        members, m_off, km_flat, koff, marker == "blockmer", l, _split_mask(k)
    )
    if res is None:
        return None
    merged_into, num_merges = res
    kids: dict[int, list[int]] = {}
    for j, tgt in enumerate(merged_into):
        if tgt >= 0:
            kids.setdefault(int(tgt), []).append(j)
    merged_clusters: list[list[int]] = []
    for i, c in enumerate(live):
        if merged_into[i] >= 0:
            continue
        merged = list(c)
        for j in kids.get(i, ()):
            merged.extend(live[j])
        merged_clusters.append(merged)
    merged_clusters.sort(key=lambda c: (-len(c), c[0] if c else 0))
    return merged_clusters, num_merges


def _reassign_reads(
    clusters: list[list[int]], twin_reads: list[TwinRead], k: int, min_cluster_size: int,
    marker: str = "snpmer", l: int = 3, flat=None,
) -> tuple[list[list[int]], int]:
    """Reassign every read to the argmin-(mismatch, -match) cluster
    (asv_cluster.rs:1007-1130).  Initial best = first candidate evaluated
    (index 0) since any mismatch count beats usize::MAX."""
    mask = _split_mask(k)
    C = len(clusters)
    # flat sorted (splitmer, kmer, cluster) table over all consensuses
    cb = None
    sizes = np.fromiter((len(c) for c in clusters), np.int64, C)
    read_ids_arr = np.fromiter(
        (rid for cluster in clusters for rid in cluster), np.int64, int(sizes.sum())
    )
    if flat is not None:
        from ..ops.kmers_native import consensus_batch_native

        m_off = np.zeros(C + 1, dtype=np.int64)
        np.cumsum(sizes, out=m_off[1:])
        cb = consensus_batch_native(
            read_ids_arr, m_off, flat[0], flat[1], marker == "blockmer", l, mask
        )
    if cb is not None:
        cons_sm, cons_km, cons_cid = cb
    else:
        consensus = [build_consensus_snpmers(c, twin_reads, k, marker=marker, l=l) for c in clusters]
        cons_sm = np.array([cp.splitmer for cons in consensus for cp in cons], dtype=np.uint64)
        cons_km = np.array([cp.kmer for cons in consensus for cp in cons], dtype=np.uint64)
        cons_cid = np.repeat(np.arange(C, dtype=np.int64), [len(cons) for cons in consensus])
    o = np.argsort(cons_sm, kind="stable")
    cons_sm, cons_km, cons_cid = cons_sm[o], cons_km[o], cons_cid[o]

    # flatten ALL reads of ALL clusters into one lookup batch
    read_ids = read_ids_arr.tolist()
    orig_ci = np.repeat(np.arange(C, dtype=np.int64), sizes)
    R = len(read_ids)
    mm_mat = np.zeros((R, C), dtype=np.int64)
    m_mat = np.zeros((R, C), dtype=np.int64)
    if R and len(cons_sm):
        from ..ops.kmers_native import snpmer_join_count_native

        if flat is not None and cb is not None:  # cb != None => native lib up
            km_flat, koff = flat
            cnts = koff[read_ids_arr + 1] - koff[read_ids_arr]
            ridx = np.repeat(np.arange(R, dtype=np.int64), cnts)
            from ..ops.kmers_native import _compact

            allk, _ = _compact(km_flat, koff[read_ids_arr], cnts)
        else:
            km_arrs = []
            for rid in read_ids:
                if marker == "blockmer":
                    _, kms = twin_reads[rid].blockmers_vec()
                else:
                    _, kms = twin_reads[rid].snpmers_vec()
                km_arrs.append(np.asarray(kms, dtype=np.uint64))
            allk = np.concatenate(km_arrs) if km_arrs else np.zeros(0, np.uint64)
            ridx = np.repeat(np.arange(R, dtype=np.int64), [len(a) for a in km_arrs])
        sms = (allk >> np.uint64(2 * l)) if marker == "blockmer" else (allk & mask)
        native = snpmer_join_count_native(
            sms, allk, ridx, cons_sm, cons_km, cons_cid, R, C, threads=4
        )
        if native is not None:
            m_mat, mm_mat = native
        else:
            lo = np.searchsorted(cons_sm, sms, side="left")
            hi = np.searchsorted(cons_sm, sms, side="right")
            runs = hi - lo
            nz = runs > 0
            if nz.any():
                runs_nz = runs[nz]
                total = int(runs_nz.sum())
                flat = np.repeat(lo[nz], runs_nz) + (
                    np.arange(total) - np.repeat(np.cumsum(runs_nz) - runs_nz, runs_nz)
                )
                hit_rc = ridx[nz].repeat(runs_nz) * C + cons_cid[flat]
                hit_match = cons_km[flat] == np.repeat(allk[nz], runs_nz)
                m_mat = np.bincount(hit_rc[hit_match], minlength=R * C).reshape(R, C)
                mm_mat = np.bincount(hit_rc[~hit_match], minlength=R * C).reshape(R, C)
    # per read: argmin of (mm, -m), first index on ties — matches the scalar
    # loop's strict-improvement rule (initial best beats inf)
    best = np.argmin((mm_mat << np.int64(32)) - m_mat, axis=1) if R else np.zeros(0, np.int64)
    reassigned = int((best != orig_ci).sum())
    new_clusters: list[list[int]] = [[] for _ in clusters]
    for rid, b in zip(read_ids, best):
        new_clusters[b].append(rid)
    out = [sorted(c) for c in new_clusters if c and len(c) >= min_cluster_size]
    return out, reassigned


def write_snpmer_clusters_tsv(path, clusters, twin_reads, prefix="final_cluster"):
    """Final stage-3 TSV (asv_cluster.rs:779-795): per cluster a header row
    then one `read_id est_id` line per member."""
    from .outputs import rust_f64

    with open(path, "w") as f:
        for i, c in enumerate(clusters):
            members = "\n".join(
                f"{twin_reads[x].id} {rust_f64(twin_reads[x].est_id if twin_reads[x].est_id is not None else 100.0)}"
                for x in c
            )
            f.write(f"{prefix}_{i}\tsize_{len(c)}\trepresentative_{c[0]}\tmembers\n{members}\n")


def write_prerecluster_tsv(path, groups: dict[int, list[list[int]]]):
    """snpmer_clusters_before_reclust2.5.tsv (asv_cluster.rs:725-745):
    header + one row per (kmer cluster, local snpmer cluster) with
    comma-joined member indices.  The reference iterates an FxHashMap
    (arbitrary order); we iterate kmer-cluster ids ascending for
    determinism — row SET is identical."""
    with open(path, "w") as f:
        f.write("kmer_cluster_id\tsnpmer_cluster_id\tsize\trepresentative\tmembers\n")
        for gid in sorted(groups):
            for local_id, c in enumerate(groups[gid]):
                if not c:
                    continue
                f.write(
                    f"{gid}\t{local_id}\t{len(c)}\t{c[0]}\t{','.join(map(str, c))}\n"
                )


def cluster_reads_by_snpmers(
    twin_reads: list[TwinRead], kmer_clusters: list[list[int]], args: ClusterArgs,
    temp_dir=None,
) -> list[list[int]]:
    """Stage 3 entry point (asv_cluster.rs:561-795 + 1272-1433)."""
    if args.low_polymorphism:
        clusters = [c for c in kmer_clusters if len(c) >= args.min_cluster_size]
        clusters.sort(key=lambda c: (-len(c), c[0] if c else 0))
        log.info("Stage 3 skipped (low-polymorphism): %d clusters pass through", len(clusters))
        return clusters

    k = args.kmer_size
    marker = "blockmer" if args.use_blockmers else "snpmer"
    groups: dict[int, list[list[int]]] = {}
    live = [(gid, c) for gid, c in enumerate(kmer_clusters) if len(c) >= 1]
    multi_asn = None
    if not args.use_blockmers and live:
        # all clusters in ONE parallel native call (the greedy order only
        # matters within a cluster); postprocess per cluster is unchanged
        from ..ops.kmers_native import snpmer_subcluster_multi_native

        mask = _split_mask(k)
        c_off = np.zeros(len(live) + 1, dtype=np.int64)
        np.cumsum([len(c) for _, c in live], out=c_off[1:])
        snp_lists = [
            np.asarray(twin_reads[r].snpmer_kmers(), dtype=np.uint64)
            for _, cl in live for r in cl
        ]
        multi_asn = snpmer_subcluster_multi_native(
            snp_lists, c_off, int(mask), threads=args.threads
        )
    if multi_asn is not None:
        for ci, (gid, cluster) in enumerate(live):
            groups[gid] = _subcluster_postprocess(
                cluster, multi_asn[c_off[ci] : c_off[ci + 1]], args.min_cluster_size
            )
    else:
        for gid, cluster in live:
            groups[gid] = _snpmer_subcluster(cluster, twin_reads, k, args.min_cluster_size, args)

    n0 = sum(len(v) for v in groups.values())
    log.info("Stage 3 greedy: %d SNPmer clusters in %d k-mer groups", n0, len(groups))
    if temp_dir is not None:
        write_prerecluster_tsv(
            temp_dir / "snpmer_clusters_before_reclust2.5.tsv", groups
        )

    # iterative reclustering: merge + reassign until no merges.  Per-read
    # marker k-mers are static across rounds: flatten them once for the
    # native consensus/merge/join kernels.
    flat = _flat_marker_table(twin_reads, marker)
    for iteration in range(args.max_iterations_recluster):
        total_merges = 0
        total_reassign = 0
        new_groups: dict[int, list[list[int]]] = {}
        for gid, clusters in groups.items():
            merged, nm = _recluster_one_round(
                clusters, twin_reads, k, marker, args.blockmer_length, flat=flat
            )
            total_merges += nm
            reassigned, nr = _reassign_reads(
                merged, twin_reads, k, args.min_cluster_size, marker,
                args.blockmer_length, flat=flat,
            )
            total_reassign += nr
            if reassigned:
                new_groups[gid] = reassigned
        groups = new_groups
        log.info("recluster iter %d: %d merges, %d reassignments", iteration + 1, total_merges, total_reassign)
        if total_merges == 0:
            break

    final: list[list[int]] = []
    for gid in sorted(groups):
        final.extend(c for c in groups[gid] if c)
    final.sort(key=lambda c: (-len(c), c[0] if c else 0))
    final = [c for c in final if len(c) >= args.min_cluster_size]
    log.info("Stage 3 final: %d clusters", len(final))
    return final
