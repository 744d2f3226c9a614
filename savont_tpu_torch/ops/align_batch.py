"""Batched banded alignment on the port's device.

- The planner: seeding + chaining turn (query, target) pairs into
  AlignJobs, each a query, a target and a raw per-row band corridor
  (plan_jobs, plan_jobs_batch, _plan_pairs).
- The routes: run_jobs and run_jobs_nm run every job on `device`, kernel 1
  (payload mode) + kernel 2 for CIGARs and kernel 1 (NM mode) for NM-only
  scoring, or their plain PyTorch versions on "cpu".
- The consumers: align_pairs, align_pairs_indexed, align_pairs_nm,
  align_pairs_nm_values_indexed and map_batch plan their pairs and send the
  jobs straight to the routes; every one takes the device explicitly.
- The classify route, align_pairs_nm_indexed: the flat plan of indexed
  pairs, kernel 1 (NM mode) over every job and kernels 1 (payload mode) + 2
  over the winning jobs of the hits classify writes, for their starts.

The host C++ DP that the routes are held against is ops/host_dp.py (the
oracle); no consumer here takes it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..tracing import part, span
from .align import (
    Mapping,
    TargetIndex,
    _band_centers,
    _chain_anchors,
    ascii_to_align_codes,
    evict_half,
    resolve_band,
)
from .align_torch import (
    length_chunks_lens,
    plan_tensors,
    plan_to_device,
    sw_forward,
    sw_forward_jobs,
)
from .encode import revcomp_bytes
from .traceback_torch import sw_traceback_jobs, walk_rle, walk_rle_launch

_QCODE_CACHE: dict[tuple[bytes, int], np.ndarray] = {}
_QCODE_CACHE_MAX = 262144

# bytes-IDENTITY keyed code cache for the big-batch planner path: entry is
# [bytes, fwd_codes, rc_codes|None]; holding the bytes object pins its id.
_IDCODE_CACHE: dict[int, list] = {}
_IDCODE_CACHE_MAX = 400_000


def _qcodes_cached(qb: bytes, strand: int) -> np.ndarray:
    """Oriented query codes, memoized across planning calls: the same read
    is planned against several candidate targets (one group per target), so
    a per-call cache re-encoded every read once per group."""
    key = (qb, strand)
    hit = _QCODE_CACHE.get(key)
    if hit is None:
        if len(_QCODE_CACHE) >= _QCODE_CACHE_MAX:
            evict_half(_QCODE_CACHE)
        if strand == 1:
            from .encode import registered_planner_codes

            hit = registered_planner_codes(qb)
        if hit is None:
            hit = ascii_to_align_codes(qb if strand == 1 else revcomp_bytes(qb))
        _QCODE_CACHE[key] = hit
    return hit


def _qcodes_cached_batch(items: list[tuple[bytes, int]]) -> list[np.ndarray]:
    """Batched _qcodes_cached: all cache misses are encoded through ONE
    concatenated LUT gather (the per-call numpy overhead dominated at tens
    of thousands of small sequences).  Same values, same cache.

    Large one-shot batches (whole-readset planner sweeps like the stage-7
    tie-break) bypass the cache entirely: the per-item bytes-key hashing +
    dict churn costs more than re-encoding, and inserting would clear the
    cache out from under the small repeated batches it serves."""
    from .align import _ASCII_CODE

    out: list[np.ndarray | None] = [None] * len(items)
    if len(items) >= 4096:
        # encode each + strand once; - strands derive from the + codes
        # (reverse + 3-complement, code 4 fixed).  Verified byte-exhaustively
        # equal to ascii_to_align_codes(revcomp_bytes(qb)) for every byte
        # EXCEPT U/u (revcomp_bytes leaves U unchanged while the LUT folds
        # it into T) — sequences containing U take the bytes path.  Skips
        # the second 100+ MB bytes join + LUT pass at scale.
        #
        # Cross-call cache keyed by BYTES IDENTITY: TwinRead.seq_bytes()
        # memoizes one bytes object per read, and every planner stage
        # (stage-4 votes, pileups, stage-5, stage-7) re-encodes the same
        # reads once per slab — 4.7 s of the 100k wall before this cache.
        # Keying by id() is safe because the entry holds the bytes object
        # (pins it: its id can't be reused while the entry lives).
        fwd_ids: dict[bytes, int] = {}
        fwd_of = [fwd_ids.setdefault(qb, len(fwd_ids)) for qb, _st in items]
        bufs = list(fwd_ids.keys())
        n_u = len(bufs)
        fwd: list[np.ndarray | None] = [None] * n_u
        if len(_IDCODE_CACHE) > _IDCODE_CACHE_MAX:
            evict_half(_IDCODE_CACHE)
        ents = [_IDCODE_CACHE.get(id(b)) for b in bufs]
        miss = [i for i, e in enumerate(ents) if e is None or e[0] is not bufs[i]]
        for i, e in enumerate(ents):
            if e is not None and e[0] is bufs[i]:
                fwd[i] = e[1]
        if miss:
            # TwinRead-backed bytes reuse their registered 0..3 codes (the
            # LUT is its exact inverse); only the rest take the join+LUT
            from .align import _encode_queries_registry

            mcodes = _encode_queries_registry([bufs[i] for i in miss])
            for c, i in zip(mcodes, miss):
                fwd[i] = c
                _IDCODE_CACHE[id(bufs[i])] = [bufs[i], c, None]

        # reverse complements: cache hits first, the rest in ONE
        # reversed-span gather + one vectorized complement
        rc: dict[int, np.ndarray] = {}
        rc_miss: list[int] = []
        for (_qb, st), fi in zip(items, fwd_of):
            if st == -1 and fi not in rc:
                e = _IDCODE_CACHE.get(id(bufs[fi]))
                if e is not None and e[0] is bufs[fi] and e[2] is not None:
                    rc[fi] = e[2]
                else:
                    rc[fi] = True  # mark; filled below
                    rc_miss.append(fi)
        if rc_miss:
            rl = np.fromiter((len(bufs[fi]) for fi in rc_miss), np.int64, len(rc_miss))
            roff = np.zeros(len(rc_miss) + 1, dtype=np.int64)
            np.cumsum(rl, out=roff[1:])
            total = int(roff[-1])
            fcat = np.concatenate([fwd[fi] for fi in rc_miss]) if total else np.zeros(0, np.uint8)
            from .kmers_native import revcomp_codes_ranges_native

            rc_cat = revcomp_codes_ranges_native(fcat, roff, threads=4)
            if rc_cat is None:
                # NumPy fallback: reversed span within the concat (start at
                # end of each seq); three full-size temporaries, so the
                # native sweep is preferred at scale
                starts = roff[1:] - 1
                idx = np.repeat(starts + roff[:-1], rl) - np.arange(total, dtype=np.int64)
                rc_cat = fcat[idx]
                np.subtract(3, rc_cat, out=rc_cat, where=rc_cat < 4)
            for i, fi in enumerate(rc_miss):
                qb = bufs[fi]
                if b"U" in qb or b"u" in qb:
                    # revcomp_bytes folds U/u differently than the LUT path
                    r = _ASCII_CODE[np.frombuffer(revcomp_bytes(qb), dtype=np.uint8)]
                else:
                    r = rc_cat[roff[i] : roff[i + 1]]
                rc[fi] = r
                e = _IDCODE_CACHE.get(id(qb))
                if e is not None and e[0] is qb:
                    e[2] = r

        return [
            fwd[fi] if st == 1 else rc[fi]
            for (qb, st), fi in zip(items, fwd_of)
        ]
    miss: list[int] = []
    for x, key in enumerate(items):
        hit = _QCODE_CACHE.get(key)
        if hit is None:
            miss.append(x)
        else:
            out[x] = hit
    if miss:
        bufs = [
            items[x][0] if items[x][1] == 1 else revcomp_bytes(items[x][0])
            for x in miss
        ]
        off = np.zeros(len(bufs) + 1, dtype=np.int64)
        np.cumsum(np.fromiter((len(b) for b in bufs), np.int64, len(bufs)), out=off[1:])
        codes_cat = _ASCII_CODE[np.frombuffer(b"".join(bufs), dtype=np.uint8)]
        for i, x in enumerate(miss):
            if len(_QCODE_CACHE) >= _QCODE_CACHE_MAX:
                evict_half(_QCODE_CACHE)
            # views, not copies: every byte of the concat buffer IS a cache
            # entry (all misses are inserted), so pinning it wastes nothing
            # — and the per-miss .copy() was ~3 us x 100k reads
            c = codes_cat[off[i] : off[i + 1]]
            _QCODE_CACHE[items[x]] = c
            out[x] = c
    return out


@dataclass(slots=True)
class AlignJob:
    """One planned banded alignment (post seeding/chaining)."""

    qcodes: np.ndarray  # oriented query codes (0..4)
    tcodes: np.ndarray  # target codes
    lo: np.ndarray  # per-row band lower bound (int32, len == len(qcodes))
    # metadata to build the Mapping afterwards
    target_id: int
    strand: int
    fwd_qlen: int


def plan_jobs(
    index: TargetIndex,
    query_ascii: bytes | np.ndarray,
    band: int | None = None,
    min_anchors: int = 3,
    no_diag_id: int | None = None,
) -> list[AlignJob]:
    """Seeding + chaining for a query against an index; one job per
    (target, strand) that has a viable chain."""
    band = resolve_band(band)
    if isinstance(query_ascii, (bytes, bytearray)):
        qbytes = bytes(query_ascii)
    else:
        qbytes = np.asarray(query_ascii, dtype=np.uint8).tobytes()
    qf = ascii_to_align_codes(qbytes)
    from .align import _group_anchors, window_minimizers_cached

    hq, pq, fq = window_minimizers_cached(qbytes, index.w, index.k)
    qlen = len(qf)

    per_ts = _group_anchors(index, hq, pq, fq, qlen, no_diag_id)

    qr = None
    jobs: list[AlignJob] = []
    for (tid, strand), (qa, ta) in per_ts.items():
        if len(qa) < min_anchors:
            continue
        chain = _chain_anchors(qa, ta)
        if len(chain) < min_anchors:
            continue
        if strand == -1 and qr is None:
            qr = ascii_to_align_codes(revcomp_bytes(qbytes))
        qcodes = qf if strand == 1 else qr
        centers = _band_centers(len(qcodes), qa[chain], ta[chain])
        tcodes = index.targets[tid]
        n = len(tcodes)
        b = min(band, max(8, n))
        lo = np.maximum.accumulate(
            np.clip(centers - b // 2, 0, max(n - b, 0))
        ).astype(np.int32)
        jobs.append(AlignJob(qcodes, tcodes, lo, tid, strand, qlen))
    return jobs


def plan_jobs_batch(
    index: TargetIndex,
    queries: list[bytes],
    band: int | None = None,
    min_anchors: int = 3,
    no_diag: bool = False,
) -> tuple[list[AlignJob], list[int]]:
    """Seeding + chaining for MANY queries against one index in a single
    vectorized lookup pass.  Returns (jobs, owner_query_index)."""
    from .align import window_minimizers_flat_batch

    band = resolve_band(band)

    # gather all query minimizers with query ids (flat pools; large batches
    # bypass the tuple cache — see window_minimizers_flat_batch)
    all_h, all_p, all_f, moff = window_minimizers_flat_batch(
        [bytes(q) for q in queries], index.w, index.k
    )
    if len(all_h) == 0 or len(index.h_sorted) == 0:
        return [], []
    all_p = all_p.astype(np.int32)
    qid = np.repeat(np.arange(len(queries)), np.diff(moff)).astype(np.int32)
    qlens = np.array([len(q) for q in queries], dtype=np.int64)

    # one flat lookup (native binary search when available)
    from .kmers_native import anchor_search_native

    searched = anchor_search_native(index.h_sorted, all_h)
    if searched is not None:
        left, counts, total = searched
    else:
        left = np.searchsorted(index.h_sorted, all_h, side="left")
        right = np.searchsorted(index.h_sorted, all_h, side="right")
        counts = right - left
        total = int(counts.sum())
    if total == 0:
        return [], []

    # dims for the packed u64 sort key (20+14+1+14+14 bits)
    dims_fit = (
        len(queries) < (1 << 20)
        and len(index.targets) < (1 << 14)
        and int(qlens.max(initial=0)) - index.k < (1 << 14)
        and (int(index.h_tpos.max()) if len(index.h_tpos) else 0) < (1 << 14)
    )
    keys = None
    if dims_fit:
        from .kmers_native import anchor_sorted_keys_native

        keys = anchor_sorted_keys_native(
            left, counts, all_p, all_f, qid, qlens,
            index.h_tid, index.h_tpos, index.h_isf,
            index.k, no_diag, threads=4,
        )
    if keys is not None:
        # native path: expansion + no_diag filter + radix sort done in C.
        # Group bounds come straight from the high key bits (qid|tid|strand),
        # so only the anchor coordinates are decoded full-size; the per-group
        # fields decode from the first key of each group.
        if len(keys) == 0:
            return [], []
        hi_bits = keys >> np.uint64(28)
        bounds = np.flatnonzero(np.concatenate(([True], hi_bits[1:] != hi_bits[:-1])))
        grp_off = np.append(bounds, len(keys))
        kb = keys[bounds]
        g_qi = (kb >> np.uint64(43)).astype(np.int64)
        g_tid = ((kb >> np.uint64(29)) & np.uint64(0x3FFF)).astype(np.int64)
        g_st = np.where((kb >> np.uint64(28)) & np.uint64(1), 1, -1).astype(np.int8)
        qp_o = ((keys >> np.uint64(14)) & np.uint64(0x3FFF)).astype(np.int64)
        tpos = (keys & np.uint64(0x3FFF)).astype(np.int64)
    else:
        mi = np.repeat(np.arange(len(all_h)), counts)
        starts = np.repeat(left, counts)
        within = np.arange(total) - np.repeat(np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        hidx = starts + within

        h_qid = qid[mi]
        h_tid = index.h_tid[hidx]
        if no_diag:
            keep = h_tid != h_qid
            mi, hidx, h_qid, h_tid = mi[keep], hidx[keep], h_qid[keep], h_tid[keep]
            if len(mi) == 0:
                return [], []
        same = index.h_isf[hidx] == all_f[mi]
        strand = np.where(same, 1, -1).astype(np.int8)
        qp_o = np.where(same, all_p[mi], (qlens[h_qid] - index.k - all_p[mi])).astype(np.int64)
        tpos = index.h_tpos[hidx].astype(np.int64)
        if (
            dims_fit
            and int(qp_o.max(initial=0)) < (1 << 14)
            and int(qp_o.min(initial=0)) >= 0
        ):
            key = (
                (h_qid.astype(np.uint64) << np.uint64(43))
                | (h_tid.astype(np.uint64) << np.uint64(29))
                | ((strand == 1).astype(np.uint64) << np.uint64(28))
                | (qp_o.astype(np.uint64) << np.uint64(14))
                | tpos.astype(np.uint64)
            )
            order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((tpos, qp_o, strand, h_tid, h_qid))
        h_qid, h_tid, strand, qp_o, tpos = (
            h_qid[order], h_tid[order], strand[order], qp_o[order], tpos[order],
        )
        bounds = np.flatnonzero(
            np.concatenate(
                ([True],
                 (h_qid[1:] != h_qid[:-1]) | (h_tid[1:] != h_tid[:-1]) | (strand[1:] != strand[:-1]))
            )
        )
        grp_off = np.append(bounds, len(h_qid))
        g_qi, g_tid, g_st = h_qid[bounds], h_tid[bounds], strand[bounds]
    t_lens = np.array([len(tc) for tc in index.targets], dtype=np.int64)

    from .kmers_native import chain_band_native, get_scan_lib

    jobs: list[AlignJob] = []
    owners: list[int] = []

    if get_scan_lib() is not None:
        lo_flat, lo_off, nchain = chain_band_native(
            qp_o, tpos, grp_off, qlens[g_qi], t_lens[g_tid], band, min_anchors
        )
        kept = np.flatnonzero(nchain >= min_anchors)
        qcodes_all = _qcodes_cached_batch(
            [(bytes(queries[int(g_qi[g])]), int(g_st[g])) for g in kept]
        )
        for g, qcodes in zip(kept, qcodes_all):
            qi, tid, st = int(g_qi[g]), int(g_tid[g]), int(g_st[g])
            lo = lo_flat[lo_off[g] : lo_off[g] + len(qcodes)]
            jobs.append(AlignJob(qcodes, index.targets[tid], lo, tid, st, int(qlens[qi])))
            owners.append(qi)
        return jobs, owners

    for g in range(len(bounds)):
        s, e = int(grp_off[g]), int(grp_off[g + 1])
        if e - s < min_anchors:
            continue
        qi, tid, st = int(g_qi[g]), int(g_tid[g]), int(g_st[g])
        qa, ta = qp_o[s:e], tpos[s:e]
        chain = _chain_anchors(qa, ta)
        if len(chain) < min_anchors:
            continue
        qcodes = _qcodes_cached(bytes(queries[qi]), st)
        centers = _band_centers(len(qcodes), qa[chain], ta[chain])
        tcodes = index.targets[tid]
        n = len(tcodes)
        b = min(band, max(8, n))
        lo = np.maximum.accumulate(
            np.clip(centers - b // 2, 0, max(n - b, 0))
        ).astype(np.int32)
        jobs.append(AlignJob(qcodes, tcodes, lo, tid, st, int(qlens[qi])))
        owners.append(qi)
    return jobs, owners


def _plan_soa_indexed(
    qry_bytes: list[bytes], tgt_bytes: list[bytes],
    job_uq_arr: np.ndarray, job_ti_arr: np.ndarray,
    band: int | None, min_anchors: int = 2,
):
    """Struct-of-arrays planning (minimizers -> anchors -> chains -> band
    corridors) for indexed jobs: input job k aligns qry_bytes[job_uq_arr[k]]
    against tgt_bytes[job_ti_arr[k]].  The flat plan the device routes of
    stages 4 and 7 (parallel/mesh.py) pack their kernel tensors from, with
    no per-job Python object.  Returns None when the inputs lie outside the
    packed key widths (the caller takes the per-job consumers), the string
    "empty" when no job yields a chain, else the flat plan tuple
      (owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
       t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all, band)
    where job k of the plan aligns oriented query codes
    q_cat[q_off_j[k] : q_off_j[k]+q_lens_j[k]] against target codes
    t_cat[t_off_j[k] : ...] inside the corridor lo_flat[lo_off_j[k] : ...],
    and owner_j[k] is the input job index it belongs to.  Plan order is the
    per-pair order (pair ascending, strand - then +), so earliest-job
    tie-breaks match align_pairs / align_pairs_nm exactly."""
    from .align import window_minimizers_flat_batch
    from .kmers_native import (
        anchor_keys_indexed_native,
        chain_band_native,
        get_scan_lib,
        get_sort_lib,
    )

    band = resolve_band(band)
    n_pairs = len(job_uq_arr)
    if get_scan_lib() is None or get_sort_lib() is None or not n_pairs:
        return None
    if n_pairs >= (1 << 21):
        return None  # job id field: key bits 43..63
    qlens_all = np.fromiter((len(q) for q in qry_bytes), np.int64, len(qry_bytes))
    tlens_all = np.fromiter((len(t) for t in tgt_bytes), np.int64, len(tgt_bytes))
    max_qlen = int(qlens_all.max()) if len(qlens_all) else 0
    max_tlen = int(tlens_all.max()) if len(tlens_all) else 0
    if max_qlen >= (1 << 14) + 15 or max_tlen >= (1 << 14):
        return None  # packed anchor key field widths

    # one minimizer pass over unique queries, straight into flat pools; one
    # single-target index each (all target scans batched in one native call)
    pool_h, pool_p, pool_f, q_moff = window_minimizers_flat_batch(qry_bytes, 10, 15)
    indexes = TargetIndex.build_singletons(tgt_bytes)

    # concatenated per-target tables (singleton tables carry tid = 0, so the
    # packed keys' tid field stays 0 and group identity lives in the job id)
    tab_off = np.zeros(len(indexes) + 1, dtype=np.int64)
    np.cumsum([len(ix.h_sorted) for ix in indexes], out=tab_off[1:])
    h_cat = np.concatenate([ix.h_sorted for ix in indexes]) if indexes else np.zeros(0, np.uint64)
    tpos_cat = np.concatenate([ix.h_tpos for ix in indexes]) if indexes else np.zeros(0, np.int32)
    isf_cat = np.concatenate([ix.h_isf for ix in indexes]) if indexes else np.zeros(0, bool)

    if int(q_moff[-1]) == 0:
        return "empty"
    # fused indexed anchor planning: job j probes its unique query's pooled
    # minimizers against its target table and emits packed sorted keys
    # directly.  Sorted keys have the job id in the top bits, so key runs
    # appear in ascending pair order (within a pair: strand - then +)
    keys = anchor_keys_indexed_native(
        h_cat, tab_off, pool_h, pool_p, pool_f, q_moff,
        job_uq_arr, job_ti_arr, qlens_all, tpos_cat, isf_cat,
        indexes[0].k if indexes else 15, threads=4,
    )
    if keys is None:
        return None
    if len(keys) == 0:
        return "empty"
    hi_bits = keys >> np.uint64(28)
    bounds = np.flatnonzero(np.concatenate(([True], hi_bits[1:] != hi_bits[:-1])))
    sizes_all = np.diff(np.append(bounds, len(keys)))
    kb = keys[bounds]
    g_job = (kb >> np.uint64(29)).astype(np.int64)
    qa_all = ((keys >> np.uint64(14)) & np.uint64(0x3FFF)).astype(np.int64)
    ta_all = (keys & np.uint64(0x3FFF)).astype(np.int64)
    grp_off = np.zeros(len(sizes_all) + 1, dtype=np.int64)
    np.cumsum(sizes_all, out=grp_off[1:])
    uq_g = job_uq_arr[g_job]
    st_g = np.where((kb >> np.uint64(28)) & np.uint64(1), 1, -1).astype(np.int8)
    tid_g = job_ti_arr[g_job]

    # one chaining/band-planning pass over every (pair, strand) group
    lo_flat, lo_off_g, nchain = chain_band_native(
        qa_all, ta_all, grp_off, qlens_all[uq_g], tlens_all[tid_g], band, min_anchors
    )
    kept = np.flatnonzero(nchain >= min_anchors)
    if len(kept) == 0:
        return "empty"

    owner_j = g_job[kept]
    uq_j = uq_g[kept]
    st_j = st_g[kept]
    tid_j = tid_g[kept]
    q_lens_j = qlens_all[uq_j].astype(np.int32)
    lo_off_j = lo_off_g[kept]

    # code pools: encode each used (query, strand) / target exactly once.
    # combo ids are dense (< 2 * n_queries), so a flag + rank table gives
    # unique/inverse in O(n + nq) instead of np.unique's sort
    combo = uq_j * 2 + (st_j == 1)
    flags = np.zeros(2 * len(qry_bytes), dtype=bool)
    flags[combo] = True
    ucombo = np.flatnonzero(flags)
    rank = np.cumsum(flags) - 1
    inv = rank[combo]
    combo_codes = _qcodes_cached_batch(
        [(qry_bytes[cb >> 1], 1 if cb & 1 else -1) for cb in ucombo.tolist()]
    )
    combo_lens = np.fromiter((len(c) for c in combo_codes), np.int64, len(combo_codes))
    combo_off = np.zeros(len(combo_codes) + 1, dtype=np.int64)
    np.cumsum(combo_lens, out=combo_off[1:])
    q_cat = np.concatenate(combo_codes) if combo_codes else np.zeros(0, np.uint8)
    q_off_j = combo_off[inv]

    t_codes = [idx.targets[0] for idx in indexes]
    t_off_all = np.zeros(len(t_codes) + 1, dtype=np.int64)
    np.cumsum(tlens_all, out=t_off_all[1:])  # codes are 1:1 with target bytes
    t_cat = np.concatenate(t_codes) if t_codes else np.zeros(0, np.uint8)
    t_off_j = t_off_all[tid_j]
    t_lens_j = tlens_all[tid_j].astype(np.int32)
    return (
        owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
        t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all, band,
    )


def plan_job(plan: tuple, k: int) -> AlignJob:
    """Job k of a _plan_soa_indexed plan as an AlignJob (for the few jobs a
    device route hands to the host oracle)."""
    (_owner_j, uq_j, st_j, tid_j, q_cat, q_off_j, q_lens_j,
     t_cat, t_off_j, t_lens_j, lo_flat, lo_off_j, qlens_all, _band) = plan
    n = int(q_lens_j[k])
    qo, to, lo_o = int(q_off_j[k]), int(t_off_j[k]), int(lo_off_j[k])
    return AlignJob(
        q_cat[qo : qo + n], t_cat[to : to + int(t_lens_j[k])], lo_flat[lo_o : lo_o + n],
        int(tid_j[k]), int(st_j[k]), int(qlens_all[uq_j[k]]),
    )


def run_jobs(jobs: list[AlignJob], band: int | None = None, *, device) -> list[tuple | None]:
    """Per job (score, q0, q1, t0, t1, cigar_u32, nm) or None, on `device`:
    kernel 1 (payload mode) + kernel 2 (stage 4-6 CIGAR consumers).  Its
    seconds (packing, kernels, fetch) are the part "dp" (tracing.part)."""
    band = resolve_band(band)
    if not jobs:
        return []
    with part("dp"):
        return sw_traceback_jobs(jobs, band, device=device)


def run_jobs_nm(jobs: list[AlignJob], band: int | None = None, *, device) -> list[tuple | None]:
    """Per job (score, 0, q_end, 0, t_end, [], nm) or None, on `device`:
    kernel 1 (NM mode).  The starts are 0, as in the Pallas NM route of the
    JAX package (stage 7 reads only nm).  Part "dp", as run_jobs."""
    band = resolve_band(band)
    if not jobs:
        return []
    with part("dp"):
        return sw_forward_jobs(jobs, band, device)


def _best_per_pair(n_pairs: int, owner: list[int], jobs: list[AlignJob], raw) -> list[Mapping | None]:
    """Per pair the highest-scoring job's Mapping (the first job on ties):
    the part "map"."""
    best: list[Mapping | None] = [None] * n_pairs
    with part("map"):
        for o, job, r in zip(owner, jobs, raw):
            if r is None:
                continue
            (m,) = _jobs_to_mappings([job], [r])
            if best[o] is None or m.score > best[o].score:
                best[o] = m
    return best


def align_pairs(
    pairs: list[tuple[bytes, bytes]], band: int | None = None, *, device
) -> list[Mapping | None]:
    """Batched independent pair alignments with CIGARs.  Targets are
    deduplicated so a seed/consensus aligned against many reads is indexed
    once."""
    all_jobs, owner = _plan_pairs(pairs, band)
    return _best_per_pair(len(pairs), owner, all_jobs, run_jobs(all_jobs, band, device=device))


def align_pairs_indexed(
    queries: list[bytes], targets: list[bytes],
    qi: np.ndarray, ti: np.ndarray, band: int | None = None, *, device,
) -> list[Mapping | None]:
    """align_pairs of (queries[qi[k]], targets[ti[k]]) per job k, for callers
    that hold unique sequence pools plus index arrays (stage-4 vote rounds,
    pileups)."""
    qi = np.asarray(qi, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)
    pairs = [(queries[a], targets[b]) for a, b in zip(qi.tolist(), ti.tolist())]
    return align_pairs(pairs, band=band, device=device)


def align_pairs_nm(
    pairs: list[tuple[bytes, bytes]], band: int | None = None, *, device
) -> list[Mapping | None]:
    """Batched pair alignment for NM-only consumers (stage-7 tie-break):
    no CIGARs, and query/target starts read 0."""
    all_jobs, owner = _plan_pairs(pairs, band)
    return _best_per_pair(len(pairs), owner, all_jobs, run_jobs_nm(all_jobs, band, device=device))


def align_pairs_nm_values_indexed(
    queries: list[bytes], targets: list[bytes],
    qi: np.ndarray, ti: np.ndarray, band: int | None = None, *, device,
) -> np.ndarray:
    """NM of the best alignment of (queries[qi[k]], targets[ti[k]]) per job
    k as a flat int64 array (-1 = no alignment)."""
    qi = np.asarray(qi, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)
    pairs = [(queries[a], targets[b]) for a, b in zip(qi.tolist(), ti.tolist())]
    maps = align_pairs_nm(pairs, band=band, device=device)
    return np.fromiter((m.nm if m is not None else -1 for m in maps), np.int64, len(maps))


# the classify route's counters: calls, input pairs, plan jobs run through
# kernel 1 (NM mode), winning jobs run again through kernel 1 (payload mode)
# + kernel 2 for their starts, and wall seconds inside and of them in the
# flat planner
CLASSIFY_STATS = {"calls": 0, "pairs": 0, "jobs": 0, "start_jobs": 0, "seconds": 0.0,
                  "plan_s": 0.0}
SLAB_PAIRS = 1 << 20  # pairs planned at once: below the flat plan's 2^21-job key field


def align_pairs_nm_indexed(
    queries: list[bytes], targets: list[bytes],
    qi: np.ndarray, ti: np.ndarray, band: int | None = None, *, device,
    groups: np.ndarray | None = None,
) -> list[Mapping | None]:
    """The classify route: per pair k, the best alignment of
    (queries[qi[k]], targets[ti[k]]) on `device` as a Mapping (target_id 0),
    or None where no job aligned.

    Score, NM and ends come from kernel 1 in NM mode over every job of the
    flat plan (_plan_soa_indexed); a pair's best job is its highest score,
    the earliest plan job on ties (align_pairs_nm's rule).  Real query and
    target starts are computed for the hits classify writes: per group
    (groups[k]; by default every pair is its own), the aligned pairs whose
    NM equals that of the group's first highest-scoring pair.  Only their
    winning jobs run again, through kernel 1 in payload mode and kernel 2;
    every other pair is reported as run_jobs_nm reports it, its oriented
    starts 0.  On the pairs with
    starts this equals the JAX package's host align_pairs_nm_indexed(...,
    coords=True) in every field classify reads, and on every pair in score,
    NM and ends.  The pairs are independent, so one call over many groups
    gives what one call per group gives."""
    stats = CLASSIFY_STATS
    stats["calls"] += 1
    stats["pairs"] += len(qi)
    with span(None, stats, "seconds"):
        return _classify_route(queries, targets, qi, ti, band, device, groups, stats)


def classify_nm_slabs(queries, targets, qi, ti, band: int, dev, stats=None):
    """The classify route's plan: per slab of SLAB_PAIRS pairs, yield (the
    slab's first pair, its flat plan, the plan's pools on `dev`) for every
    slab with at least one job.  The planner's seconds add to
    stats["plan_s"] where stats is given."""
    from ..parallel.mesh import _build_target_pool

    for s in range(0, len(qi), SLAB_PAIRS):
        e = min(s + SLAB_PAIRS, len(qi))
        uq, qi2 = np.unique(qi[s:e], return_inverse=True)
        ut, ti2 = np.unique(ti[s:e], return_inverse=True)
        t_sub = [targets[i] for i in ut.tolist()]
        with span(None, {} if stats is None else stats, "plan_s"):
            plan = _plan_soa_indexed([queries[i] for i in uq.tolist()], t_sub,
                                     qi2.astype(np.int64), ti2.astype(np.int64), band)
        if plan is None:
            raise ValueError("classify route: the pairs lie outside the flat planner's key "
                             "widths (a sequence of 16 kb or more), or its native library "
                             "did not build")
        if plan != "empty":
            yield s, plan, plan_to_device(plan, *_build_target_pool(t_sub), dev)


def classify_nm_launches(plan, dp: dict, band: int, dev):
    """Kernel 1's NM-mode launches over one slab's jobs, in the route's
    length chunks: yield per launch its job rows (on `dev`) and its inputs
    (q, t, lo, tlens)."""
    for sel in length_chunks_lens(plan[6], band, payload=False):
        sel_t = torch.from_numpy(sel).to(dev)
        yield sel_t, plan_tensors(dp, sel_t)


def _classify_route(queries, targets, qi, ti, band, device, groups, stats):
    band = resolve_band(band)
    dev = resolve_device(device)
    qi = np.asarray(qi, dtype=np.int64)
    ti = np.asarray(ti, dtype=np.int64)
    n = len(qi)
    groups = np.arange(n, dtype=np.int64) if groups is None else np.asarray(groups, np.int64)

    # 1. per slab of pairs: the flat plan, its pools on the device, kernel 1
    #    (NM mode) over every job, one fetch
    slabs = []  # (plan, device pools, first job's global index)
    cols: dict[str, list[np.ndarray]] = {k: [] for k in ("owner", "st", "fql", "out")}
    n_jobs = 0
    for s, plan, dp in classify_nm_slabs(queries, targets, qi, ti, band, dev, stats):
        owner_j, uq_j, st_j, qlens_all = plan[0], plan[1], plan[2], plan[12]
        out = torch.empty((len(owner_j), 4), dtype=torch.int32, device=dev)
        for sel_t, tensors in classify_nm_launches(plan, dp, band, dev):
            out[sel_t] = sw_forward(*tensors, band)
        slabs.append((plan, dp, n_jobs))
        cols["owner"].append(owner_j + s)
        cols["st"].append(st_j)
        cols["fql"].append(qlens_all[uq_j])
        cols["out"].append(out.cpu().numpy())  # [score, q_end, t_end, nm]
        n_jobs += len(owner_j)
    stats["jobs"] += n_jobs
    best: list[Mapping | None] = [None] * n
    if not n_jobs:
        return best
    owner, st, fql, out = (np.concatenate(cols[k]) for k in ("owner", "st", "fql", "out"))
    score = out[:, 0].astype(np.int64)

    # 2. per pair its winning job; per group the hits that need starts
    win = np.full(n, -1, dtype=np.int64)
    ok = np.flatnonzero(score > 0)
    if len(ok) == 0:
        return best
    sel = ok[np.lexsort((ok, -score[ok], owner[ok]))]
    first = sel[np.concatenate(([True], owner[sel][1:] != owner[sel][:-1]))]
    win[owner[first]] = first
    aligned = np.flatnonzero(win >= 0)
    w_score, w_nm = score[win[aligned]], out[win[aligned], 3]
    lead = np.lexsort((aligned, -w_score, groups[aligned]))
    g_sorted = groups[aligned][lead]
    g_first = lead[np.concatenate(([True], g_sorted[1:] != g_sorted[:-1]))]
    lead_nm = dict(zip(groups[aligned][g_first].tolist(), w_nm[g_first].tolist()))
    need = w_nm == np.fromiter((lead_nm[g] for g in groups[aligned].tolist()), np.int64,
                               len(aligned))
    start_jobs = win[aligned[need]]
    stats["start_jobs"] += len(start_jobs)

    # 3. the starts: kernel 1 (payload mode) + kernel 2 on those jobs only
    starts = {}
    bases = np.array([b for _, _, b in slabs] + [n_jobs])
    slab_of = np.searchsorted(bases, start_jobs, side="right") - 1
    for si, (plan, dp, base) in enumerate(slabs):
        jobs = start_jobs[slab_of == si]
        if not len(jobs):
            continue
        local = jobs - base
        for part in length_chunks_lens(plan[6][local], band, payload=True):
            sel_t = torch.from_numpy(local[part]).to(dev)
            q, t, lo, tl = plan_tensors(dp, sel_t)
            payload, p_score, ri, bj = sw_forward(q, t, lo, tl, band, emit_payload=True)
            walk = walk_rle_launch if dev.type == "cuda" else walk_rle
            _cigar, meta = walk(payload, lo, p_score, ri, bj, band, q.shape[1] + t.shape[1])
            for j, m in zip(jobs[part].tolist(), meta.cpu().numpy().tolist()):
                starts[j] = m  # [n_runs, q0, q1, t0, t1, nm]

    for k in aligned.tolist():
        j = int(win[k])
        s_, q1, t1, nm = (int(v) for v in out[j])
        q0 = t0 = 0
        if j in starts:
            _n, q0, wq1, t0, wt1, wnm = starts[j]
            if (wq1, wt1, wnm) != (q1, t1, nm):
                raise RuntimeError(f"classify route: kernel 1's payload-mode walk ends at "
                                   f"{(wq1, wt1, wnm)}, its NM mode at {(q1, t1, nm)}")
        strand = int(st[j])
        if strand == 1:
            fq0, fq1 = q0, q1
        else:
            fq0, fq1 = int(fql[j]) - q1, int(fql[j]) - q0
        best[k] = Mapping(target_id=0, strand=strand, query_start=fq0, query_end=fq1,
                          target_start=t0, target_end=t1, nm=nm, cigar=[], score=s_)
    return best


def _jobs_to_mappings(jobs: list[AlignJob], raw: list[tuple | None]) -> list[Mapping]:
    out = []
    for job, r in zip(jobs, raw):
        if r is None:
            continue
        score, q0, q1, t0, t1, cigar, nm = r
        if job.strand == 1:
            fq0, fq1 = q0, q1
        else:
            fq0, fq1 = job.fwd_qlen - q1, job.fwd_qlen - q0
        out.append(
            Mapping(
                target_id=job.target_id, strand=job.strand, query_start=fq0,
                query_end=fq1, target_start=t0, target_end=t1, nm=nm,
                cigar=cigar, score=score,
            )
        )
    return out


def map_batch(
    index: TargetIndex,
    queries: list[bytes | np.ndarray],
    band: int | None = None,
    min_anchors: int = 3,
    max_hits: int | None = None,
    no_diag: bool = False,
    *,
    device,
) -> list[list[Mapping]]:
    """Map many queries against one index with batched DP on `device`.

    Returns per query a hit list sorted like align.map_query (best first,
    one per target, mapq>0 iff unique best)."""
    with part("plan"):
        all_jobs, job_owner = plan_jobs_batch(
            index, [bytes(q) if isinstance(q, (bytes, bytearray)) else np.asarray(q, dtype=np.uint8).tobytes() for q in queries],
            band=band, min_anchors=min_anchors, no_diag=no_diag,
        )
    raw = run_jobs(all_jobs, band=band, device=device)

    results: list[list[Mapping]] = []
    with part("map"):
        per_query: dict[int, list[tuple[AlignJob, tuple]]] = {}
        for owner, job, r in zip(job_owner, all_jobs, raw):
            if r is not None:
                per_query.setdefault(owner, []).append((job, r))

        for qi in range(len(queries)):
            pairs = per_query.get(qi, [])
            best_by_target: dict[int, Mapping] = {}
            for job, r in pairs:
                (m,) = _jobs_to_mappings([job], [r]) or (None,)
                if m is None:
                    continue
                prev = best_by_target.get(m.target_id)
                if prev is None or m.score > prev.score:
                    best_by_target[m.target_id] = m
            hits = sorted(best_by_target.values(), key=lambda m: (-m.score, m.target_id))
            for i, m in enumerate(hits):
                m.is_primary = i == 0
                m.mapq = 60 if (i == 0 and (len(hits) < 2 or hits[1].score < m.score)) else 0
            if max_hits is not None:
                hits = hits[:max_hits]
            results.append(hits)
    return results


def _plan_pairs(pairs: list[tuple[bytes, bytes]], band: int) -> tuple[list[AlignJob], list[int]]:
    """Plan independent pairs: group queries by unique target so each target
    is indexed once and its queries planned in one batch.  The part
    "plan"."""
    with part("plan"):
        groups: dict[bytes, tuple[TargetIndex, list[int]]] = {}
        for i, (qa, ta) in enumerate(pairs):
            tb = bytes(ta) if isinstance(ta, (bytes, bytearray)) else np.asarray(ta, dtype=np.uint8).tobytes()
            g = groups.get(tb)
            if g is None:
                g = (TargetIndex([tb]), [])
                groups[tb] = g
            g[1].append(i)
        all_jobs: list[AlignJob] = []
        owner: list[int] = []
        for idx, pair_ids in groups.values():
            qbytes = [
                bytes(pairs[i][0]) if isinstance(pairs[i][0], (bytes, bytearray)) else np.asarray(pairs[i][0], dtype=np.uint8).tobytes()
                for i in pair_ids
            ]
            jobs, owners_local = plan_jobs_batch(idx, qbytes, band=band, min_anchors=2)
            all_jobs.extend(jobs)
            owner.extend(pair_ids[o] for o in owners_local)
    return all_jobs, owner
