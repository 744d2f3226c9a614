"""The host oracle of the port's DP: banded affine Smith-Waterman over
planner jobs on the CPU, in C++ (native/swalign.cpp) with a vectorised
NumPy fallback.

It computes what kernels 1 and 2 compute, and the tests and chip_smoke.py
hold the kernels against it.  The port's traceback route re-runs on it the
rare pair whose CIGAR overflows the kernel's run buffer (traceback_torch),
as the reference route does.  A pipeline run never takes it for its DP:
the consumers in align_batch send every job to the device routes.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from .align import GAP_EXT, GAP_OPEN, MATCH, MISMATCH, _traceback
from .native_build import get_lib

if TYPE_CHECKING:
    from .align_batch import AlignJob

NEG = -20000  # int16-safe sentinel


def _run_bucket(jobs: list[AlignJob], band: int) -> list[tuple | None]:
    """Vectorized DP over a bucket of jobs with equal padded dims."""
    B = len(jobs)
    Lq = max(len(j.qcodes) for j in jobs)
    q = np.full((B, Lq), 5, dtype=np.uint8)  # 5 = padding, never matches
    tmaxlen = max(len(j.tcodes) for j in jobs)
    t = np.full((B, tmaxlen), 6, dtype=np.uint8)
    lo = np.zeros((B, Lq + 1), dtype=np.int64)
    tlens = np.zeros(B, dtype=np.int64)
    for i, j in enumerate(jobs):
        q[i, : len(j.qcodes)] = j.qcodes
        t[i, : len(j.tcodes)] = j.tcodes
        lo[i, 1 : len(j.lo) + 1] = j.lo
        lo[i, 0] = j.lo[0]
        if len(j.lo) < Lq:
            lo[i, len(j.lo) + 1 :] = j.lo[-1]
        tlens[i] = len(j.tcodes)

    H = np.zeros((B, Lq + 1, band), dtype=np.int16)
    E = np.full((B, Lq + 1, band), NEG, dtype=np.int16)
    F = np.full((B, Lq + 1, band), NEG, dtype=np.int16)
    G = np.zeros((B, Lq + 1, band), dtype=np.int16)

    je = np.arange(band, dtype=np.int64)
    bi = np.arange(B)[:, None]
    ooe = GAP_OPEN + GAP_EXT

    for r in range(1, Lq + 1):
        l = lo[:, r]
        dl = l - lo[:, r - 1]
        cols = l[:, None] + je[None, :]
        valid = cols < tlens[:, None]
        tc = t[bi, np.minimum(cols, tlens[:, None] - 1)]
        qc = q[:, r - 1][:, None]
        s = np.where((tc == qc) & (qc < 4) & (tc < 4), MATCH, MISMATCH).astype(np.int16)

        src = je[None, :] + dl[:, None]
        in_rng = src < band
        src_cl = np.minimum(src, band - 1)
        Hup = np.where(in_rng, H[bi, r - 1, src_cl], NEG)
        Fup = np.where(in_rng, F[bi, r - 1, src_cl], NEG)
        srcd = src - 1
        d_in = (srcd >= 0) & (srcd < band)
        srcd_cl = np.clip(srcd, 0, band - 1)
        Hdiag = np.where(d_in, H[bi, r - 1, srcd_cl], NEG).astype(np.int32)
        # left-of-band diagonal is the free zero boundary only at column 0
        left_edge = (srcd < 0) & (cols == 0)
        Hdiag = np.where(left_edge, 0, Hdiag)

        Fr = np.maximum(Hup.astype(np.int32) - GAP_OPEN, Fup.astype(np.int32)) - GAP_EXT
        Fr = np.maximum(Fr, NEG)
        Gr = np.maximum(np.maximum(0, Hdiag + s), Fr)
        run = np.maximum.accumulate(Gr + GAP_EXT * je[None, :], axis=1)
        Er = np.full((B, band), NEG, dtype=np.int32)
        Er[:, 1:] = run[:, :-1] - ooe - GAP_EXT * je[None, 1:] + GAP_EXT
        Er = np.maximum(Er, NEG)
        Hr = np.maximum(Gr, Er)
        Hr = np.where(valid, Hr, NEG)
        Gr = np.where(valid, Gr, NEG)
        H[:, r] = Hr.astype(np.int16)
        E[:, r] = Er.astype(np.int16)
        F[:, r] = Fr.astype(np.int16)
        G[:, r] = Gr.astype(np.int16)

    out = []
    for i, job in enumerate(jobs):
        m = len(job.qcodes)
        Hi = H[i, 1 : m + 1]
        flat = int(np.argmax(Hi))
        ri, bj = divmod(flat, band)
        ri += 1
        score = int(Hi[ri - 1, bj])
        if score <= 0:
            out.append(None)
            continue
        lo_full = lo[i, : m + 1]
        out.append(
            _traceback(
                H[i, : m + 1].astype(np.int32),
                E[i, : m + 1].astype(np.int32),
                F[i, : m + 1].astype(np.int32),
                G[i, : m + 1].astype(np.int32),
                lo_full,
                job.qcodes,
                job.tcodes,
                ri,
                bj,
                score,
            )
        )
    return out


def _pack_seqs(arrs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate code arrays with object-identity dedup: jobs share qcodes
    (per-(query, strand) cache) and tcodes (index.targets), so e.g. stage-7
    packs 8 unique ASV targets once instead of one 1.5kb copy per job.
    Returns (cat, off (B,) i64, lens (B,) i32)."""
    B = len(arrs)
    off = np.empty(B, dtype=np.int64)
    lens = np.empty(B, dtype=np.int32)
    seen: dict[int, tuple[int, int]] = {}
    parts: list[np.ndarray] = []
    total = 0
    for i, arr in enumerate(arrs):
        got = seen.get(id(arr))
        if got is None:
            a = np.asarray(arr, dtype=np.uint8)
            parts.append(a)
            got = (total, len(a))
            seen[id(arr)] = got
            total += len(a)
        off[i], lens[i] = got
    cat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return cat, off, lens


def _run_native(jobs: list[AlignJob], band: int, lib, n_threads: int = 0,
                simd: bool = True) -> list[tuple | None]:
    """Route jobs through the C++ kernel (native/swalign.cpp): the
    inter-pair SIMD traceback batch (sw_tb_batch) when int16 coordinates
    fit, else the per-pair kernel — identical results either way."""
    import ctypes

    B = len(jobs)
    use_simd = simd and not any(
        len(j.qcodes) > 32000 or len(j.tcodes) > 32000 for j in jobs
    )
    if use_simd:
        # length-sort so PBLK lane blocks have similar padded heights
        order = sorted(range(B), key=lambda i: len(jobs[i].qcodes))
        sjobs = [jobs[i] for i in order]
    else:
        order = list(range(B))
        sjobs = jobs
    q_cat, q_off, q_lens = _pack_seqs([j.qcodes for j in sjobs])
    t_cat, t_off, t_lens = _pack_seqs([j.tcodes for j in sjobs])

    max_cigar = 512
    out_meta = np.zeros((B, 8), dtype=np.int32)
    out_cigar = np.zeros((B, max_cigar), dtype=np.uint32)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    if use_simd:
        # raw planner lo, len q_len per pair; per-JOB offsets (q_off may
        # point shared/deduped queries, but every job has its own lo)
        lo_cat = np.ascontiguousarray(np.concatenate([j.lo for j in sjobs]), dtype=np.int32)
        lo_off = np.concatenate(([0], np.cumsum(q_lens[:-1], dtype=np.int64)))
        lib.sw_tb_batch(
            ptr(q_cat, ctypes.c_uint8), ptr(q_off, ctypes.c_int64), ptr(q_lens, ctypes.c_int32),
            ptr(t_cat, ctypes.c_uint8), ptr(t_off, ctypes.c_int64), ptr(t_lens, ctypes.c_int32),
            ptr(lo_cat, ctypes.c_int32), ptr(lo_off, ctypes.c_int64),
            ctypes.c_int32(B), ctypes.c_int32(band),
            ptr(out_meta, ctypes.c_int32), ptr(out_cigar, ctypes.c_uint32),
            ctypes.c_int32(max_cigar), ctypes.c_int32(n_threads),
        )
    else:
        lo_parts, lo_lens = [], []
        for j in sjobs:
            lo_full = np.concatenate(([j.lo[0]], j.lo)).astype(np.int32)
            lo_parts.append(lo_full)
            lo_lens.append(len(lo_full))
        lo_cat = np.concatenate(lo_parts)
        lo_off = np.concatenate(([0], np.cumsum(lo_lens[:-1]))).astype(np.int64)
        lib.sw_banded_batch(
            ptr(q_cat, ctypes.c_uint8), ptr(q_off, ctypes.c_int64), ptr(q_lens, ctypes.c_int32),
            ptr(t_cat, ctypes.c_uint8), ptr(t_off, ctypes.c_int64), ptr(t_lens, ctypes.c_int32),
            ptr(lo_cat, ctypes.c_int32), ptr(lo_off, ctypes.c_int64),
            ctypes.c_int32(B), ctypes.c_int32(band),
            ptr(out_meta, ctypes.c_int32), ptr(out_cigar, ctypes.c_uint32),
            ctypes.c_int32(max_cigar), ctypes.c_int32(n_threads),
        )

    results: list[tuple | None] = [None] * B
    for si, i in enumerate(order):
        score, q0, q1, t0, t1, nm, clen, overflow = (int(x) for x in out_meta[si])
        if score <= 0:
            continue
        if overflow:
            # extremely fragmented alignment: redo on the NumPy path
            results[i] = _run_bucket([jobs[i]], band)[0]
            continue
        results[i] = (score, q0, q1, t0, t1, out_cigar[si, :clen].copy(), nm)
    return results


def _run_native_nm(jobs: list[AlignJob], band: int, lib) -> list[tuple | None]:
    """NM-only jobs through the inter-pair SIMD forward kernel (sw_nm_batch):
    no matrices, no traceback, metadata carried along winning paths — the C++
    twin of align_jax.sw_forward_meta (same tie rules, same results)."""
    import ctypes

    B = len(jobs)
    # int16 metadata planes: fall back to the traceback kernel on huge seqs
    if any(len(j.qcodes) > 32000 or len(j.tcodes) > 32000 for j in jobs):
        return _run_native(jobs, band, lib)
    # sort by query length so PBLK blocks have similar padded heights
    order = sorted(range(B), key=lambda i: len(jobs[i].qcodes))
    sjobs = [jobs[i] for i in order]
    q_cat, q_off, q_lens = _pack_seqs([j.qcodes for j in sjobs])
    t_cat, t_off, t_lens = _pack_seqs([j.tcodes for j in sjobs])
    # raw planner lo (len q_len per pair); per-JOB offsets (q_off may point
    # shared/deduped queries, but every job has its own lo)
    lo_cat = np.ascontiguousarray(
        np.concatenate([j.lo for j in sjobs]), dtype=np.int32
    )
    lo_off = np.concatenate(([0], np.cumsum(q_lens[:-1], dtype=np.int64)))
    out_meta = np.zeros((B, 6), dtype=np.int32)

    def ptr(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    lib.sw_nm_batch(
        ptr(q_cat, ctypes.c_uint8), ptr(q_off, ctypes.c_int64), ptr(q_lens, ctypes.c_int32),
        ptr(t_cat, ctypes.c_uint8), ptr(t_off, ctypes.c_int64), ptr(t_lens, ctypes.c_int32),
        ptr(lo_cat, ctypes.c_int32), ptr(lo_off, ctypes.c_int64),
        ctypes.c_int32(B), ctypes.c_int32(band),
        ptr(out_meta, ctypes.c_int32), ctypes.c_int32(0),
    )
    results: list[tuple | None] = [None] * B
    for si, i in enumerate(order):
        score, q0, q1, t0, t1, nm = (int(x) for x in out_meta[si])
        if score > 0:
            results[i] = (score, q0, q1, t0, t1, [], nm)
    return results


def run_jobs_host(jobs: list[AlignJob], band: int) -> list[tuple | None]:
    """Per job (score, q0, q1, t0, t1, cigar_u32, nm) or None: the C++
    traceback kernel, in length-sorted slabs of 8,192 jobs, or the NumPy
    buckets where no compiler is available.  Both give identical results."""
    if not jobs:
        return []
    lib = get_lib()
    order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
    results: list[tuple | None] = [None] * len(jobs)
    step = 8192 if lib is not None else 64
    for start in range(0, len(order), step):
        chunk = order[start : start + step]
        cjobs = [jobs[i] for i in chunk]
        res = _run_native(cjobs, band, lib) if lib is not None else _run_bucket(cjobs, band)
        for i, r in zip(chunk, res):
            results[i] = r
    return results


def run_jobs_nm_host(jobs: list[AlignJob], band: int) -> list[tuple | None]:
    """Per job (score, q0, q1, t0, t1, [], nm) or None: the C++ NM-only
    forward kernel, or the traceback path where no compiler is available."""
    if not jobs:
        return []
    lib = get_lib()
    if lib is not None:
        return _run_native_nm(jobs, band, lib)
    return run_jobs_host(jobs, band)
