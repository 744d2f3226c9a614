"""ctypes wrapper for native/kmerscan.cpp (batched per-read scans)."""
from __future__ import annotations

import ctypes

import numpy as np

from .native_build import build_extra

_LIB = None
_TRIED = False


def get_scan_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = build_extra("kmerscan", extra_link=["-fopenmp"])
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.split_kmers_batch.restype = None
    lib.split_kmers_batch.argtypes = [
        u8p, u8p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        u64p, i64p, i64p, ctypes.c_int,
    ]
    lib.syncmer_scan_batch.restype = None
    lib.syncmer_scan_batch.argtypes = [
        u8p, u8p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u64p, ctypes.c_int64,
        u32p, u64p, u32p, u64p,
        i64p, i64p, i64p, ctypes.c_int,
    ]
    lib.window_minimizers_batch.restype = None
    lib.window_minimizers_batch.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        u64p, i64p, u8p, i64p, i64p, ctypes.c_int,
    ]
    lib.minimizer_sketch_batch.restype = None
    lib.minimizer_sketch_batch.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        u64p, u64p, i64p, i64p, ctypes.c_int,
    ]
    lib.chain_band_batch.restype = None
    lib.chain_band_batch.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, i64p, i64p,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), i64p, i64p, ctypes.c_int,
    ]
    lib.lsh_batch.restype = None
    lib.lsh_batch.argtypes = [
        u64p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        u64p, u8p, ctypes.c_int,
    ]
    lib.lsh_greedy_cluster.restype = None
    lib.lsh_greedy_cluster.argtypes = [
        u64p, u8p, ctypes.c_int, u64p, i64p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int, i64p,
    ]
    lib.snpmer_greedy_subcluster.restype = None
    lib.snpmer_greedy_subcluster.argtypes = [
        u64p, i64p, ctypes.c_int64, ctypes.c_uint64, i64p,
    ]
    lib.kmer_at_positions_batch.restype = None
    lib.kmer_at_positions_batch.argtypes = [
        u8p, i64p, ctypes.c_int64, u32p, i64p, ctypes.c_int, u64p, ctypes.c_int,
    ]
    lib.snpmer_join_count.restype = None
    lib.snpmer_join_count.argtypes = [
        u64p, u64p, i64p, ctypes.c_int64, u64p, u64p, i64p,
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int,
    ]
    lib.solid_filter_batch.restype = None
    lib.solid_filter_batch.argtypes = [
        u64p, i64p, u64p, i64p, ctypes.c_int64, u64p, ctypes.c_int64,
        ctypes.c_int64, u8p, u8p, ctypes.c_int,
    ]
    lib.gather_ranges.restype = None
    lib.gather_ranges.argtypes = [
        u8p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u8p,
        ctypes.c_int,
    ]
    lib.revcomp_codes_ranges.restype = None
    lib.revcomp_codes_ranges.argtypes = [
        u8p, i64p, ctypes.c_int64, u8p, ctypes.c_int,
    ]
    lib.gather_ptr_ranges.restype = None
    lib.gather_ptr_ranges.argtypes = [
        u64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int,
    ]
    lib.recluster_round.restype = ctypes.c_int64
    lib.recluster_round.argtypes = [
        i64p, i64p, ctypes.c_int64, u64p, i64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, i64p, ctypes.c_int,
    ]
    lib.consensus_batch.restype = ctypes.c_int64
    lib.consensus_batch.argtypes = [
        i64p, i64p, ctypes.c_int64, u64p, i64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, u64p, u64p, i64p,
        ctypes.c_int,
    ]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.qual_fields_batch.restype = None
    lib.qual_fields_batch.argtypes = [
        u8p, i64p, ctypes.c_int64, f64p, u8p, u8p, i64p, f64p, ctypes.c_int,
    ]
    lib.pure_acgt_batch.restype = None
    lib.pure_acgt_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64p, ctypes.c_int64, u8p,
        ctypes.c_int,
    ]
    lib.sort_unique_batch.restype = None
    lib.sort_unique_batch.argtypes = [
        u64p, i64p, ctypes.c_int64, u64p, i64p, i64p, ctypes.c_int,
    ]
    lib.mini_mask_join.restype = None
    lib.mini_mask_join.argtypes = [
        u64p, u64p, ctypes.c_int64, u64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int, i64p, ctypes.c_int,
    ]
    _LIB = lib
    return _LIB


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


_PYH = None
_PYH_TRIED = False


def _pyhelpers():
    """native/pyhelpers.so via ctypes.PyDLL (GIL held -> PyObject*-safe).
    None when the CPython/numpy headers or compiler are unavailable."""
    global _PYH, _PYH_TRIED
    if _PYH_TRIED:
        return _PYH
    _PYH_TRIED = True
    import sysconfig

    from .native_build import build_extra

    so = build_extra(
        "pyhelpers",
        extra_cflags=[
            f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
        ],
    )
    if so is None:
        return None
    try:
        lib = ctypes.PyDLL(str(so))
    except OSError:
        return None
    lib.pyh_init.restype = ctypes.c_int
    if lib.pyh_init() != 0:
        ctypes.pythonapi.PyErr_Clear()
        return None
    lib.pyh_span_probe.restype = ctypes.c_int
    lib.pyh_span_probe.argtypes = [ctypes.py_object, ctypes.POINTER(ctypes.c_int64)]
    _PYH = lib
    return lib


def _parent_span(arrays: list[np.ndarray]) -> np.ndarray | None:
    """If the arrays are consecutive contiguous views into one parent buffer
    (the _batch_encode layout), return the covering parent slice — no copy.
    Returns None when any array breaks the pattern."""
    if not arrays:
        return None
    lib = _pyhelpers()
    if lib is not None:
        # C probe: one pass at ~15 ns/array (the Python loop paid ~1.2 us
        # per data-pointer access); same pattern checks, same result
        out = (ctypes.c_int64 * 3)()
        if not lib.pyh_span_probe(arrays, out):
            return None
        base = arrays[0].base
        b0 = base.__array_interface__["data"][0]
        item = int(out[2])
        lo = (int(out[0]) - b0) // item
        return base[lo : lo + (int(out[1]) - int(out[0])) // item]
    base = arrays[0].base
    if not isinstance(base, np.ndarray) or base.ndim != 1:
        return None  # no base, or a non-ndarray base (e.g. np.frombuffer(bytes))
    item = arrays[0].itemsize
    pos = arrays[0].__array_interface__["data"][0]
    start = pos
    for a in arrays:
        if a.base is not base or a.__array_interface__["data"][0] != pos or not a.flags.c_contiguous:
            return None
        pos += a.nbytes
    b0 = base.__array_interface__["data"][0]
    lo = (start - b0) // item
    return base[lo : lo + (pos - start) // item]


def _concat(reads: list[np.ndarray], phreds) -> tuple:
    off = np.empty(len(reads) + 1, dtype=np.int64)
    off[0] = 0
    np.cumsum(np.fromiter((len(r) for r in reads), np.int64, len(reads)), out=off[1:])
    span = _parent_span(reads) if reads else None
    if span is not None and span.dtype == np.uint8:
        codes = span
    elif reads:
        codes = np.empty(int(off[-1]), dtype=np.uint8)
        np.concatenate(reads, out=codes, casting="unsafe")
    else:
        codes = np.zeros(0, np.uint8)
    ph = None
    if phreds is not None and any(p is not None for p in phreds):
        if all(p is not None for p in phreds):
            pspan = _parent_span(phreds)
            if pspan is not None and pspan.dtype == np.uint8:
                ph = pspan  # zero-copy: already the uint8 parent slice
            elif pspan is not None:
                # one fused pass over the parent slice (no concatenate)
                ph = np.clip(pspan, 0, 255).astype(np.uint8)
            elif phreds[0].dtype == np.uint8:
                ph = np.empty(int(off[-1]), dtype=np.uint8)
                np.concatenate(phreds, out=ph)
            else:
                # one concatenate + one clip instead of a per-read loop
                flat = np.empty(int(off[-1]), dtype=np.int64)
                np.concatenate(phreds, out=flat, casting="unsafe")
                ph = np.clip(flat, 0, 255).astype(np.uint8)
        else:
            ph = np.empty(int(off[-1]), dtype=np.uint8)
            for i, p in enumerate(phreds):
                if p is not None:
                    ph[off[i] : off[i] + len(p)] = np.clip(p, 0, 255)
                else:
                    # reads without qualities: mark all-equal so gates disable
                    ph[off[i] : off[i + 1]] = 60
    return codes, ph, off


import threading

_SCRATCH_TLS = threading.local()  # per-thread: slab pipelining runs scan
_CHUNK_CAP = 8 << 20  # max scratch entries per scan chunk (u64 -> 64 MB)
# kernels concurrently (align_batch), and a shared buffer would race


def _scratch(tag: str, n: int, dtype) -> np.ndarray:
    """Reusable scratch buffer: the scan kernels write prefix regions into
    oversized capacity buffers that never escape (outputs are compacted),
    so one warm buffer per tag avoids re-faulting hundreds of MB of fresh
    pages on every call.  Thread-local: concurrent callers get their own."""
    store = getattr(_SCRATCH_TLS, "bufs", None)
    if store is None:
        store = _SCRATCH_TLS.bufs = {}
    dt = np.dtype(dtype)
    need = int(n) * dt.itemsize
    buf = store.get(tag)
    if buf is None or buf.nbytes < need:
        buf = np.empty(need, dtype=np.uint8)
        store[tag] = buf
    return buf[:need].view(dt)


def _chunk_spans(reads: list, k: int) -> list[tuple[int, int]]:
    """Split a read list into spans whose total scratch capacity stays under
    _CHUNK_CAP entries (so scan scratch is bounded at any input scale)."""
    spans = []
    i, n = 0, len(reads)
    while i < n:
        j, cap = i, 0
        while j < n:
            c = max(len(reads[j]) - k + 1, 0)
            if j > i and cap + c > _CHUNK_CAP:
                break
            cap += c
            j += 1
        spans.append((i, j))
        i = j
    return spans


def _compact(buf: np.ndarray, src_off: np.ndarray, cnt: np.ndarray,
             threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pack the per-read prefix regions of an oversized scratch buffer into
    one exact-size array (native memcpy sweep).  Returns (dense, dst_off)."""
    lib = get_scan_lib()
    dst_off = np.empty(len(cnt) + 1, dtype=np.int64)
    dst_off[0] = 0
    np.cumsum(cnt, out=dst_off[1:])
    dense = np.empty(int(dst_off[-1]), dtype=buf.dtype)
    lib.gather_ranges(
        buf.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _ptr(np.ascontiguousarray(src_off[: len(cnt)], np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(cnt, np.int64), ctypes.c_int64),
        _ptr(dst_off, ctypes.c_int64), len(cnt), buf.dtype.itemsize,
        dense.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads,
    )
    return dense, dst_off


def gather_ptr_ranges_native(
    ptrs: np.ndarray, cnt: np.ndarray, dst_off: np.ndarray,
    dst: np.ndarray, threads: int = 0,
) -> bool:
    """Scatter-gather memcpy from independently-allocated source ranges
    (raw data pointers, u64) into a dense array: range i (cnt[i] elements)
    lands at dst[dst_off[i]:].  The caller must keep every source array
    alive across the call.  Returns False without the native library."""
    lib = get_scan_lib()
    if lib is None or not hasattr(lib, "gather_ptr_ranges"):
        return False
    lib.gather_ptr_ranges(
        _ptr(np.ascontiguousarray(ptrs, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(cnt, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(dst_off, np.int64), ctypes.c_int64),
        len(cnt), dst.dtype.itemsize,
        dst.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads,
    )
    return True


def revcomp_codes_ranges_native(
    fcat: np.ndarray, off: np.ndarray, threads: int = 0
) -> np.ndarray | None:
    """Reverse-complement align-code ranges in one native sweep:
    out[off[i]:off[i+1]] = fcat range reversed with c<4 -> 3-c.  Returns
    None without the native library (caller keeps its NumPy gather)."""
    lib = get_scan_lib()
    if lib is None or not hasattr(lib, "revcomp_codes_ranges"):
        return None
    fcat = np.ascontiguousarray(fcat, np.uint8)
    off = np.ascontiguousarray(off, np.int64)
    out = np.empty(len(fcat), dtype=np.uint8)
    lib.revcomp_codes_ranges(
        _ptr(fcat, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
        len(off) - 1, _ptr(out, ctypes.c_uint8), threads,
    )
    return out


def _split(dense: np.ndarray, dst_off: np.ndarray) -> list[np.ndarray]:
    """Per-read views into a compact buffer (keeps one base alive; the
    buffer is exact-size so there is no oversized-scratch retention)."""
    return [dense[dst_off[i] : dst_off[i + 1]] for i in range(len(dst_off) - 1)]


def split_kmers_native(reads: list[np.ndarray], phreds, k: int, min_bq: int, threads: int = 0):
    """Batched split_kmer_mid over all reads; returns list of u64 arrays."""
    lib = get_scan_lib()
    assert lib is not None
    out_all: list[np.ndarray] = []
    for s, e in _chunk_spans(reads, k):
        sub = reads[s:e]
        codes, ph, off = _concat(sub, phreds[s:e] if phreds is not None else None)
        out_off = _capacity_offsets(sub, k)
        out = _scratch("split_out", int(out_off[-1]), np.uint64)
        cnt = np.zeros(len(sub), dtype=np.int64)
        lib.split_kmers_batch(
            _ptr(codes, ctypes.c_uint8),
            _ptr(ph, ctypes.c_uint8) if ph is not None else None,
            _ptr(off, ctypes.c_int64), len(sub), k, min_bq,
            _ptr(out, ctypes.c_uint64), _ptr(out_off, ctypes.c_int64),
            _ptr(cnt, ctypes.c_int64), threads,
        )
        dense, doff = _compact(out, out_off, cnt, threads)
        out_all.extend(_split(dense, doff))
    return out_all


def split_kmers_flat_native(
    reads: list[np.ndarray], phreds, k: int, min_bq: int, threads: int = 0
) -> np.ndarray:
    """split_kmers_native variant for stream consumers (global counting):
    returns ONE dense array of all emitted k-mers in read order, skipping
    the per-read view materialization entirely."""
    lib = get_scan_lib()
    assert lib is not None
    parts: list[np.ndarray] = []
    for s, e in _chunk_spans(reads, k):
        sub = reads[s:e]
        codes, ph, off = _concat(sub, phreds[s:e] if phreds is not None else None)
        out_off = _capacity_offsets(sub, k)
        out = _scratch("split_out", int(out_off[-1]), np.uint64)
        cnt = np.zeros(len(sub), dtype=np.int64)
        lib.split_kmers_batch(
            _ptr(codes, ctypes.c_uint8),
            _ptr(ph, ctypes.c_uint8) if ph is not None else None,
            _ptr(off, ctypes.c_int64), len(sub), k, min_bq,
            _ptr(out, ctypes.c_uint64), _ptr(out_off, ctypes.c_int64),
            _ptr(cnt, ctypes.c_int64), threads,
        )
        dense, _ = _compact(out, out_off, cnt, threads)
        parts.append(dense)
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint64)


def syncmer_scan_native(
    reads: list[np.ndarray], phreds, k: int, c: int, min_bq: int,
    snpmer_sorted: np.ndarray, threads: int = 0,
):
    """Batched syncmer+SNPmer scan; per read returns
    (mini_pos u32, mini_kmers u64, snp_pos u32, snp_kmers u64)."""
    mp, mk, sp, sk, m_off, s_off = syncmer_scan_flat_native(
        reads, phreds, k, c, min_bq, snpmer_sorted, threads
    )
    return [
        (
            mp[m_off[i] : m_off[i + 1]],
            mk[m_off[i] : m_off[i + 1]],
            sp[s_off[i] : s_off[i + 1]],
            sk[s_off[i] : s_off[i + 1]],
        )
        for i in range(len(reads))
    ]


def syncmer_scan_flat_native(
    reads: list[np.ndarray], phreds, k: int, c: int, min_bq: int,
    snpmer_sorted: np.ndarray, threads: int = 0,
):
    """Flat-pool syncmer+SNPmer scan: returns
    (mini_pos u32, mini_kmers u64, snp_pos u32, snp_kmers u64,
    m_off i64[n+1], s_off i64[n+1]) over all reads — stage 1.5 consumes the
    pools directly (per-read views, one solid-filter pass over the pools)
    instead of materializing 100k 4-array tuples."""
    lib = get_scan_lib()
    assert lib is not None
    if not reads:
        z64 = np.zeros(1, np.int64)
        return (np.zeros(0, np.uint32), np.zeros(0, np.uint64),
                np.zeros(0, np.uint32), np.zeros(0, np.uint64), z64, z64.copy())
    snp_sorted = np.ascontiguousarray(snpmer_sorted, dtype=np.uint64)
    parts: list[tuple] = []
    for s, e in _chunk_spans(reads, k):
        sub = reads[s:e]
        codes, ph, off = _concat(sub, phreds[s:e] if phreds is not None else None)
        out_off = _capacity_offsets(sub, k)
        total = int(out_off[-1])
        mini_pos = _scratch("sync_mp", total, np.uint32)
        mini_kmer = _scratch("sync_mk", total, np.uint64)
        snp_pos = _scratch("sync_sp", total, np.uint32)
        snp_kmer = _scratch("sync_sk", total, np.uint64)
        mini_cnt = np.zeros(len(sub), dtype=np.int64)
        snp_cnt = np.zeros(len(sub), dtype=np.int64)
        lib.syncmer_scan_batch(
            _ptr(codes, ctypes.c_uint8),
            _ptr(ph, ctypes.c_uint8) if ph is not None else None,
            _ptr(off, ctypes.c_int64), len(sub), k, c, min_bq,
            _ptr(snp_sorted, ctypes.c_uint64), len(snp_sorted),
            _ptr(mini_pos, ctypes.c_uint32), _ptr(mini_kmer, ctypes.c_uint64),
            _ptr(snp_pos, ctypes.c_uint32), _ptr(snp_kmer, ctypes.c_uint64),
            _ptr(out_off, ctypes.c_int64), _ptr(mini_cnt, ctypes.c_int64),
            _ptr(snp_cnt, ctypes.c_int64), threads,
        )
        mp, mp_off = _compact(mini_pos, out_off, mini_cnt, threads)
        mk, _ = _compact(mini_kmer, out_off, mini_cnt, threads)
        sp, sp_off = _compact(snp_pos, out_off, snp_cnt, threads)
        sk, _ = _compact(snp_kmer, out_off, snp_cnt, threads)
        parts.append((mp, mk, sp, sk, mp_off, sp_off))
    if len(parts) == 1:
        mp, mk, sp, sk, mp_off, sp_off = parts[0]
        return mp, mk, sp, sk, mp_off.astype(np.int64, copy=False), sp_off.astype(np.int64, copy=False)
    n = len(reads)
    mp = np.concatenate([p[0] for p in parts])
    mk = np.concatenate([p[1] for p in parts])
    sp = np.concatenate([p[2] for p in parts])
    sk = np.concatenate([p[3] for p in parts])
    m_off = np.zeros(n + 1, np.int64)
    s_off = np.zeros(n + 1, np.int64)
    pos = 0
    mbase = sbase = 0
    for p in parts:
        cn = len(p[4]) - 1
        m_off[pos + 1 : pos + cn + 1] = p[4][1:].astype(np.int64) + mbase
        s_off[pos + 1 : pos + cn + 1] = p[5][1:].astype(np.int64) + sbase
        mbase += int(p[4][-1])
        sbase += int(p[5][-1])
        pos += cn
    return mp, mk, sp, sk, m_off, s_off


def qual_fields_batch_native(
    flat: np.ndarray, off: np.ndarray, threads: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """eq flags + QualCompact3 levels + sequential error-prob sums for many
    ASCII quality strings in one native pass over the concatenated buffer
    (bit-exact twin of stage1_kmers._batched_qual_fields: the est sums use
    the strictly sequential order every Python path mirrors via np.cumsum).
    Returns (eq u8, levels_flat u8, lvl_off i64, est_sums f64) or None
    without the library."""
    from .encode import _ERR_PROB_LUT

    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(off) - 1
    lens = np.diff(off)
    nbins = (lens + 3) // 4
    lvl_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nbins, out=lvl_off[1:])
    eq = np.zeros(n, dtype=np.uint8)
    levels = np.empty(int(lvl_off[-1]), dtype=np.uint8)
    est_sums = np.empty(n, dtype=np.float64)
    lib.qual_fields_batch(
        _ptr(flat, ctypes.c_uint8), _ptr(np.ascontiguousarray(off, np.int64), ctypes.c_int64),
        n, _ptr(np.ascontiguousarray(_ERR_PROB_LUT), ctypes.c_double),
        _ptr(eq, ctypes.c_uint8),
        _ptr(levels, ctypes.c_uint8), _ptr(lvl_off, ctypes.c_int64),
        _ptr(est_sums, ctypes.c_double), threads,
    )
    return eq, levels, lvl_off, est_sums


def pure_acgt_batch_native(seqs: list[bytes], threads: int = 4) -> np.ndarray | None:
    """Per-read pure-uppercase-ACGT flags straight off the parsed bytes
    objects (ctypes packs the buffer pointers; no concatenation).  Returns
    bool[n] or None without the library."""
    lib = get_scan_lib()
    if lib is None or not hasattr(lib, "pure_acgt_batch"):
        return None
    n = len(seqs)
    ptrs = (ctypes.c_char_p * n)(*seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    out = np.empty(n, dtype=np.uint8)
    lib.pure_acgt_batch(
        ptrs, _ptr(lens, ctypes.c_int64), n, _ptr(out, ctypes.c_uint8), threads
    )
    return out.astype(bool)


def sort_unique_batch_flat_native(
    arrays: list[np.ndarray], threads: int = 4
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Per-array np.unique for many small u64 arrays in one threaded native
    call, flat form: array i's uniques live at flat[start[i] : start[i] +
    cnt[i]].  None without the library."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(arrays)
    lens = np.fromiter((len(a) for a in arrays), np.int64, n)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    flat = (
        np.ascontiguousarray(np.concatenate(arrays), dtype=np.uint64)
        if int(off[-1])
        else np.zeros(0, np.uint64)
    )
    out = np.empty(int(off[-1]), dtype=np.uint64)
    cnt = np.zeros(n, dtype=np.int64)
    lib.sort_unique_batch(
        _ptr(flat, ctypes.c_uint64), _ptr(off, ctypes.c_int64), n,
        _ptr(out, ctypes.c_uint64), _ptr(off, ctypes.c_int64),
        _ptr(cnt, ctypes.c_int64), threads,
    )
    return out, off[:-1], cnt


def mini_mask_join_native(
    keys: np.ndarray, masks: np.ndarray,
    q_flat: np.ndarray, q_start: np.ndarray, q_cnt: np.ndarray,
    n_asvs: int, threads: int = 0,
) -> np.ndarray | None:
    """Per-read shared-minimizer counts against <=64 ASV sets via one
    threaded bitmask join (exact twin of the unpackbits + segment-sum
    numpy formulation in stage7_em._all_snpmer_candidates).  Returns
    (n_reads, n_asvs) int64 counts, or None without the library."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n_reads = len(q_start)
    out = np.zeros((n_reads, n_asvs), dtype=np.int64)
    if len(keys) and n_reads:
        lib.mini_mask_join(
            _ptr(np.ascontiguousarray(keys, dtype=np.uint64), ctypes.c_uint64),
            _ptr(np.ascontiguousarray(masks, dtype=np.uint64), ctypes.c_uint64),
            len(keys),
            _ptr(q_flat, ctypes.c_uint64),
            _ptr(np.ascontiguousarray(q_start, dtype=np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(q_cnt, dtype=np.int64), ctypes.c_int64),
            n_reads, n_asvs, _ptr(out, ctypes.c_int64), threads,
        )
    return out


def _capacity_offsets(reads: list[np.ndarray], k: int) -> np.ndarray:
    """Per-read scratch capacities (len-k+1 each) as exclusive-scan offsets."""
    caps = np.fromiter((len(r) for r in reads), np.int64, len(reads)) - (k - 1)
    np.maximum(caps, 0, out=caps)
    out_off = np.empty(len(reads) + 1, dtype=np.int64)
    out_off[0] = 0
    np.cumsum(caps, out=out_off[1:])
    return out_off


def chain_band_native(
    qa: np.ndarray, ta: np.ndarray, grp_off: np.ndarray,
    qlen: np.ndarray, tlen: np.ndarray, band: int, min_anchors: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched anchor chaining + band-lo planning over groups of anchors
    pre-sorted by (group, qpos, tpos).  Returns (lo_flat, lo_off, nchain):
    group g's lo is lo_flat[lo_off[g] : lo_off[g] + qlen[g]] when
    nchain[g] >= min_anchors (0 marks a skipped group)."""
    lib = get_scan_lib()
    assert lib is not None
    n_groups = len(grp_off) - 1
    qa = np.ascontiguousarray(qa, dtype=np.int64)
    ta = np.ascontiguousarray(ta, dtype=np.int64)
    grp_off = np.ascontiguousarray(grp_off, dtype=np.int64)
    qlen = np.ascontiguousarray(qlen, dtype=np.int64)
    tlen = np.ascontiguousarray(tlen, dtype=np.int64)
    lo_off = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(qlen, out=lo_off[1:])
    # lo regions are only read for groups with nchain >= min_anchors, which
    # the kernel fully writes, so no zero-fill is needed
    lo_flat = np.empty(int(lo_off[-1]), dtype=np.int32)
    nchain = np.zeros(n_groups, dtype=np.int64)
    lib.chain_band_batch(
        _ptr(qa, ctypes.c_int64), _ptr(ta, ctypes.c_int64),
        _ptr(grp_off, ctypes.c_int64), n_groups,
        _ptr(qlen, ctypes.c_int64), _ptr(tlen, ctypes.c_int64),
        band, min_anchors,
        _ptr(lo_flat, ctypes.c_int32), _ptr(lo_off, ctypes.c_int64),
        _ptr(nchain, ctypes.c_int64), 0,
    )
    return lo_flat, lo_off, nchain


def window_minimizers_native(
    seqs: list[np.ndarray], k: int, w: int, threads: int = 0
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Batched canonical window minimizers over code-4 sequences; per sequence
    returns (hash u64, pos i64, is_fwd bool) — twin of _window_minimizers."""
    lib = get_scan_lib()
    assert lib is not None
    out_all: list[tuple] = []
    for s, e in _chunk_spans(seqs, k):
        sub = seqs[s:e]
        codes, _, off = _concat(sub, None)
        out_off = _capacity_offsets(sub, k)
        total = int(out_off[-1])
        oh = _scratch("wmin_h", total, np.uint64)
        op = _scratch("wmin_p", total, np.int64)
        of = _scratch("wmin_f", total, np.uint8)
        cnt = np.zeros(len(sub), dtype=np.int64)
        lib.window_minimizers_batch(
            _ptr(codes, ctypes.c_uint8), _ptr(off, ctypes.c_int64), len(sub), k, w,
            _ptr(oh, ctypes.c_uint64), _ptr(op, ctypes.c_int64), _ptr(of, ctypes.c_uint8),
            _ptr(out_off, ctypes.c_int64), _ptr(cnt, ctypes.c_int64), threads,
        )
        dh, doff = _compact(oh, out_off, cnt, threads)
        dp, _ = _compact(op, out_off, cnt, threads)
        df, _ = _compact(of, out_off, cnt, threads)
        df = df.view(bool)
        out_all.extend(
            (dh[doff[i] : doff[i + 1]], dp[doff[i] : doff[i + 1]], df[doff[i] : doff[i + 1]])
            for i in range(len(sub))
        )
    return out_all


def window_minimizers_flat_native(
    seqs: list[np.ndarray], k: int, w: int, threads: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flat batched canonical window minimizers: (hash u64, pos i64,
    is_fwd bool, off i64[n+1]) with minis of sequence i in [off[i], off[i+1]).
    Same native kernel as window_minimizers_native but no per-sequence
    Python tuples/views — for SoA consumers (the align planner pools the
    per-read tuples right back into flat arrays otherwise)."""
    lib = get_scan_lib()
    assert lib is not None
    hs, ps, fs, cnts = [], [], [], []
    for s, e in _chunk_spans(seqs, k):
        sub = seqs[s:e]
        codes, _, off = _concat(sub, None)
        out_off = _capacity_offsets(sub, k)
        total = int(out_off[-1])
        oh = _scratch("wmin_h", total, np.uint64)
        op = _scratch("wmin_p", total, np.int64)
        of = _scratch("wmin_f", total, np.uint8)
        cnt = np.zeros(len(sub), dtype=np.int64)
        lib.window_minimizers_batch(
            _ptr(codes, ctypes.c_uint8), _ptr(off, ctypes.c_int64), len(sub), k, w,
            _ptr(oh, ctypes.c_uint64), _ptr(op, ctypes.c_int64), _ptr(of, ctypes.c_uint8),
            _ptr(out_off, ctypes.c_int64), _ptr(cnt, ctypes.c_int64), threads,
        )
        hs.append(_compact(oh, out_off, cnt, threads)[0])
        ps.append(_compact(op, out_off, cnt, threads)[0])
        fs.append(_compact(of, out_off, cnt, threads)[0])
        cnts.append(cnt)
    off_all = np.zeros(len(seqs) + 1, dtype=np.int64)
    if cnts:
        np.cumsum(np.concatenate(cnts), out=off_all[1:])

    def _cat(xs, dt):
        if not xs:
            return np.zeros(0, dt)
        return xs[0] if len(xs) == 1 else np.concatenate(xs)

    return (
        _cat(hs, np.uint64), _cat(ps, np.int64),
        _cat(fs, np.uint8).view(bool), off_all,
    )


def minimizer_sketch_batch_native(
    seqs: list[np.ndarray], w: int, k: int, threads: int = 0
) -> list[tuple[np.ndarray, np.ndarray]] | None:
    """Batched minimizer sketch (exact twin of ops/kmers.minimizer_sketch,
    seeding.rs:99-187 quirks included); per sequence returns
    (values u64, positions u64).  None without the native lib."""
    lib = get_scan_lib()
    if lib is None:
        return None
    out_all: list[tuple[np.ndarray, np.ndarray]] = []
    for s, e in _chunk_spans(seqs, k):
        sub = seqs[s:e]
        codes, _, off = _concat(sub, None)
        out_off = _capacity_offsets(sub, k)
        total = int(out_off[-1])
        ov = _scratch("msk_v", total, np.uint64)
        op = _scratch("msk_p", total, np.uint64)
        cnt = np.zeros(len(sub), dtype=np.int64)
        lib.minimizer_sketch_batch(
            _ptr(codes, ctypes.c_uint8), _ptr(off, ctypes.c_int64), len(sub), w, k,
            _ptr(ov, ctypes.c_uint64), _ptr(op, ctypes.c_uint64),
            _ptr(out_off, ctypes.c_int64), _ptr(cnt, ctypes.c_int64), threads,
        )
        dv, doff = _compact(ov, out_off, cnt, threads)
        dp, _ = _compact(op, out_off, cnt, threads)
        out_all.extend(
            (dv[doff[i] : doff[i + 1]], dp[doff[i] : doff[i + 1]])
            for i in range(len(sub))
        )
    return out_all


_SC_LIB = None
_SC_TRIED = False


def get_sortcount_lib():
    global _SC_LIB, _SC_TRIED
    if _SC_TRIED:
        return _SC_LIB
    _SC_TRIED = True
    so = build_extra("sortcount", extra_link=["-fopenmp"])
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.count_flagged_u64.restype = ctypes.c_int64
    lib.count_flagged_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]
    _SC_LIB = lib
    return _SC_LIB


def count_flagged_native(allk: np.ndarray, threads: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Parallel radix sort + run-length strand-split count of a bit63-flagged
    canonical k-mer stream (native/sortcount.cpp).  Same output as the
    np.unique formulation in ops/kmers.count_flagged_kmers; None if the
    native library is unavailable."""
    lib = get_sortcount_lib()
    if lib is None:
        return None
    allk = np.ascontiguousarray(allk, dtype=np.uint64)
    n = len(allk)
    # outputs are prefix-written (nu entries); scratch capacity is reused
    # across chunks and the small prefixes are copied out
    out_u = _scratch("cf_uniq", n, np.uint64)
    out_c = _scratch("cf_cnt", 2 * n, np.uint32)
    nu = lib.count_flagged_u64(
        _ptr(allk, ctypes.c_uint64), n,
        _ptr(out_u, ctypes.c_uint64), _ptr(out_c, ctypes.c_uint32), threads,
    )
    return out_u[:nu].copy(), out_c[: 2 * nu].reshape(-1, 2).copy()


def lsh_batch_native(
    mini_lists: list[np.ndarray], n_tables: int, bucket: int, threads: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Batched LSH signatures over per-read UNFILTERED minimizer k-mers.
    Returns (sigs (n, n_tables) u64, valid (n,) u8) or None without the
    native library.  Bit-identical to TwinRead.compute_lsh_signatures."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(mini_lists)
    off = np.zeros(n + 1, dtype=np.int64)
    for i, m in enumerate(mini_lists):
        off[i + 1] = off[i] + len(m)
    minis = (
        np.ascontiguousarray(np.concatenate(mini_lists), dtype=np.uint64)
        if n
        else np.zeros(0, np.uint64)
    )
    sigs = np.zeros((n, n_tables), dtype=np.uint64)
    valid = np.zeros(n, dtype=np.uint8)
    lib.lsh_batch(
        _ptr(minis, ctypes.c_uint64), _ptr(off, ctypes.c_int64), n,
        n_tables, bucket,
        _ptr(sigs, ctypes.c_uint64), _ptr(valid, ctypes.c_uint8), threads,
    )
    return sigs, valid


def lsh_greedy_cluster_native(
    sigs: np.ndarray, valid: np.ndarray, mini_lists: list[np.ndarray],
    thresh_pow_k: float, top_n: int,
) -> np.ndarray | None:
    """Sequential greedy LSH clustering (native twin of
    stage23_cluster.cluster_reads_by_kmers's read loop).  sigs (R, T) u64
    with valid (R, T) u8; mini_lists = per-read UNFILTERED minimizer
    k-mers.  Returns assignment (R,) i64 or None without the library."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n, t = sigs.shape
    off = np.zeros(n + 1, dtype=np.int64)
    for i, m in enumerate(mini_lists):
        off[i + 1] = off[i] + len(m)
    minis = (
        np.ascontiguousarray(np.concatenate(mini_lists), dtype=np.uint64)
        if n
        else np.zeros(0, np.uint64)
    )
    sigs = np.ascontiguousarray(sigs, dtype=np.uint64)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    out = np.zeros(n, dtype=np.int64)
    lib.lsh_greedy_cluster(
        _ptr(sigs, ctypes.c_uint64), _ptr(valid, ctypes.c_uint8), t,
        _ptr(minis, ctypes.c_uint64), _ptr(off, ctypes.c_int64), n,
        thresh_pow_k, top_n, _ptr(out, ctypes.c_int64),
    )
    return out


def snpmer_subcluster_native(
    snp_lists: list[np.ndarray], mask: int
) -> np.ndarray | None:
    """Greedy zero-mismatch SNPmer sub-clustering (native twin of the
    non-blockmer _snpmer_subcluster loop).  Returns local assignment (n,)
    i64 or None without the library."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(snp_lists)
    off = np.zeros(n + 1, dtype=np.int64)
    for i, m in enumerate(snp_lists):
        off[i + 1] = off[i] + len(m)
    snps = (
        np.ascontiguousarray(np.concatenate(snp_lists), dtype=np.uint64)
        if n
        else np.zeros(0, np.uint64)
    )
    out = np.zeros(n, dtype=np.int64)
    lib.snpmer_greedy_subcluster(
        _ptr(snps, ctypes.c_uint64), _ptr(off, ctypes.c_int64), n,
        ctypes.c_uint64(int(mask)), _ptr(out, ctypes.c_int64),
    )
    return out


def snpmer_subcluster_multi_native(
    snp_lists: list[np.ndarray], c_off: np.ndarray, mask: int,
    threads: int = 4,
) -> np.ndarray | None:
    """Greedy SNPmer sub-clustering over MANY clusters in one call: reads
    arrive cluster-ordered (cluster c = reads c_off[c]..c_off[c+1]); each
    cluster runs the exact single-cluster greedy loop on its own thread
    (clusters are independent).  Returns per-read LOCAL assignments."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(snp_lists)
    off = np.zeros(n + 1, dtype=np.int64)
    for i, m in enumerate(snp_lists):
        off[i + 1] = off[i] + len(m)
    snps = (
        np.ascontiguousarray(np.concatenate(snp_lists), dtype=np.uint64)
        if n
        else np.zeros(0, np.uint64)
    )
    out = np.zeros(n, dtype=np.int64)
    lib.snpmer_greedy_subcluster_multi(
        _ptr(snps, ctypes.c_uint64), _ptr(off, ctypes.c_int64),
        _ptr(np.ascontiguousarray(c_off, np.int64), ctypes.c_int64),
        len(c_off) - 1, ctypes.c_uint64(int(mask)),
        _ptr(out, ctypes.c_int64), threads,
    )
    return out


def kmer_at_positions_native(
    codes_list: list[np.ndarray], pos_lists: list[np.ndarray], k: int,
    threads: int = 0,
) -> list[np.ndarray] | None:
    """Batched kmer_at_position (canonical, forward-preferred ties) via one
    native rolling pass per read.  Positions must be sorted ascending (they
    are: mini_pos/snp_pos are emitted in scan order).  None without the
    library."""
    lib = get_scan_lib()
    if lib is None:
        return None
    codes, _, off = _concat(codes_list, None)
    n = len(codes_list)
    pos_off = np.zeros(n + 1, dtype=np.int64)
    for i, p in enumerate(pos_lists):
        pos_off[i + 1] = pos_off[i] + len(p)
    pos = (
        np.ascontiguousarray(np.concatenate(pos_lists), dtype=np.uint32)
        if n
        else np.zeros(0, np.uint32)
    )
    # out is exact-size (one k-mer per requested position, fully written),
    # so per-read views are free — nothing oversized to release
    out = np.empty(int(pos_off[-1]), dtype=np.uint64)
    lib.kmer_at_positions_batch(
        _ptr(codes, ctypes.c_uint8), _ptr(off, ctypes.c_int64), n,
        _ptr(pos, ctypes.c_uint32), _ptr(pos_off, ctypes.c_int64), k,
        _ptr(out, ctypes.c_uint64), threads,
    )
    return [out[pos_off[i] : pos_off[i + 1]] for i in range(n)]


def get_sort_lib():
    """sortcount.so with the radix sort + anchor packing entry points."""
    lib = get_sortcount_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_anchor_ready"):
        lib.radix_sort_u64.restype = None
        lib.radix_sort_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int,
        ]
        lib.anchor_search.restype = ctypes.c_int64
        lib.anchor_search.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
        ]
        lib.anchor_pack_keys.restype = ctypes.c_int64
        lib.anchor_pack_keys.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.anchor_count_hits_idx.restype = ctypes.c_int64
        lib.anchor_count_hits_idx.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib.anchor_pack_keys_idx.restype = None
        lib.anchor_pack_keys_idx.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        lib._anchor_ready = True
    return lib


def anchor_keys_indexed_native(
    h_cat: np.ndarray, tab_off: np.ndarray,
    pool_h: np.ndarray, pool_p: np.ndarray, pool_f: np.ndarray,
    q_moff: np.ndarray, job_uq: np.ndarray, job_ti: np.ndarray,
    qlens_uq: np.ndarray, h_tpos: np.ndarray, h_isf: np.ndarray,
    k: int, threads: int = 4,
) -> np.ndarray | None:
    """Fused indexed anchor planning: job j probes its unique query's
    POOLED minimizers (pool_h[q_moff[uq]:q_moff[uq+1]]) against its target
    table and emits packed sorted keys directly — no per-job expansion of
    the mini pools on the host (np.repeat + gathers to tens of millions of
    elements cost more than every native call they fed).  The keys are
    anchor_sorted_keys_native(jid_shift=29)'s over the expanded arrays.
    Returns keys or None without the library."""
    lib = get_sort_lib()
    if lib is None or not hasattr(lib, "anchor_count_hits_idx"):
        return None
    n_jobs = len(job_uq)
    n_tables = len(tab_off) - 1
    h_cat = np.ascontiguousarray(h_cat, np.uint64)
    tab_off = np.ascontiguousarray(tab_off, np.int64)
    pool_h = np.ascontiguousarray(pool_h, np.uint64)
    pool_p32 = np.ascontiguousarray(pool_p, np.int32)
    pool_f8 = np.ascontiguousarray(pool_f.view(np.uint8) if pool_f.dtype == bool else pool_f, np.uint8)
    q_moff = np.ascontiguousarray(q_moff, np.int64)
    job_uq = np.ascontiguousarray(job_uq, np.int64)
    job_ti32 = np.ascontiguousarray(job_ti, np.int32)
    qlens_uq = np.ascontiguousarray(qlens_uq, np.int64)
    h_tpos = np.ascontiguousarray(h_tpos, np.int32)
    h_isf8 = np.ascontiguousarray(h_isf.view(np.uint8) if h_isf.dtype == bool else h_isf, np.uint8)
    job_off = np.empty(n_jobs + 1, dtype=np.int64)
    total = lib.anchor_count_hits_idx(
        _ptr(h_cat, ctypes.c_uint64), _ptr(tab_off, ctypes.c_int64), n_tables,
        _ptr(pool_h, ctypes.c_uint64), _ptr(q_moff, ctypes.c_int64),
        _ptr(job_uq, ctypes.c_int64), _ptr(job_ti32, ctypes.c_int32), n_jobs,
        _ptr(job_off, ctypes.c_int64), threads,
    )
    keys = np.empty(int(total), dtype=np.uint64)
    if total:
        lib.anchor_pack_keys_idx(
            _ptr(h_cat, ctypes.c_uint64), _ptr(tab_off, ctypes.c_int64), n_tables,
            _ptr(pool_h, ctypes.c_uint64), _ptr(pool_p32, ctypes.c_int32),
            _ptr(pool_f8, ctypes.c_uint8), _ptr(q_moff, ctypes.c_int64),
            _ptr(job_uq, ctypes.c_int64), _ptr(job_ti32, ctypes.c_int32), n_jobs,
            _ptr(qlens_uq, ctypes.c_int64), _ptr(h_tpos, ctypes.c_int32),
            _ptr(h_isf8, ctypes.c_uint8), k,
            _ptr(job_off, ctypes.c_int64), _ptr(keys, ctypes.c_uint64), threads,
        )
    return keys


def anchor_search_native(
    h_sorted: np.ndarray, queries: np.ndarray, threads: int = 4
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Range lookup of query hashes in the sorted target table: the native
    twin of the left/right np.searchsorted pair in plan_jobs_batch.
    Returns (lo, cnt, total) or None without the library."""
    lib = get_sort_lib()
    if lib is None:
        return None
    n = len(queries)
    lo = np.empty(n, dtype=np.int64)
    cnt = np.empty(n, dtype=np.int64)
    total = lib.anchor_search(
        _ptr(np.ascontiguousarray(h_sorted, np.uint64), ctypes.c_uint64),
        len(h_sorted),
        _ptr(np.ascontiguousarray(queries, np.uint64), ctypes.c_uint64), n,
        _ptr(lo, ctypes.c_int64), _ptr(cnt, ctypes.c_int64), threads,
    )
    return lo, cnt, int(total)


def anchor_sorted_keys_native(
    lo: np.ndarray, cnt: np.ndarray, all_p: np.ndarray, all_f: np.ndarray,
    qid: np.ndarray, qlens: np.ndarray, h_tid: np.ndarray, h_tpos: np.ndarray,
    h_isf: np.ndarray, k: int, no_diag: bool, threads: int,
    jid_shift: int = 43,
) -> np.ndarray | None:
    """Expand minimizer-hit ranges into packed anchor keys and radix-sort
    them (native twin of plan_jobs_batch's expand + argsort).  Caller
    decodes (qid, tid, strand, qpos, tpos) from the sorted key bits.
    jid_shift=29 packs the job id right above the strand bit for
    singleton-table callers (tid is always 0 there): identical sort order,
    ~14 fewer populated key bits, one fewer radix pass."""
    lib = get_sort_lib()
    if lib is None:
        return None
    total = int(cnt.sum())
    keys = np.empty(total, dtype=np.uint64)
    n = lib.anchor_pack_keys(
        _ptr(np.ascontiguousarray(lo, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(cnt, np.int64), ctypes.c_int64),
        len(lo),
        _ptr(np.ascontiguousarray(all_p, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(all_f, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(qid, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(qlens, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(h_tid, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(h_tpos, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(h_isf, np.uint8), ctypes.c_uint8),
        k, int(no_diag), jid_shift, _ptr(keys, ctypes.c_uint64),
    )
    keys = keys[:n]
    lib.radix_sort_u64(_ptr(keys, ctypes.c_uint64), n, threads)
    return keys


def snpmer_join_count_native(
    sms: np.ndarray, kms: np.ndarray, ridx: np.ndarray,
    c_sm: np.ndarray, c_km: np.ndarray, c_cid: np.ndarray,
    n_reads: int, n_clusters: int, threads: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-(read, cluster) SNPmer match/mismatch counts against the sorted
    consensus table (native twin of the _reassign_reads expansion join).
    ridx must be non-decreasing."""
    lib = get_scan_lib()
    if lib is None:
        return None
    m_mat = np.zeros((n_reads, n_clusters), dtype=np.int64)
    mm_mat = np.zeros((n_reads, n_clusters), dtype=np.int64)
    lib.snpmer_join_count(
        _ptr(np.ascontiguousarray(sms, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(kms, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(ridx, np.int64), ctypes.c_int64),
        len(sms),
        _ptr(np.ascontiguousarray(c_sm, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(c_km, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(c_cid, np.int64), ctypes.c_int64),
        len(c_sm), n_clusters,
        _ptr(m_mat, ctypes.c_int64), _ptr(mm_mat, ctypes.c_int64),
        max(threads, 1),
    )
    return m_mat, mm_mat


def recluster_round_native(
    members: np.ndarray, m_off: np.ndarray, km_flat: np.ndarray,
    koff: np.ndarray, is_blockmer: bool, l: int, sm_mask: int,
    threads: int = 4,
) -> tuple[np.ndarray, int] | None:
    """One native greedy consensus-merge round over clusters pre-sorted by
    (-size, first member).  Returns (merged_into, num_merges) or None."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(m_off) - 1
    merged_into = np.empty(n, dtype=np.int64)
    nm = lib.recluster_round(
        _ptr(np.ascontiguousarray(members, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(m_off, np.int64), ctypes.c_int64), n,
        _ptr(np.ascontiguousarray(km_flat, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(koff, np.int64), ctypes.c_int64),
        int(is_blockmer), l, ctypes.c_uint64(int(sm_mask)),
        _ptr(merged_into, ctypes.c_int64), threads,
    )
    return merged_into, int(nm)


def consensus_batch_native(
    members: np.ndarray, m_off: np.ndarray, km_flat: np.ndarray,
    koff: np.ndarray, is_blockmer: bool, l: int, sm_mask: int,
    threads: int = 4,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Flat (sm, km, cid) consensus-SNPmer table for many clusters in one
    call (ordered by cluster, then sm ascending), or None."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(m_off) - 1
    members = np.ascontiguousarray(members, np.int64)
    m_off = np.ascontiguousarray(m_off, np.int64)
    koff = np.ascontiguousarray(koff, np.int64)
    cap = int((koff[members + 1] - koff[members]).sum()) if len(members) else 0
    out_sm = np.empty(cap, dtype=np.uint64)
    out_km = np.empty(cap, dtype=np.uint64)
    out_cid = np.empty(cap, dtype=np.int64)
    w = lib.consensus_batch(
        _ptr(members, ctypes.c_int64), _ptr(m_off, ctypes.c_int64), n,
        _ptr(np.ascontiguousarray(km_flat, np.uint64), ctypes.c_uint64),
        _ptr(koff, ctypes.c_int64),
        int(is_blockmer), l, ctypes.c_uint64(int(sm_mask)),
        _ptr(out_sm, ctypes.c_uint64), _ptr(out_km, ctypes.c_uint64),
        _ptr(out_cid, ctypes.c_int64), threads,
    )
    return out_sm[:w], out_km[:w], out_cid[:w]


def solid_filter_batch_native(
    mini_lists: list[np.ndarray], snp_lists: list[np.ndarray],
    high_freq_sorted: np.ndarray, max_count: int, threads: int,
) -> tuple[list[np.ndarray], list[np.ndarray]] | None:
    """Per-read solid masks for minimizers (multiplicity + high-freq) and
    SNPmers (high-freq) — native twin of _apply_solid_filters' mask math."""
    r = solid_filter_flat_native(
        mini_lists, snp_lists, high_freq_sorted, max_count, threads
    )
    if r is None:
        return None
    mb, m_off, sb, s_off, m_counts, _minis, _snps = r
    n = len(mini_lists)
    return (
        [mb[m_off[i] : m_off[i + 1]] for i in range(n)],
        [sb[s_off[i] : s_off[i + 1]] for i in range(n)],
        m_counts,
    )


def solid_filter_flat_native(
    mini_lists: list[np.ndarray], snp_lists: list[np.ndarray],
    high_freq_sorted: np.ndarray, max_count: int, threads: int,
):
    """Flat-pool twin of solid_filter_batch_native: returns
    (mb bool flat, m_off i64[n+1], sb bool flat, s_off i64[n+1],
    m_counts i64[n], minis_flat u64, snps_flat u64) so callers can apply
    the masks with ONE boolean gather over the pools instead of a per-read
    fancy-index loop (the stage-1.5 hotspot at 100k reads)."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(mini_lists)
    m_off = np.zeros(n + 1, dtype=np.int64)
    s_off = np.zeros(n + 1, dtype=np.int64)
    for i in range(n):
        m_off[i + 1] = m_off[i] + len(mini_lists[i])
        s_off[i + 1] = s_off[i] + len(snp_lists[i])
    minis = (
        np.ascontiguousarray(np.concatenate(mini_lists), dtype=np.uint64)
        if n else np.zeros(0, np.uint64)
    )
    snps = (
        np.ascontiguousarray(np.concatenate(snp_lists), dtype=np.uint64)
        if n else np.zeros(0, np.uint64)
    )
    r = solid_filter_pools_native(minis, m_off, snps, s_off, high_freq_sorted, max_count, threads)
    if r is None:
        return None
    mb, sb, m_counts = r
    return mb, m_off, sb, s_off, m_counts, minis, snps


def solid_filter_pools_native(
    minis: np.ndarray, m_off: np.ndarray, snps: np.ndarray, s_off: np.ndarray,
    high_freq_sorted: np.ndarray, max_count: int, threads: int,
):
    """solid_filter over pre-flattened pools (the stage-1.5 flat-scan path
    hands these straight from syncmer_scan_flat_native — no re-concat).
    Returns (mb bool flat, sb bool flat, m_counts i64[n])."""
    lib = get_scan_lib()
    if lib is None:
        return None
    n = len(m_off) - 1
    minis = np.ascontiguousarray(minis, dtype=np.uint64)
    snps = np.ascontiguousarray(snps, dtype=np.uint64)
    m_off = np.ascontiguousarray(m_off, dtype=np.int64)
    s_off = np.ascontiguousarray(s_off, dtype=np.int64)
    hf = np.ascontiguousarray(high_freq_sorted, dtype=np.uint64)
    m_solid = np.zeros(len(minis), dtype=np.uint8)
    s_solid = np.zeros(len(snps), dtype=np.uint8)
    lib.solid_filter_batch(
        _ptr(minis, ctypes.c_uint64), _ptr(m_off, ctypes.c_int64),
        _ptr(snps, ctypes.c_uint64), _ptr(s_off, ctypes.c_int64), n,
        _ptr(hf, ctypes.c_uint64), len(hf), max_count,
        _ptr(m_solid, ctypes.c_uint8), _ptr(s_solid, ctypes.c_uint8),
        max(threads, 1),
    )
    mb = m_solid.astype(bool)
    sb = s_solid.astype(bool)
    # per-read solid counts in one vector pass (the per-read .sum() loop
    # was a 20k-ufunc hotspot in stage 1.5)
    # np.cumsum(bool, out=int64) hits a slow buffered-casting path
    # (~74 ns/elem); cast first
    cs = np.zeros(len(mb) + 1, dtype=np.int64)
    np.cumsum(mb.astype(np.int64), out=cs[1:])
    m_counts = cs[m_off[1:]] - cs[m_off[:-1]]
    return mb, sb, m_counts
