"""Core data types: TwinRead, SnpmerInfo, ConsensusSequence.

Python equivalents of the reference's types.rs, holding NumPy arrays so the
per-base math can be dispatched to vector kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import LSH_BUCKET_SIZE, LSH_NUM_TABLES
from .ops.encode import (
    U64,
    decode_seq,
    expand_binned_qualities,
    fxhash64_seeded,
    homopolymer_decompress,
)
from .ops.kmers import kmer_at_position, kmer_at_position_oriented

_EMPTY_U32 = np.zeros(0, np.uint32)
_EMPTY_U64 = np.zeros(0, U64)
_EMPTY_BOOL = np.zeros(0, bool)
for _e in (_EMPTY_U32, _EMPTY_U64, _EMPTY_BOOL):
    _e.setflags(write=False)


@dataclass
class SnpmerInfo:
    """A biallelic split-k-mer site (types.rs:818-824)."""

    split_kmer: int
    mid_bases: tuple[int, int]
    counts: tuple[int, int]
    k: int

    def variants(self) -> tuple[int, int]:
        """The two full k-mers: split_kmer | mid_base << (k-1)."""
        k = self.k
        return (
            self.split_kmer | (self.mid_bases[0] << (k - 1)),
            self.split_kmer | (self.mid_bases[1] << (k - 1)),
        )


@dataclass
class KmerGlobalInfo:
    """types.rs:800-808."""

    snpmer_info: list[SnpmerInfo]
    high_freq_kmers: np.ndarray  # sorted u64 canonical kmers with count > thresh
    high_freq_thresh: float
    read_files: list[str]

    def snpmer_set_sorted(self) -> np.ndarray:
        vs = []
        for s in self.snpmer_info:
            vs.extend(s.variants())
        return np.unique(np.array(vs, dtype=U64)) if vs else np.zeros(0, dtype=U64)


@dataclass(slots=True)
class TwinRead:
    """Positions-only seed storage over a 2-bit sequence (types.rs:385-412).

    Parity notes (important, matches reference retain_* quirk):
      - ``mini_kmers_all`` / ``snp_kmers_all`` are the UNFILTERED k-mer lists
        captured at construction (the reference's ``minimizer_kmers`` /
        ``snpmer_kmers`` vectors are never filtered — types.rs:702-715 only
        filters the positions vectors).
      - ``mini_pos`` / ``snp_pos`` are the filtered positions; ``*_vec()``
        recomputes canonical k-mers from them with forward-preferred
        tie-break (types.rs:622-663).
    """

    id: str
    base_id: str
    codes: np.ndarray  # uint8 2-bit codes, N sanitized to A
    k: int
    l: int
    qual_levels: np.ndarray | None = None  # QualCompact3 levels (one per 4-base bin)
    est_id: float | None = None
    # shared read-only empties: a fresh np.zeros(0) per default-factory call
    # was 200k allocations per 100k-read construction pass.  These fields
    # are only ever REPLACED (never mutated in place), so one frozen empty
    # per dtype is safe to share.
    mini_pos: np.ndarray = field(default_factory=lambda: _EMPTY_U32)
    mini_kmers_all: np.ndarray = field(default_factory=lambda: _EMPTY_U64)
    snp_pos: np.ndarray = field(default_factory=lambda: _EMPTY_U32)
    snp_kmers_all: np.ndarray = field(default_factory=lambda: _EMPTY_U64)
    blockmer_pos: np.ndarray = field(default_factory=lambda: _EMPTY_U32)
    blockmer_canonical: np.ndarray = field(default_factory=lambda: _EMPTY_BOOL)
    lsh_signatures: list[int | None] = field(default_factory=list)
    file_idx: int = 0
    # memo slots (slots=True: dynamic attributes are gone, so the caches
    # are declared fields — init/repr/compare-excluded, default None)
    _seq_bytes_cache: bytes | None = field(default=None, init=False, repr=False, compare=False)
    _qual_ascii_cache: np.ndarray | None = field(default=None, init=False, repr=False, compare=False)
    _mini_vec_cache: tuple | None = field(default=None, init=False, repr=False, compare=False)
    _snp_vec_cache: tuple | None = field(default=None, init=False, repr=False, compare=False)
    _avg_qual_cache: float | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def base_length(self) -> int:
        return len(self.codes)

    def seq_bytes(self) -> bytes:
        """Decoded ASCII sequence, memoized: stages 4/5/7 each re-read every
        cluster member, and a stable bytes object also lets the DP batch
        packer dedup shared queries by identity."""
        b = getattr(self, "_seq_bytes_cache", None)
        if b is None:
            b = decode_seq(self.codes)
            self._seq_bytes_cache = b
            from .ops.encode import register_planner_codes

            register_planner_codes(b, self.codes)
        return b

    @staticmethod
    def warm_seq_bytes(trs: list["TwinRead"]) -> None:
        """Batch-fill the seq_bytes memo for many reads: one concatenated
        LUT gather + per-read bytes slices instead of a decode_seq call per
        read (identical bytes; the per-call numpy overhead dominates at
        tens of thousands of reads)."""
        from .ops.encode import _CODE_TO_BYTE

        miss = [t for t in trs if getattr(t, "_seq_bytes_cache", None) is None]
        if not miss:
            return
        lens = np.fromiter((len(t.codes) for t in miss), np.int64, len(miss))
        off = np.zeros(len(miss) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        buf = _CODE_TO_BYTE[np.concatenate([t.codes for t in miss])].tobytes()
        offs = off.tolist()
        from .ops.encode import register_planner_codes

        for i, t in enumerate(miss):
            b = buf[offs[i] : offs[i + 1]]
            t._seq_bytes_cache = b
            register_planner_codes(b, t.codes)

    @staticmethod
    def warm_qual_ascii(trs: list["TwinRead"]) -> None:
        """Batch-fill the expanded_qual_ascii memo: one concatenated
        level->ascii map + np.repeat for all misses (bit-identical to
        expand_binned_qualities per read, incl. the tail-padding rule)."""
        miss = [t for t in trs if getattr(t, "_qual_ascii_cache", None) is None]
        if not miss:
            return
        lvls, idx = [], []
        for t in miss:
            if t.qual_levels is None:
                t._qual_ascii_cache = np.full(len(t.codes), 33, dtype=np.uint8)
            else:
                idx.append(t)
                lvls.append(t.qual_levels)
        if not idx:
            return
        q = (np.concatenate(lvls).astype(np.int32) * 3 + 33).astype(np.uint8)
        exp = np.repeat(q, 4)  # QUALITY_SEQ_BIN
        exp.setflags(write=False)  # cached views share this buffer
        off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter((4 * len(v) for v in lvls), np.int64, len(lvls)), out=off[1:]
        )
        offs = off.tolist()
        for i, t in enumerate(idx):
            e = exp[offs[i] : offs[i + 1]]
            n = len(t.codes)
            if len(e) >= n:
                t._qual_ascii_cache = e[:n]
            elif len(e):
                t._qual_ascii_cache = np.concatenate(
                    [e, np.full(n - len(e), e[-1], dtype=np.uint8)]
                )
            else:
                t._qual_ascii_cache = np.full(n, 33, dtype=np.uint8)

    def expanded_qual_ascii(self) -> np.ndarray:
        """Per-base ASCII qualities from the binned codec (alignment.rs:233-258).
        Memoized like seq_bytes; treat the returned array as read-only."""
        q = getattr(self, "_qual_ascii_cache", None)
        if q is None:
            if self.qual_levels is None:
                q = np.full(len(self.codes), 33, dtype=np.uint8)
            else:
                q = expand_binned_qualities(self.qual_levels, len(self.codes))
            self._qual_ascii_cache = q
        return q

    def minimizer_kmers(self) -> np.ndarray:
        """UNFILTERED minimizer k-mers (reference minimizer_kmers())."""
        return self.mini_kmers_all

    def snpmer_kmers(self) -> np.ndarray:
        """UNFILTERED SNPmer k-mers (reference snpmer_kmers())."""
        return self.snp_kmers_all

    def minimizers_vec(self) -> tuple[np.ndarray, np.ndarray]:
        """(filtered positions, recomputed canonical k-mers) — types.rs:686.
        Cached: positions are fixed once the solid filters have run."""
        c = getattr(self, "_mini_vec_cache", None)
        if c is None or c[0] is not self.mini_pos:
            c = (self.mini_pos, kmer_at_position(self.codes, self.mini_pos, self.k))
            self._mini_vec_cache = c
        return c

    def snpmers_vec(self) -> tuple[np.ndarray, np.ndarray]:
        """(filtered positions, recomputed canonical k-mers) — types.rs:696.
        Cached: positions are fixed once the solid filters have run."""
        c = getattr(self, "_snp_vec_cache", None)
        if c is None or c[0] is not self.snp_pos:
            c = (self.snp_pos, kmer_at_position(self.codes, self.snp_pos, self.k))
            self._snp_vec_cache = c
        return c

    def blockmers_vec(self) -> tuple[np.ndarray, np.ndarray]:
        """(positions, full (k+l)-mers) reconstructed with the stored
        orientation flags (types.rs:749-754)."""
        return self.blockmer_pos, kmer_at_position_oriented(
            self.codes, self.blockmer_pos, self.k + self.l, self.blockmer_canonical
        )

    def compute_lsh_signatures(self) -> None:
        """20-table bottom-3 LSH signatures over the UNFILTERED minimizer
        k-mers (types.rs:719-747): per table, FxHash64(seed, kmer) ranks the
        k-mers; signature = XOR_i kmer_i * (i+1) over the 3 lowest ranks.
        Ties in hash keep input order (Rust stable sort_by_key).
        All tables computed in one vectorized (T, n) pass."""
        minis = self.mini_kmers_all
        if len(minis) < LSH_BUCKET_SIZE:
            self.lsh_signatures = [None] * LSH_NUM_TABLES
            return
        seeds = np.arange(LSH_NUM_TABLES, dtype=U64)[:, None]
        h = fxhash64_seeded(seeds, minis[None, :])  # (T, n)
        order = np.argsort(h, axis=1, kind="stable")[:, :LSH_BUCKET_SIZE]
        picked = minis[order]  # (T, 3)
        with np.errstate(over="ignore"):
            weighted = picked * np.arange(1, LSH_BUCKET_SIZE + 1, dtype=U64)[None, :]
        sigs = weighted[:, 0]
        for i in range(1, LSH_BUCKET_SIZE):
            sigs = sigs ^ weighted[:, i]
        self.lsh_signatures = [int(s) for s in sigs]


_LSH_MATRIX_CACHE: tuple | None = None  # (trs list object, sigs (n,T) u64, valid (n,) u8)


def cached_lsh_matrix(trs: list["TwinRead"]):
    """(sigs, valid) matrices from the last compute_lsh_signatures_batch IF
    it ran on this exact list object (stage 2 consumes them directly
    instead of re-walking 100k per-read signature lists)."""
    if _LSH_MATRIX_CACHE is not None and _LSH_MATRIX_CACHE[0] is trs:
        return _LSH_MATRIX_CACHE[1], _LSH_MATRIX_CACHE[2]
    return None


def compute_lsh_signatures_batch(trs: list["TwinRead"], threads: int = 1) -> None:
    """Batched LSH signatures for many reads via native/kmerscan.cpp
    lsh_batch (bit-identical to the per-read method; falls back to it
    without the native library)."""
    from .ops.kmers_native import lsh_batch_native

    global _LSH_MATRIX_CACHE
    res = lsh_batch_native(
        [tr.mini_kmers_all for tr in trs], LSH_NUM_TABLES, LSH_BUCKET_SIZE, threads
    )
    if res is None:
        _LSH_MATRIX_CACHE = None
        for tr in trs:
            tr.compute_lsh_signatures()
        return
    sigs, valid = res
    _LSH_MATRIX_CACHE = (trs, sigs, valid)
    # per-read signature LISTS are only consumed by the no-native Python
    # greedy path in stage 2 (which can't run when lsh_batch_native just
    # succeeded — both are gated on the same scan lib); the native greedy
    # consumes the matrix cache directly, and a cache miss recomputes the
    # matrix natively (stage23_cluster._lsh_matrices).  Materializing the
    # lists was ~1.5 s of tolist + 100k assignments at 100k reads.


def ensure_lsh_signature_lists(trs: list["TwinRead"]) -> None:
    """Materialize per-read lsh_signatures LISTS for list-representation
    consumers (the no-native Python greedy path in stage 2).  No-op for
    reads whose lists are already filled; uses the batch matrix cache when
    it covers this exact list, else the per-read compute."""
    need = [t for t in trs if not t.lsh_signatures]
    if not need:
        return
    cached = cached_lsh_matrix(trs)
    if cached is not None:
        sigs, valid = cached
        rows = sigs.tolist()
        none_row = [None] * LSH_NUM_TABLES
        for i, tr in enumerate(trs):
            if not tr.lsh_signatures:
                tr.lsh_signatures = rows[i] if valid[i] else none_row[:]
        return
    for tr in need:
        tr.compute_lsh_signatures()


@dataclass
class ConsensusSequence:
    """HPC consensus + metadata (types.rs:161-226)."""

    sequence: np.ndarray  # HPC consensus as ASCII bytes array (uint8), may contain N
    hp_lengths: np.ndarray  # run length per HPC base (uint8)
    depth: int
    id: int
    cluster: list[int]
    appended_depth: int = 0
    low_quality_positions: list[int] = field(default_factory=list)
    chimera_score: int | None = None
    decompressed: np.ndarray | None = None
    unambig_best_read_map_count: int | None = None
    ambig_read_map_count: int | None = None
    num_map_leq_10nm: int | None = None
    per_sample_depths: list[int] = field(default_factory=list)

    def decompress(self) -> None:
        """Expand HPC runs, then trim leading/trailing N (types.rs:212-217)."""
        full = homopolymer_decompress(self.sequence, self.hp_lengths)
        non_n = np.flatnonzero(full != ord("N"))
        if len(non_n):
            full = full[non_n[0] : non_n[-1] + 1]
        self.decompressed = full

    def get_decompressed(self) -> np.ndarray:
        if self.decompressed is None:
            self.decompress()
        return self.decompressed

    def peek_decompressed(self) -> np.ndarray:
        """Decompressed sequence WITHOUT caching it on the object — for
        writers that run mid-pipeline, before the HPC form is final (the
        reference clones before decompressing, alignment.rs:831-832)."""
        if self.decompressed is not None:
            return self.decompressed
        full = homopolymer_decompress(self.sequence, self.hp_lengths)
        non_n = np.flatnonzero(full != ord("N"))
        if len(non_n):
            full = full[non_n[0] : non_n[-1] + 1]
        return full
