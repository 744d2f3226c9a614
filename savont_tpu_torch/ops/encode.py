"""Sequence encodings and scalar hash primitives.

2-bit DNA codes (A=0 C=1 G=2 T=3, everything else 0) match the reference's
BYTE_TO_SEQ table (types.rs:92-101).  All kernels in this package operate on
vectors of these codes, not on byte strings.
"""
from __future__ import annotations

import numpy as np

# BYTE_TO_SEQ equivalent: 256-entry lookup, A/a=0, C/c=1, G/g=2, T/t/U/u=3, else 0.
_BYTE_TO_CODE = np.zeros(256, dtype=np.uint8)
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"TtUu", 3)):
    for _ch in _b:
        _BYTE_TO_CODE[_ch] = _c
# quirk parity (types.rs:93): bytes 0x00-0x03 map to 0..3 in the reference table
_BYTE_TO_CODE[0], _BYTE_TO_CODE[1], _BYTE_TO_CODE[2], _BYTE_TO_CODE[3] = 0, 1, 2, 3

_CODE_TO_BYTE = np.frombuffer(b"ACGT", dtype=np.uint8)

_COMP = {ord("A"): "T", ord("T"): "A", ord("C"): "G", ord("G"): "C"}
_RC_TABLE = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNN")

U64 = np.uint64
_FX_SEED = U64(0x51_7C_C1_B7_27_22_0A_95)


def encode_seq(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 2-bit codes (N and unknown -> A=0)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BYTE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> bytes:
    return _CODE_TO_BYTE[codes].tobytes()


# bytes-IDENTITY -> pre-encoded 0..4 planner codes.  decode_seq emits only
# "ACGT", and ascii_to_align_codes inverts _CODE_TO_BYTE exactly, so for any
# bytes produced from a TwinRead's 2-bit codes the planner's re-encode is
# guaranteed to reproduce those codes.  TwinRead.seq_bytes registers its
# memoized bytes here so the aligner planner (minimizer scans + query
# encoding) can skip the ASCII->code LUT pass entirely.  Entries pin the
# bytes object, so ids can't be recycled while an entry lives.
_CODES_REG: dict[int, tuple] = {}
_CODES_REG_MAX = 400_000


def register_planner_codes(b: bytes, codes: np.ndarray) -> None:
    if len(_CODES_REG) > _CODES_REG_MAX:
        # atomic snapshot + pop: tolerate concurrent planner threads
        keys = list(_CODES_REG)
        for k in keys[: len(keys) // 2]:
            _CODES_REG.pop(k, None)
    _CODES_REG[id(b)] = (b, codes)


def register_planner_codes_many(bufs: list, codes: list) -> None:
    """Bulk register (one dict.update; the per-call function overhead was
    ~0.2 s at 100k reads in the stage-1.5 prefill)."""
    if len(_CODES_REG) + len(bufs) > _CODES_REG_MAX:
        keys = list(_CODES_REG)
        for k in keys[: len(keys) // 2]:
            _CODES_REG.pop(k, None)
    _CODES_REG.update((id(b), (b, c)) for b, c in zip(bufs, codes))


def registered_planner_codes(b) -> np.ndarray | None:
    e = _CODES_REG.get(id(b))
    return e[1] if e is not None and e[0] is b else None


def revcomp_bytes(seq: bytes) -> bytes:
    """Reverse complement of an ASCII sequence (non-ACGT -> N), utils.rs:51-65."""
    return seq.translate(_RC_TABLE)[::-1]


def decode_kmer(kmer: int, k: int) -> str:
    """2-bit packed k-mer (most-significant = first base) -> string (types.rs:283)."""
    out = []
    for i in range(k):
        out.append("ACGT"[(int(kmer) >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def mm_hash64(v: np.ndarray | int) -> np.ndarray | int:
    """Invertible murmur-style 64-bit mix (seeding.rs:18-28, miniprot-derived).

    Vectorized over uint64 arrays; wrapping arithmetic via numpy uint64.
    """
    scalar = np.isscalar(v) or getattr(v, "shape", None) == ()
    key = np.asarray(v, dtype=U64).copy()
    with np.errstate(over="ignore"):
        key = (~key) + (key << U64(21))
        key = key ^ (key >> U64(24))
        key = (key + (key << U64(3))) + (key << U64(8))
        key = key ^ (key >> U64(14))
        key = (key + (key << U64(2))) + (key << U64(4))
        key = key ^ (key >> U64(28))
        key = key + (key << U64(31))
    return int(key) if scalar else key


def fxhash64_seeded(seed: int | np.ndarray, words: np.ndarray) -> np.ndarray:
    """FxHasher64 of [seed_u64, word_u64] per element (types.rs:719-747 LSH).

    Matches the fxhash crate: h = rotl(h,5) ^ w; h *= 0x517cc1b727220a95,
    starting from h = 0, fed first the table seed then the k-mer.
    seed and words broadcast (e.g. seeds (T,1) x words (1,n) -> (T,n)).
    """
    words = np.asarray(words, dtype=U64)
    with np.errstate(over="ignore"):
        h = np.asarray(seed, dtype=U64) * _FX_SEED    # rotl(0,5)^seed = seed
        h = ((h << U64(5)) | (h >> U64(59))) ^ words  # rotl then xor kmer
        h = h * _FX_SEED
    return h


def phred_from_ascii(qual: bytes) -> np.ndarray:
    """ASCII quality string -> integer Phred scores (q - 33)."""
    return np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - 33


# 10^(-q/10) for q = (ascii 0..255) - 33; indexed by RAW ASCII so negative
# phred (malformed quality < '!') still maps in-table.  Each entry is the
# same double np.power would produce for that q, so LUT gather == power.
_ERR_PROB_LUT = np.power(10.0, -(np.arange(256, dtype=np.float64) - 33.0) / 10.0)


def error_probs_from_phred(phred: np.ndarray) -> np.ndarray:
    """10^(-q/10) per base via LUT gather (bit-identical to np.power)."""
    return _ERR_PROB_LUT[(phred.astype(np.int64) + 33) & 0xFF]


def estimate_sequence_identity(phred: np.ndarray | None) -> float | None:
    """Mean-error-probability identity estimate in percent (seeding.rs:801-817).

    The sum is strictly SEQUENTIAL (np.cumsum's scan order — bit-identical
    to the reference's Rust accumulation loop and to the native
    qual_fields_batch kernel), not np.mean's pairwise blocking, so the
    batched variants in stage1_kmers produce bit-identical values — est_id
    is a sort key and appears in outputs, so every path must agree."""
    if phred is None:
        return None
    p = error_probs_from_phred(phred)
    if len(p) == 0:
        return float("nan")
    total = np.cumsum(p)[-1]
    return float(100.0 - total / len(p) * 100.0)


def bin_qualities(phred_plus33: np.ndarray, bin_size: int = 4) -> np.ndarray:
    """Min-of-bin ASCII qualities -> binned array (seeding.rs:578-602).

    Input is the raw ASCII (q+33) values; output one value per bin (min).
    """
    n = len(phred_plus33)
    nbins = (n + bin_size - 1) // bin_size
    padded = np.full(nbins * bin_size, 255, dtype=np.uint8)
    padded[:n] = phred_plus33
    return padded.reshape(nbins, bin_size).min(axis=1)


def quantize_qual_bin(binned_ascii: np.ndarray) -> np.ndarray:
    """QualCompact3 4-bit codec (types.rs:417-491): ASCII value -> 0..15 level."""
    b = binned_ascii.astype(np.int32)
    # try_from_bits: 0..=34 -> 0; 35..=37 -> 1; ...; >=77 -> 15
    lvl = np.clip((b - 32) // 3, 0, 15)
    # exact per-range parity: level L covers [32+3L, 34+3L] with low clamp at 0
    lvl = np.where(b <= 34, 0, np.clip((b - 35) // 3 + 1, 0, 15))
    return lvl.astype(np.uint8)


def expand_binned_qualities(levels: np.ndarray, seq_len: int, bin_size: int = 4) -> np.ndarray:
    """QualCompact3 levels -> per-base ASCII qualities (utils.rs:189-211).

    value = level*3 + 33, repeated bin_size times, truncated/extended to seq_len.
    """
    q = (levels.astype(np.int32) * 3 + 33).astype(np.uint8)
    expanded = np.repeat(q, bin_size)
    if len(expanded) >= seq_len:
        return expanded[:seq_len]
    pad_val = expanded[-1] if len(expanded) else np.uint8(33)
    return np.concatenate([expanded, np.full(seq_len - len(expanded), pad_val, dtype=np.uint8)])


def homopolymer_compress(seq: np.ndarray, do_hpc: bool) -> tuple[np.ndarray, np.ndarray]:
    """HPC compress a byte/code array -> (hpc_seq, run_lengths) (utils.rs:70-109).

    Runs longer than 255 are split (reference caps run length at u8 max).
    """
    seq = np.asarray(seq)
    if not do_hpc or len(seq) == 0:
        return seq.copy(), np.ones(len(seq), dtype=np.uint8)
    change = np.empty(len(seq), dtype=bool)
    change[0] = True
    change[1:] = seq[1:] != seq[:-1]
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], len(seq))
    lens = ends - starts
    # split runs > 255
    if (lens > 255).any():
        out_s, out_l = [], []
        for s, L in zip(starts, lens):
            while L > 255:
                out_s.append(s)
                out_l.append(255)
                s += 255
                L -= 255
            out_s.append(s)
            out_l.append(L)
        starts = np.array(out_s)
        lens = np.array(out_l)
    return seq[starts], lens.astype(np.uint8)


def homopolymer_compress_with_quality(
    seq: np.ndarray, qual: np.ndarray, do_hpc: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HPC compress with per-run MIN quality (utils.rs:135-184).

    Returns (hpc_seq, hpc_quals, run_lengths).  Mirrors the reference
    exactly: empty or length-mismatched inputs return three empty arrays;
    runs longer than 255 split (u8 cap), each split segment carrying the
    min quality of ITS OWN span; do_hpc=False passes through with
    run_lengths of 1.
    """
    seq = np.asarray(seq)
    qual = np.asarray(qual, dtype=np.uint8)
    if len(seq) == 0 or len(seq) != len(qual):
        return seq[:0].copy(), qual[:0].copy(), np.zeros(0, dtype=np.uint8)
    if not do_hpc:
        return seq.copy(), qual.copy(), np.ones(len(seq), dtype=np.uint8)
    change = np.empty(len(seq), dtype=bool)
    change[0] = True
    change[1:] = seq[1:] != seq[:-1]
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], len(seq))
    lens = ends - starts
    if (lens > 255).any():
        out_s, out_l = [], []
        for s, L in zip(starts, lens):
            while L > 255:
                out_s.append(s)
                out_l.append(255)
                s += 255
                L -= 255
            out_s.append(s)
            out_l.append(L)
        starts = np.array(out_s)
        lens = np.array(out_l)
    hq = np.minimum.reduceat(qual, starts)
    return seq[starts], hq, lens.astype(np.uint8)


def homopolymer_decompress(hpc_seq: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Inverse of homopolymer_compress (utils.rs:114-130)."""
    if len(hpc_seq) != len(lens):
        return np.asarray(hpc_seq).copy()
    return np.repeat(np.asarray(hpc_seq), np.asarray(lens).astype(np.int64))
