"""SINTAX on the card: the references' k-mers (kernel 6,
csrc/sintax_ref_kmers.cu), the scores (kernel 3, csrc/sintax_scores.cu),
and their plain PyTorch versions.

Kernel 6 has no counterpart in the JAX package, which extracts each
reference's k-mers on the host (pipeline/sintax.py, np.unique of
extract_kmers).  `sintax_ref_kmers(rows)` takes a chunk's references back to
back (`ref_rows` joins them on the host, `ref_rows_on` uploads them) and
gives each row its capacity of max(len - 11, 0) values: its sorted unique
canonical 12-mers, then ROW_PAD, the layout the lower entry of kernel 3
reads.

Counterpart in the JAX package: parallel/mesh.py sharded_sintax_scores, the
XLA step of its device route (SAVONT_SINTAX_BACKEND=jax), on one device.
Per (ASV, iteration) pair, the best key over reference rows, where a row's
key is (score << 26) | (0x3FFFFFF - ordinal) for a score above 0 (how many
of the pair's 32 subsampled k-mers occur in the row, a repeated slot
counting each time) and 0 otherwise.  Maximising it keeps the highest score
and, among equal scores, the earliest reference: the host stream's rule.

Two entries compute it:
- `sintax_scores(queries, refk, ridx, acc)` takes the JAX step's layout, a
  (P, 32) query matrix and rows padded to a common length, and builds what
  the lower entry takes from them;
- `sintax_scores_rows(index, kmers, row_off, ridx, acc)`, what the sintax
  route calls: the run's query index (`query_index`, the host stream's CSR
  form: sorted distinct query k-mers, offsets, a pair id per live slot) and
  the chunk's rows back to back (`ragged_rows`, or kernel 6's rows, whose
  pads count as misses).
Each runs the plain version only for tensors on the CPU, and for CUDA
tensors launches the kernel or raises.  `sintax_scores_dense` is the
one-shot PyTorch composition over padded rows (torch.searchsorted of every
slot in every row): the yardstick a timing puts beside the kernel, used
nowhere in the port.

Types on the torch side: k-mers are int32 (12-mers are below 2^24); the
JAX step's uint32 row pad 0xFFFFFFFF and query sentinel 0xFFFFFFFE become
ROW_PAD and QUERY_SENTINEL, which no k-mer takes and which keep rows
sorted; the keys need 32 unsigned bits (a score of 32 sets bit 31), so the
accumulator is an int32 tensor holding their bits (the kernel's unsigned
atomicMax) and keys_int64 reads it as int64.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .align_torch import launch_on
from .build import build_kernels
from .kmers_torch import _pack

LAUNCHES = {"sintax_scores": 0, "sintax_ref_kmers": 0}
REFERENCE_CALLS = {"sintax_scores": 0, "sintax_ref_kmers": 0}

SLOTS = 32                   # subsampled k-mers per pair (constants.SINTAX_SUBSAMPLE)
K = 12                       # the k-mers' length (constants.SINTAX_K)
ROW_PAD = 0x7FFFFFFF         # past a row's last k-mer: above every k-mer and slot
QUERY_SENTINEL = 0x7FFFFFFE  # the slots of a k-mer-less ASV: equal to no row value
ORD_MASK = 0x3FFFFFF
INT32_MAX = 0x7FFFFFFF
PLAIN_COUNTS = 1 << 24       # (row, pair) counts per step of the plain version
PLAIN_ELEMENTS = 1 << 24     # searches per step of the dense composition


# a byte's 2-bit code (pipeline/sintax._BYTE_CODE): A/a 0, C/c 1, G/g 2,
# T/t/U/u 3, any other byte 0
BYTE_CODE = torch.zeros(256, dtype=torch.int64)
for _bases, _code in ((b"Cc", 1), (b"Gg", 2), (b"TtUu", 3)):
    BYTE_CODE[list(_bases)] = _code


class QueryIndex(NamedTuple):
    """The run's query index on a device (query_index's arrays as int32)."""
    keys: torch.Tensor   # (D,) sorted distinct query k-mers of the live slots
    off: torch.Tensor    # (D + 1,) CSR offsets into pairs
    pairs: torch.Tensor  # (M,) a pair id per live slot, ascending within a key
    n_pairs: int


def reset_counters() -> None:
    for d in (LAUNCHES, REFERENCE_CALLS):
        for k in d:
            d[k] = 0


def kernel_kmers(a: np.ndarray) -> np.ndarray:
    """uint32 k-mers in the JAX package's convention (row pad 0xFFFFFFFF,
    query sentinel 0xFFFFFFFE) as the int32 values the kernel takes."""
    a = np.asarray(a, dtype=np.uint32)
    out = a.astype(np.int32)
    out[a == np.uint32(0xFFFFFFFF)] = ROW_PAD
    out[a == np.uint32(0xFFFFFFFE)] = QUERY_SENTINEL
    return out


def keys_int64(acc: torch.Tensor) -> torch.Tensor:
    """The accumulator's unsigned 32-bit keys as int64."""
    return acc.long() & 0xFFFFFFFF


def query_index(subs: np.ndarray, sentinel) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host stream's query map of a (pairs, slots) matrix in CSR form:
    keys, the sorted distinct k-mers of the slots that are not `sentinel`
    (subs' dtype); off (D + 1,) int64, key i's entries are off[i]:off[i+1];
    pairs (M,) int64, the pair of each live slot, a slot that repeats in a
    pair kept each time, ascending within a key."""
    live = subs.reshape(-1) != sentinel
    pair_of = np.repeat(np.arange(subs.shape[0], dtype=np.int64), subs.shape[1])[live]
    flat = subs.reshape(-1)[live]
    order = np.argsort(flat, kind="stable")
    flat, pair_of = flat[order], pair_of[order]
    keys = np.unique(flat)
    off = np.append(np.searchsorted(flat, keys, side="left"), len(flat)).astype(np.int64)
    return keys, off, pair_of


def index_on(keys: np.ndarray, off: np.ndarray, pairs: np.ndarray, n_pairs: int,
             device) -> QueryIndex:
    """query_index's arrays as the int32 tensors of a QueryIndex on `device`
    (the one upload of a run)."""
    if len(keys) and (int(keys.min()) < 0 or int(keys.max()) > INT32_MAX) or len(pairs) > INT32_MAX:
        raise ValueError("query index: keys must lie in [0, 2^31) and entries number below 2^31")
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
    return QueryIndex(as32(keys), as32(off), as32(pairs), int(n_pairs))


def ragged_rows(rows: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Reference rows (each its unique k-mers) back to back: kmers (N,) int32
    and row_off (R + 1,) int64, row r being kmers[row_off[r]:row_off[r+1]]."""
    row_off = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in rows], out=row_off[1:])
    kmers = np.concatenate(rows).astype(np.int32) if rows else np.zeros(0, np.int32)
    return kmers, row_off


class RefRows(NamedTuple):
    """A chunk's references back to back on a device, with kernel 6's
    output layout."""
    seqs: torch.Tensor     # (B,) uint8, their bytes
    off: torch.Tensor      # (R + 1,) int64, reference r = seqs[off[r]:off[r + 1]]
    row_off: torch.Tensor  # (R + 1,) int64, row r's capacity max(len - 11, 0) summed
    max_n: int             # the largest capacity
    n_kmers: int           # row_off[R]


def ref_rows(seqs: list[bytes]) -> tuple[bytearray, np.ndarray, np.ndarray]:
    """The host's share of kernel 6's input: the references' bytes joined,
    off (R + 1,) int64 byte offsets and row_off (R + 1,) int64, the rows'
    capacities max(len - 11, 0) summed."""
    lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
    off = np.zeros(len(seqs) + 1, dtype=np.int64)
    row_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    np.cumsum(np.maximum(lens - (K - 1), 0), out=row_off[1:])
    return bytearray().join(seqs), off, row_off


def ref_rows_on(joined, off: np.ndarray, row_off: np.ndarray, device) -> RefRows:
    """ref_rows' arrays as a RefRows on `device` (one upload each); "cuda"
    without a card raises."""
    device = resolve_device(device)
    caps = np.diff(row_off)
    if off[0] != 0 or row_off[0] != 0 or len(joined) != off[-1] or \
            not np.array_equal(caps, np.maximum(np.diff(off) - (K - 1), 0)):
        raise ValueError("ref rows: off must span the bytes, and row_off from 0 hold "
                         "max(len - 11, 0) a row")
    u8 = torch.uint8
    seqs = torch.frombuffer(joined, dtype=u8) if len(joined) else torch.zeros(0, dtype=u8)
    as_t = lambda a: torch.from_numpy(a).to(device)
    return RefRows(seqs.to(device), as_t(off), as_t(row_off), int(caps.max(initial=0)),
                   int(row_off[-1]))


def _check(named, device) -> None:
    for name, x, nd, dtype in named:
        if x.dtype != dtype or x.dim() != nd or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {nd}-D {dtype} tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")


def sintax_scores(queries, refk, ridx, acc) -> torch.Tensor:
    """acc[p] = max(acc[p], best key of pair p over the rows of refk), in the
    JAX step's layout.

    queries (P, 32) int32, refk (R, L) int32 rows sorted ascending and padded
    with ROW_PAD, ridx (R,) int32 ordinals below 2^26, acc (P,) int32 holding
    unsigned keys (zeros to start).  Builds the query index (on the host) and
    the ragged rows (the padding and repeats stripped) and calls
    sintax_scores_rows.  Returns acc."""
    i32 = torch.int32
    _check((("queries", queries, 2, i32), ("refk", refk, 2, i32), ("ridx", ridx, 1, i32),
            ("acc", acc, 1, i32)), queries.device)
    P, S = queries.shape
    if S != SLOTS or ridx.shape[0] != refk.shape[0] or acc.shape[0] != P:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)} (need {SLOTS} slots) "
                         f"refk {tuple(refk.shape)} ridx {tuple(ridx.shape)} acc {tuple(acc.shape)}")
    if refk.shape[1] < 1:
        raise ValueError("refk: rows need at least one column")
    index = index_on(*query_index(queries.cpu().numpy(), QUERY_SENTINEL), P, queries.device)
    return sintax_scores_rows(index, *unpadded_rows(refk), ridx, acc)


def unpadded_rows(refk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted rows padded with ROW_PAD, (R, L), as ragged_rows' layout on
    their device: kmers, the rows' values back to back with the padding and
    repeats dropped, and row_off (R + 1,) int64."""
    keep = refk != ROW_PAD
    keep[:, 1:] &= refk[:, 1:] != refk[:, :-1]
    row_off = torch.zeros(refk.shape[0] + 1, dtype=torch.int64, device=refk.device)
    torch.cumsum(keep.sum(dim=1), 0, out=row_off[1:])
    return refk[keep], row_off


def _check_rows(index: QueryIndex, kmers, row_off, ridx, acc) -> None:
    i32 = torch.int32
    _check((("keys", index.keys, 1, i32), ("off", index.off, 1, i32),
            ("pairs", index.pairs, 1, i32), ("kmers", kmers, 1, i32),
            ("row_off", row_off, 1, torch.int64), ("ridx", ridx, 1, i32),
            ("acc", acc, 1, i32)), acc.device)
    if index.off.shape[0] != index.keys.shape[0] + 1 or acc.shape[0] != index.n_pairs or \
            row_off.shape[0] != ridx.shape[0] + 1:
        raise ValueError(f"shape mismatch: keys {tuple(index.keys.shape)} off "
                         f"{tuple(index.off.shape)} n_pairs {index.n_pairs} acc "
                         f"{tuple(acc.shape)} row_off {tuple(row_off.shape)} ridx {tuple(ridx.shape)}")


def sintax_scores_rows(index: QueryIndex, kmers, row_off, ridx, acc) -> torch.Tensor:
    """acc[p] = max(acc[p], best key of pair p over the rows), the route's
    entry.  index: the run's QueryIndex; kmers (N,) int32, the rows back to
    back, each row's k-mers unique; row_off (R + 1,) int64; ridx (R,) int32
    ordinals below 2^26; acc (P,) int32 holding unsigned keys.  CPU tensors
    take the plain PyTorch version; CUDA tensors launch kernel 3 or raise.
    Returns acc."""
    _check_rows(index, kmers, row_off, ridx, acc)
    if acc.device.type == "cpu":
        REFERENCE_CALLS["sintax_scores"] += 1
        return sintax_scores_rows_reference(index, kmers, row_off, ridx, acc)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    return sintax_scores_rows_launch(index, kmers, row_off, ridx, acc)


def sintax_scores_rows_launch(index: QueryIndex, kmers, row_off, ridx, acc) -> torch.Tensor:
    """Launch kernel 3 on CUDA tensors that sintax_scores_rows' checks have
    passed or would pass, without checking them: what a timing queues back
    to back."""
    if acc.device.type != "cuda":
        raise ValueError(f"sintax_scores_rows_launch needs CUDA tensors, got {acc.device}")
    lib = build_kernels()
    with launch_on(acc.device):
        rc = lib.sintax_scores_launch(
            index.keys.data_ptr(), index.keys.shape[0], index.off.data_ptr(),
            index.pairs.data_ptr(), index.n_pairs, kmers.data_ptr(), row_off.data_ptr(),
            ridx.data_ptr(), ridx.shape[0], acc.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sintax_scores kernel launch failed: CUDA error {rc}")
    LAUNCHES["sintax_scores"] += 1
    return acc


def sintax_ref_kmers(rows: RefRows) -> torch.Tensor:
    """Each reference row's sorted unique canonical 12-mers, then ROW_PAD to
    its capacity: kmers (rows.n_kmers,) int32, row r at
    rows.row_off[r]:rows.row_off[r + 1], the lower entry's layout.  A row
    equals np.unique(extract_kmers(seq.upper())) of pipeline/sintax, padded.
    CPU tensors take the plain PyTorch version; CUDA tensors launch kernel 6
    or raise."""
    _check((("seqs", rows.seqs, 1, torch.uint8), ("off", rows.off, 1, torch.int64),
            ("row_off", rows.row_off, 1, torch.int64)), rows.seqs.device)
    if rows.off.shape[0] < 1 or rows.row_off.shape[0] != rows.off.shape[0] or \
            not 0 <= rows.max_n <= INT32_MAX or rows.off.shape[0] - 1 > INT32_MAX:
        raise ValueError(f"ref rows: off {tuple(rows.off.shape)} and row_off "
                         f"{tuple(rows.row_off.shape)} need one entry a row and one more, "
                         f"rows and capacities below 2^31 (max_n {rows.max_n})")
    dev = rows.seqs.device
    if dev.type == "cpu":
        REFERENCE_CALLS["sintax_ref_kmers"] += 1
        return sintax_ref_kmers_reference(rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return sintax_ref_kmers_launch(rows, torch.empty(rows.n_kmers, dtype=torch.int32, device=dev))


def sintax_ref_kmers_launch(rows: RefRows, out: torch.Tensor) -> torch.Tensor:
    """Launch kernel 6 into out (rows.n_kmers int32) without checking: what
    a timing queues back to back."""
    if out.device.type != "cuda":
        raise ValueError(f"sintax_ref_kmers_launch needs CUDA tensors, got {out.device}")
    lib = build_kernels()
    with launch_on(out.device):
        rc = lib.sintax_ref_kmers_launch(
            rows.seqs.data_ptr(), rows.seqs.shape[0], rows.off.data_ptr(), rows.row_off.data_ptr(),
            rows.off.shape[0] - 1, rows.max_n, out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sintax_ref_kmers kernel launch failed: CUDA error {rc}")
    LAUNCHES["sintax_ref_kmers"] += 1
    return out


def sintax_ref_kmers_reference(rows: RefRows) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: every position's forward and
    reverse-complement 12-mers (kmers_torch._pack over the bytes' codes),
    their minimum keyed by its row, torch.unique of the keys (sorted), and
    each row's distinct k-mers at the front of its capacity, on the rows'
    device.  The same function as the kernel, bit for bit."""
    seqs, off, row_off, _, n = rows
    dev = seqs.device
    out = torch.full((n,), ROW_PAD, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    R = off.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(R, device=dev), row_off[1:] - row_off[:-1])
    start = off[:-1][row] + torch.arange(n, device=dev) - row_off[:-1][row]
    fwd, rev = _pack(BYTE_CODE.to(dev)[seqs.long()], start, K)
    key = torch.unique((row << 2 * K) | torch.minimum(fwd, rev))
    krow = key >> 2 * K
    rank = torch.arange(key.shape[0], device=dev) - torch.searchsorted(key, krow << 2 * K)
    out[row_off[krow] + rank] = (key & ((1 << 2 * K) - 1)).to(torch.int32)
    return out


def _store_keys(acc: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    acc.copy_(torch.where(best >= 1 << 31, best - (1 << 32), best).to(torch.int32))
    return acc


def sintax_scores_rows_reference(index: QueryIndex, kmers, row_off, ridx, acc) -> torch.Tensor:
    """Plain PyTorch version of kernel 3 on the lower entry's inputs:
    torch.searchsorted of each row k-mer among the keys, the hit ranges
    expanded to their pair ids, per-row counts (a step of rows at a time),
    keys and their max, in int64.  The same function as the kernel, bit for
    bit."""
    keys, off, pairs, P = index
    D, R = keys.shape[0], ridx.shape[0]
    best = keys_int64(acc)
    if D == 0 or R == 0 or P == 0:
        return acc
    off64 = off.long()
    step = max(1, PLAIN_COUNTS // P)
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        lo, hi = int(row_off[r0]), int(row_off[r1])
        x = kmers[lo:hi]
        row_of = torch.repeat_interleave(torch.arange(r1 - r0, device=x.device),
                                         row_off[r0 + 1 : r1 + 1] - row_off[r0:r1])
        pos = torch.searchsorted(keys, x).clamp(max=D - 1)
        hit = keys[pos] == x
        k, rows = pos[hit], row_of[hit]
        lens = off64[k + 1] - off64[k]
        n = int(lens.sum())
        if n == 0:
            continue
        first = torch.cumsum(lens, 0) - lens
        entry = (torch.repeat_interleave(off64[k] - first, lens)
                 + torch.arange(n, device=x.device))
        flat = torch.repeat_interleave(rows, lens) * P + pairs[entry].long()
        score = torch.bincount(flat, minlength=(r1 - r0) * P).view(r1 - r0, P)
        key = torch.where(score > 0,
                          (score << 26) | (ORD_MASK - (ridx[r0:r1, None].long() & ORD_MASK)), 0)
        best = torch.maximum(best, key.amax(dim=0))
    return _store_keys(acc, best)


def sintax_scores_dense(queries, refk, ridx, acc) -> torch.Tensor:
    """The same function as a composition of PyTorch calls on the JAX step's
    layout: torch.searchsorted of every slot in every padded row (a step of
    rows at a time), the hit sum and the key max, in int64.  The yardstick
    beside the kernel's time (the library time), used nowhere in the port."""
    P = queries.shape[0]
    R, L = refk.shape
    flat = queries.reshape(1, -1)
    best = keys_int64(acc)
    step = max(1, PLAIN_ELEMENTS // max(flat.shape[1], 1))
    for r0 in range(0, R, step):
        rows = refk[r0 : r0 + step]
        pos = torch.searchsorted(rows, flat.expand(rows.shape[0], -1).contiguous())
        hit = rows.gather(1, pos.clamp(max=L - 1)) == flat
        score = hit.view(rows.shape[0], P, SLOTS).sum(dim=2).long()
        key = torch.where(score > 0,
                          (score << 26) | (ORD_MASK - (ridx[r0 : r0 + step, None].long() & ORD_MASK)), 0)
        best = torch.maximum(best, key.amax(dim=0))
    return _store_keys(acc, best)
