"""Stage-1 device k-mers on the card (kernels 4 and 5) and their plain
PyTorch versions.

Counterparts in the JAX package, ops/kmers_jax.py (XLA element-wise code,
not Pallas):
- split_kmers_batch (kernel 4, csrc/split_kmers.cu): per read position the
  canonical split k-mer with its strand flag in bit 63, and its validity
  (split_kmer_mid's semantics, seeding.rs:975-1068);
- syncmer_batch with _mm_hash64_planes (kernel 5, csrc/syncmers.cu): the
  open-syncmer scan (seeding.rs:527-543); nothing on the main path calls
  it, as in the JAX package;
- device_split_kmers: the flagged k-mers of each read, in position order.

Layout: the reads back to back (ReadBatch, built by read_batch), the way
kernel 3 takes its rows: codes (B,) uint8 2-bit codes 0..3, phred (B,)
uint8 beside them or None (no quality gate), off (N + 1,) int64 with read
r = codes[off[r]:off[r + 1]].  A read of length L has max(L - k + 1, 0)
positions; outputs hold every position of every read, back to back in
read order, read r's at out_off[r]:out_off[r + 1].

The JAX module pads reads to multiples of 256 and carries 64-bit k-mers as
(hi, lo) uint32 planes, for the TPU's static shapes and 32-bit integer
units.  The kernels compute in unsigned long long.  PyTorch holds a 64-bit
value as the int64 of its bits, so a key with bit 63 set is negative, and
the plain mm_hash64 works on 32-bit planes in int64 (no signed overflow,
and logical shifts by masking).  Each wrapper runs the plain version only
for tensors on the CPU, and for CUDA tensors launches its kernel or
raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .align_torch import launch_on
from .build import build_kernels
from .kmers_native import _concat

LAUNCHES = {"split_kmers": 0, "syncmers": 0}
REFERENCE_CALLS = {"split_kmers": 0, "syncmers": 0}

MAX_K = 31                 # 2k bits of a k-mer fit below the strand flag
FLAG = -(1 << 63)          # bit 63 as an int64
BARE = (1 << 63) - 1       # the k-mer bits below it
M32 = 0xFFFFFFFF


class ReadBatch(NamedTuple):
    """Reads back to back on a device, with the output layout for k."""
    codes: torch.Tensor            # (B,) uint8, 0..3
    phred: torch.Tensor | None     # (B,) uint8, or None: no quality gate
    off: torch.Tensor              # (N + 1,) int64
    out_off: torch.Tensor          # (N + 1,) int64, positions of read r: out_off[r]:out_off[r+1]
    k: int
    n_pos: int


def reset_counters() -> None:
    for d in (LAUNCHES, REFERENCE_CALLS):
        for key in d:
            d[key] = 0


def _out_offsets(off: np.ndarray, k: int) -> np.ndarray:
    """Each read's first output position, (N + 1,) int64: max(L - k + 1, 0)
    positions a read."""
    npos = np.maximum(np.diff(off) - (k - 1), 0)
    out = np.zeros(len(off), dtype=np.int64)
    np.cumsum(npos, out=out[1:])
    return out


def read_batch(code_list, phred_list, k: int, device) -> ReadBatch:
    """The reads (uint8 code arrays, and phred arrays or None) back to back
    on `device`, uploaded once.  A read without qualities in a batch that
    has some gets an all-equal row, which turns its gate off, as the JAX
    package's zero padding does."""
    if k < 1 or k > MAX_K:
        raise ValueError(f"k must lie in [1, {MAX_K}], got {k}")
    codes, ph, off = _concat(list(code_list), phred_list)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    oo = _out_offsets(off, k)
    return ReadBatch(as_t(codes), None if ph is None else as_t(ph), as_t(off), as_t(oo),
                     k, int(oo[-1]))


def _check(batch: ReadBatch) -> torch.device:
    dev = batch.codes.device
    named = [("codes", batch.codes, torch.uint8), ("off", batch.off, torch.int64),
             ("out_off", batch.out_off, torch.int64)]
    if batch.phred is not None:
        named.append(("phred", batch.phred, torch.uint8))
    for name, x, dtype in named:
        if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: expected a contiguous 1-D {dtype} tensor on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if batch.off.shape[0] < 1 or batch.out_off.shape[0] != batch.off.shape[0]:
        raise ValueError(f"off {tuple(batch.off.shape)} and out_off {tuple(batch.out_off.shape)} "
                         "need one entry a read and one more")
    if batch.phred is not None and batch.phred.shape[0] != batch.codes.shape[0]:
        raise ValueError(f"phred {tuple(batch.phred.shape)} differs from codes "
                         f"{tuple(batch.codes.shape)}")
    if batch.k < 1 or batch.k > MAX_K:
        raise ValueError(f"k must lie in [1, {MAX_K}], got {batch.k}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ── kernel 4: split k-mers ───────────────────────────────────────────────


def split_kmers_batch(batch: ReadBatch, min_bq: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per position of every read (batch.n_pos): keys int64, the canonical
    split k-mer (the strand whose masked k-mer is smaller, the middle base
    masked in the comparison only) with bit 63 set when it is the forward
    one; valid uint8, 1 unless the masked k-mer is a palindrome or the
    middle base's quality is below min_bq, a gate that is off for a read
    whose qualities are all equal or absent.  k odd."""
    dev = _check(batch)
    if batch.k % 2 != 1:
        raise ValueError(f"split k-mers need an odd k, got {batch.k}")
    if dev.type == "cpu":
        REFERENCE_CALLS["split_kmers"] += 1
        return split_kmers_batch_reference(batch, min_bq)
    keys = torch.empty(batch.n_pos, dtype=torch.int64, device=dev)
    valid = torch.empty(batch.n_pos, dtype=torch.uint8, device=dev)
    return split_kmers_launch(batch, min_bq, keys, valid)


def split_kmers_launch(batch: ReadBatch, min_bq: int, keys, valid):
    """Launch kernel 4 into keys / valid (n_pos each) without checking:
    what a timing queues back to back."""
    lib = build_kernels()
    with launch_on(keys.device):
        rc = lib.split_kmers_launch(
            batch.codes.data_ptr(), batch.phred.data_ptr() if batch.phred is not None else None,
            batch.off.data_ptr(), batch.out_off.data_ptr(), batch.off.shape[0] - 1, batch.k,
            int(min_bq), keys.data_ptr(), valid.data_ptr(), _stream(),
        )
    if rc != 0:
        raise RuntimeError(f"split_kmers kernel launch failed: CUDA error {rc}")
    LAUNCHES["split_kmers"] += 1
    return keys, valid


def _starts(batch: ReadBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """For every output position its read and the flat index of its first
    base."""
    dev = batch.codes.device
    n = batch.off.shape[0] - 1
    read = torch.repeat_interleave(torch.arange(n, device=dev), batch.out_off[1:] - batch.out_off[:-1])
    start = batch.off[:-1][read] + torch.arange(batch.n_pos, device=dev) - batch.out_off[:-1][read]
    return read, start


def _pack(codes: torch.Tensor, start: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward (first base most significant) and reverse-complement packed
    k-mers at the given starts, int64."""
    fwd = torch.zeros(start.shape[0], dtype=torch.int64, device=start.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[start + j].long()
        fwd = (fwd << 2) | c
        rev = rev | ((3 - c) << (2 * j))
    return fwd, rev


def _canonical(fwd, rev, k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k-mer of the strand whose masked k-mer is smaller, the reverse on a
    tie; forward chosen; masked palindrome)."""
    mask = ~(3 << (k - 1))
    sf, sr = fwd & mask, rev & mask
    canon = sf < sr
    return torch.where(canon, fwd, rev), canon, sf == sr


def _all_equal(phred: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Per read: every quality equals its first (an empty read: True)."""
    n = off.shape[0] - 1
    lens = off[1:] - off[:-1]
    read = torch.repeat_interleave(torch.arange(n, device=phred.device), lens)
    first = phred[off[:-1][read]]
    return torch.bincount(read[phred != first], minlength=n) == 0


def split_kmers_batch_reference(batch: ReadBatch, min_bq: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 4, bit for bit."""
    k = batch.k
    read, start = _starts(batch)
    fwd, rev = _pack(batch.codes, start, k)
    kmer, canon, pal = _canonical(fwd, rev, k)
    keys = torch.where(canon, kmer | FLAG, kmer)
    valid = ~pal
    if batch.phred is not None:
        gate_off = _all_equal(batch.phred, batch.off)[read]
        valid &= gate_off | (batch.phred[start + k // 2].int() >= min_bq)
    return keys, valid.to(torch.uint8)


# ── kernel 5: open syncmers ──────────────────────────────────────────────


def _planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (x >> 32) & M32, x & M32


def _join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) 32-bit planes -> the int64 of their 64 bits (a product that
    stays in range, where a shift into the sign bit would not)."""
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


def _mm_hash64_planes(hi: torch.Tensor, lo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """mm_hash64 (seeding.rs:18-28) on 32-bit planes held in int64, every
    intermediate below 2^63."""

    def add(a, b):
        s = a[1] + b[1]
        return (a[0] + b[0] + (s >> 32)) & M32, s & M32

    def shl(a, n):
        h, l = a
        if n >= 32:
            return (l << (n - 32)) & M32, torch.zeros_like(l)
        return ((h << n) | (l >> (32 - n))) & M32, (l << n) & M32

    def shr(a, n):
        h, l = a
        return h >> n, ((l >> n) | (h << (32 - n))) & M32  # 0 < n < 32

    def xor(a, b):
        return a[0] ^ b[0], a[1] ^ b[1]

    key = (hi, lo)
    key = add((M32 ^ key[0], M32 ^ key[1]), shl(key, 21))
    key = xor(key, shr(key, 24))
    key = add(add(key, shl(key, 3)), shl(key, 8))
    key = xor(key, shr(key, 14))
    key = add(add(key, shl(key, 2)), shl(key, 4))
    key = xor(key, shr(key, 28))
    return add(key, shl(key, 31))


def mm_hash64(x: torch.Tensor) -> torch.Tensor:
    """minimap2's mm_hash64 of int64 tensors holding uint64 bits."""
    return _join(*_mm_hash64_planes(*_planes(x.long())))


def syncmer_batch(batch: ReadBatch, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per position of every read: is_syncmer uint8, 1 when the mm_hash64 of
    the canonical s-mer (s = k - c + 1) at the window's centre, (k - s) // 2,
    is strictly below the other k - s hashes of the k-mer's window; and the
    canonical k-mer int64 (masked comparison, the reverse on ties)."""
    dev = _check(batch)
    if not 1 <= c <= batch.k:
        raise ValueError(f"c must lie in [1, k = {batch.k}], got {c}")
    if dev.type == "cpu":
        REFERENCE_CALLS["syncmers"] += 1
        return syncmer_batch_reference(batch, c)
    flags = torch.empty(batch.n_pos, dtype=torch.uint8, device=dev)
    kmers = torch.empty(batch.n_pos, dtype=torch.int64, device=dev)
    return syncmer_launch(batch, c, flags, kmers)


def syncmer_launch(batch: ReadBatch, c: int, flags, kmers):
    """Launch kernel 5 into flags / kmers (n_pos each) without checking."""
    lib = build_kernels()
    with launch_on(flags.device):
        rc = lib.syncmers_launch(
            batch.codes.data_ptr(), batch.off.data_ptr(), batch.out_off.data_ptr(),
            batch.off.shape[0] - 1, batch.k, batch.k - c + 1, flags.data_ptr(),
            kmers.data_ptr(), _stream(),
        )
    if rc != 0:
        raise RuntimeError(f"syncmers kernel launch failed: CUDA error {rc}")
    LAUNCHES["syncmers"] += 1
    return flags, kmers


def syncmer_batch_reference(batch: ReadBatch, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 5, bit for bit.  The s-mers are
    hashed at every flat start (those that cross a read's end are never
    read) and compared as order-preserving int64 ((hi - 2^31) * 2^32 + lo)."""
    k = batch.k
    s = k - c + 1
    _, start = _starts(batch)
    B = batch.codes.shape[0]
    sf, sr = _pack(batch.codes, torch.arange(max(B - s + 1, 0), device=start.device), s)
    hi, lo = _mm_hash64_planes(*_planes(torch.minimum(sf, sr)))
    h = (hi - (1 << 31)) * (1 << 32) + lo
    mid = (k - s) // 2
    centre = h[start + mid]
    ok = torch.ones(batch.n_pos, dtype=torch.bool, device=start.device)
    for j in range(k - s + 1):
        if j != mid:
            ok &= centre < h[start + j]
    kmer, _, _ = _canonical(*_pack(batch.codes, start, k), k)
    return ok.to(torch.uint8), kmer


# ── per-read lists ───────────────────────────────────────────────────────


def flagged_on_device(code_list, phred_list, k: int, min_bq: int, dev: torch.device,
                      per_read: bool = False):
    """The reads' flagged canonical split k-mers on `dev`: one upload,
    kernel 4, and the valid keys compacted on the device.  Returns (the
    batch, the kept keys int64 in read and position order, and with
    per_read each read's (N + 1,) bounds into them, else None)."""
    batch = read_batch(code_list, phred_list, k, dev)
    keys, valid = split_kmers_batch(batch, min_bq)
    v = valid.bool()
    kept = keys[v]
    bounds = None
    if per_read:
        seen = torch.zeros(batch.n_pos + 1, dtype=torch.int64, device=dev)
        seen[1:] = torch.cumsum(v, 0)
        bounds = seen[batch.out_off]
    return batch, kept, bounds


def device_split_kmers(code_list, phred_list, k: int, min_bq: int, device,
                       stats: dict | None = None) -> list[np.ndarray]:
    """Stage-1 extraction on `device`: per read, its flagged canonical
    split k-mers (uint64, bit 63 the strand flag) in position order, what
    ops.kmers.split_kmer_mid returns.  flagged_on_device, then one fetch.
    With `stats`, the sizes are added to positions and flagged."""
    dev = resolve_device(device)
    batch, kept, bounds = flagged_on_device(code_list, phred_list, k, min_bq, dev, per_read=True)
    bounds, flat = bounds.cpu().numpy(), kept.cpu().numpy().view(np.uint64)
    if stats is not None:
        stats["positions"] += batch.n_pos
        stats["flagged"] += len(flat)
    return [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
