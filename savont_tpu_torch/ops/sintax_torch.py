"""SINTAX scores on the card (kernel 3, csrc/sintax_scores.cu) and its plain
PyTorch version.

Counterpart in the JAX package: parallel/mesh.py sharded_sintax_scores, the
XLA step of its device route (SAVONT_SINTAX_BACKEND=jax), on one device.
Per (ASV, iteration) pair, the best key over reference rows, where a row's
key is (score << 26) | (0x3FFFFFF - ordinal) for a score above 0 (how many
of the pair's 32 subsampled k-mers occur in the row, a repeated slot
counting each time) and 0 otherwise.  Maximising it keeps the highest score
and, among equal scores, the earliest reference: the host stream's rule.

Types on the torch side: k-mers are int32 (12-mers are below 2^24); the
JAX step's uint32 row pad 0xFFFFFFFF and query sentinel 0xFFFFFFFE become
ROW_PAD and QUERY_SENTINEL, which no k-mer takes and which keep rows
sorted; the keys need 32 unsigned bits (a score of 32 sets bit 31), so the
accumulator is an int32 tensor holding their bits (the kernel's unsigned
atomicMax) and keys_int64 reads it as int64.

`sintax_scores` is the wrapper: it runs the plain version only for tensors
on the CPU, and for CUDA tensors launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .align_torch import timed_launch
from .build import build_kernels

LAUNCHES = {"sintax_scores": 0}
REFERENCE_CALLS = {"sintax_scores": 0}

SLOTS = 32                   # subsampled k-mers per pair (constants.SINTAX_SUBSAMPLE)
ROW_PAD = 0x7FFFFFFF         # past a row's last k-mer: above every k-mer and slot
QUERY_SENTINEL = 0x7FFFFFFE  # the slots of a k-mer-less ASV: equal to no row value
ORD_MASK = 0x3FFFFFF
PLAIN_ELEMENTS = 1 << 24     # searches per step of the plain version


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


def _check_inputs(queries, refk, ridx, acc) -> None:
    for name, x, nd in (("queries", queries, 2), ("refk", refk, 2), ("ridx", ridx, 1),
                        ("acc", acc, 1)):
        if x.dtype != torch.int32 or x.dim() != nd or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {nd}-D int32 tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != queries.device:
            raise ValueError(f"{name} is on {x.device}, queries on {queries.device}")
    P, S = queries.shape
    if S != SLOTS or ridx.shape[0] != refk.shape[0] or acc.shape[0] != P:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)} (need {SLOTS} slots) "
                         f"refk {tuple(refk.shape)} ridx {tuple(ridx.shape)} acc {tuple(acc.shape)}")
    if refk.shape[1] < 1:
        raise ValueError("refk: rows need at least one column")


def sintax_scores(queries, refk, ridx, acc) -> torch.Tensor:
    """acc[p] = max(acc[p], best key of pair p over the rows of refk).

    queries (P, 32) int32, refk (R, L) int32 rows sorted ascending and padded
    with ROW_PAD, ridx (R,) int32 ordinals below 2^26, acc (P,) int32 holding
    unsigned keys (zeros to start).  Returns acc.  CPU tensors take the plain
    PyTorch version; CUDA tensors launch kernel 3 or raise."""
    _check_inputs(queries, refk, ridx, acc)
    if queries.device.type == "cpu":
        REFERENCE_CALLS["sintax_scores"] += 1
        return sintax_scores_reference(queries, refk, ridx, acc)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    return sintax_scores_launch(queries, refk, ridx, acc)


def sintax_scores_launch(queries, refk, ridx, acc) -> torch.Tensor:
    """Launch kernel 3 on CUDA tensors that sintax_scores' checks have passed
    or would pass, without checking them: what a timing queues back to
    back."""
    if queries.device.type != "cuda":
        raise ValueError(f"sintax_scores_launch needs CUDA tensors, got {queries.device}")
    lib = build_kernels()
    P, R, L = queries.shape[0], refk.shape[0], refk.shape[1]
    with timed_launch(queries.device):
        rc = lib.sintax_scores_launch(
            queries.data_ptr(), P, refk.data_ptr(), ridx.data_ptr(), R, L, acc.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sintax_scores kernel launch failed: CUDA error {rc}")
    LAUNCHES["sintax_scores"] += 1
    return acc


def sintax_scores_reference(queries, refk, ridx, acc) -> torch.Tensor:
    """Plain PyTorch version of kernel 3: torch.searchsorted of every slot in
    every row (a step of rows at a time), the hit sum and the key max, in
    int64.  The same function as the kernel, bit for bit."""
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
    acc.copy_(torch.where(best >= 1 << 31, best - (1 << 32), best).to(torch.int32))
    return acc
