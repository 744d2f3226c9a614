"""Traceback walk + CIGAR run-length encoding on the card (kernel 2,
csrc/sw_walk.cu) and its plain PyTorch version, plus the run_jobs-contract
traceback route built from kernels 1 and 2.

Counterparts in the JAX package: align_jax._walk_ops and
sw_traceback_from_payload (the XLA walk + RLE), and
align_pallas.sw_traceback_pallas_jobs (the Pallas payload forward + walk
route of run_jobs).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .align_torch import (
    LAUNCHES,
    REFERENCE_CALLS,
    jobs_to_tensors,
    length_chunks,
    sw_forward,
    launch_on,
)
from .build import build_kernels
from .host_dp import run_jobs_host

MAXRUN = 512
ST_H, ST_G, ST_E, ST_F = 0, 1, 2, 3


def _check_walk_inputs(payload, lo, score, ri, bj, band: int) -> None:
    if payload.dtype != torch.uint8 or payload.dim() != 3 or not payload.is_contiguous():
        raise ValueError(f"payload: expected a contiguous (B, Lq, band) uint8 tensor, "
                         f"got {payload.dtype} {tuple(payload.shape)}")
    B, Lq, pb = payload.shape
    if pb != band:
        raise ValueError(f"payload band {pb} != band {band}")
    for name, x, shape in (("lo", lo, (B, Lq + 1)), ("score", score, (B,)),
                           ("ri", ri, (B,)), ("bj", bj, (B,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != payload.device:
            raise ValueError(f"{name} is on {x.device}, payload on {payload.device}")
    if bool(((ri < 0) | (ri > Lq) | (bj < 0) | (bj >= band)).any()):
        raise ValueError(f"start cells outside the payload: ri must lie in 0..{Lq}, "
                         f"bj in 0..{band - 1}")


def walk_rle(payload, lo, score, ri, bj, band: int, ops_max: int, maxrun: int = MAXRUN,
             device=None):
    """Walk each pair's traceback from its best cell and run-length encode it.

    payload (B, Lq, band) uint8 from sw_forward(emit_payload=True), lo
    (B, Lq+1) int32, score / ri / bj (B,) int32.  Returns cigar (B, maxrun)
    int32 holding packed u32 runs (len << 4) | op in forward order, zero
    past n_runs (the whole row zero when n_runs > maxrun, an overflow), and
    meta (B, 6) int32 = [n_runs, q_start, q_end, t_start, t_end, nm].
    CPU tensors take the plain PyTorch version; CUDA tensors launch kernel
    2 or raise (also where ops_max and maxrun exceed what the kernel holds
    in shared memory: see walk_rle_launch).  The inputs are validated first,
    which reads the start cells back and so waits for the device;
    walk_rle_launch is the launch alone."""
    if device is not None:
        dev = resolve_device(device)
        payload, lo, score, ri, bj = (x.to(dev) for x in (payload, lo, score, ri, bj))
    _check_walk_inputs(payload, lo, score, ri, bj, band)
    if payload.device.type == "cpu":
        REFERENCE_CALLS["sw_walk"] += 1
        return walk_rle_reference(payload, lo, score, ri, bj, band, ops_max, maxrun)
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    return walk_rle_launch(payload, lo, score, ri, bj, band, ops_max, maxrun)


def walk_rle_launch(payload, lo, score, ri, bj, band: int, ops_max: int, maxrun: int = MAXRUN):
    """Launch kernel 2 on CUDA tensors that walk_rle's checks have passed or
    would pass, without checking them and without waiting for the device:
    what walk_rle does after its validation, and what a timing of the kernel
    queues back to back.  A pair's warp keeps ops_max op bytes, maxrun run
    words and three payload windows in shared memory, so the three sizes are
    bounded together by a block's 227 KB (ops_max near 200,000 at maxrun 512,
    far above any read pair's Lq + Lt); larger ones raise here."""
    if payload.device.type != "cuda":
        raise ValueError(f"walk_rle_launch needs CUDA tensors, got {payload.device}")
    lib = build_kernels()
    B, Lq, _ = payload.shape
    if lib.sw_walk_warp_bytes(band, ops_max, maxrun) < 0:
        raise ValueError(f"band {band}, ops_max {ops_max}, maxrun {maxrun}: each must be at "
                         f"least 1, and 3 windows of payload + ops_max bytes + 4 * maxrun "
                         f"bytes must fit a block's 227 KB of shared memory")
    cigar = torch.empty((B, maxrun), dtype=torch.int32, device=payload.device)
    meta = torch.empty((B, 6), dtype=torch.int32, device=payload.device)
    with launch_on(payload.device):
        rc = lib.sw_walk_launch(
            payload.data_ptr(), lo.data_ptr(), score.data_ptr(), ri.data_ptr(),
            bj.data_ptr(), B, Lq, band, ops_max, maxrun, cigar.data_ptr(),
            meta.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_walk kernel launch failed: CUDA error {rc}")
    LAUNCHES["sw_walk"] += 1
    return cigar, meta


def walk_rle_reference(payload, lo, score, ri, bj, band: int, ops_max: int,
                       maxrun: int = MAXRUN):
    """Plain PyTorch version of kernel 2: the walk state machine stepped for
    all pairs at once (a Python loop over steps, with masks), then the
    run-length encoding of sw_traceback_from_payload.  A pair that starts in
    row 0 with a positive score (kernel 1 gives none) reads row 0 and stops
    after one op."""
    dev = payload.device
    B, Lq, _ = payload.shape
    flat = payload.reshape(B, Lq * band)
    dl_tab = (lo[:, 1:] - lo[:, :-1]).long()
    bidx = torch.arange(B, device=dev)
    r, j = ri.long(), bj.long()
    zero = torch.zeros(B, dtype=torch.long, device=dev)
    st, cnt, nm, nins, ndel = zero, zero, zero, zero, zero
    done = score <= 0
    ops = torch.full((B, ops_max + 1), 255, dtype=torch.uint8, device=dev)
    while not bool(done.all()):
        act = ~done
        row = (r - 1).clamp(0, Lq - 1)
        p = flat[bidx, row * band + j.clamp(0, band - 1)].long()
        dl = dl_tab[bidx, row]
        st1 = torch.where(st == ST_H, torch.where((p & 1) != 0, ST_G, ST_E), st)
        stop = (st1 == ST_G) & ((p & 2) != 0)
        st2 = torch.where((st1 == ST_G) & ((p & 4) != 0), ST_F, st1)
        is_diag = (st2 == ST_G) & ~stop
        is_f = (st2 == ST_F) & ~stop
        is_e = (st2 == ST_E) & ~stop
        emit = act & ~stop
        op = torch.where(is_diag, 0, torch.where(is_f, 1, 2))
        ops[bidx, torch.where(emit, cnt, ops_max)] = op.to(torch.uint8)
        nm = nm + torch.where(emit, torch.where(is_diag, (p >> 5) & 1, 1), 0)
        nins = nins + (emit & is_f).long()
        ndel = ndel + (emit & is_e).long()
        cnt = cnt + emit.long()

        up = j + dl
        exit_f = ((p & 16) != 0) & (up < band)
        exit_e = ((p & 8) != 0) & (j - 1 >= 0)
        r_n = torch.where(is_diag | is_f, r - 1, r)
        j_n = torch.where(is_diag, up - 1, torch.where(is_f, up, torch.where(is_e, j - 1, j)))
        st_n = torch.where(
            is_diag, ST_H,
            torch.where(is_f, torch.where(exit_f, ST_H, ST_F),
                        torch.where(is_e, torch.where(exit_e, ST_G, ST_E), st2)),
        )
        term = stop | (r_n <= 0) | (j_n < 0) | (j_n >= band) | (cnt >= ops_max)
        done = done | (act & term)
        r = torch.where(act, r_n, r)
        j = torch.where(act, j_n, j)
        st = torch.where(act, st_n, st)

    # reverse the backward op stream and run-length encode it
    W = ops_max
    ii = torch.arange(W, device=dev)
    rev = cnt[:, None] - 1 - ii
    valid = rev >= 0
    ops_f = ops.gather(1, rev.clamp(0, W - 1))
    prev = torch.cat([torch.full_like(ops_f[:, :1], 255), ops_f[:, :-1]], dim=1)
    bnd = valid & (ops_f != prev)
    rid = bnd.long().cumsum(dim=1) - 1
    n_runs = bnd.sum(dim=1)
    keep = valid & (rid < maxrun)
    run_len = torch.zeros((B, maxrun + 1), dtype=torch.long, device=dev)
    run_len.scatter_add_(1, torch.where(keep, rid, maxrun), keep.long())
    run_op = torch.zeros((B, maxrun + 1), dtype=torch.long, device=dev)
    run_op.scatter_(1, torch.where(keep & bnd, rid, maxrun), ops_f.long())
    cigar = (run_len[:, :maxrun] << 4) | run_op[:, :maxrun]
    cigar = torch.where((n_runs <= maxrun)[:, None], cigar, 0).to(torch.int32)

    q_end = ri.long()
    t_end = lo.gather(1, q_end.clamp(0, Lq)[:, None])[:, 0].long() + bj.long() + 1
    meta = torch.stack(
        [n_runs, q_end - (cnt - ndel), q_end, t_end - (cnt - nins), t_end, nm], dim=1
    ).to(torch.int32)
    return cigar, meta


def sw_traceback_jobs(jobs, band: int, maxrun: int = MAXRUN, device="cuda") -> list[tuple | None]:
    """run_jobs contract on the card: per job (score, q0, q1, t0, t1,
    cigar_u32, nm), or None when score <= 0.  Every job goes through kernel
    1 (payload mode) and kernel 2, on raw corridors.  Pairs whose CIGAR has
    more than maxrun runs are re-run on the host oracle (ops/host_dp.py), as
    the reference route does (counted in LAUNCHES["walk_overflow"])."""
    if not jobs:
        return []
    dev = resolve_device(device)
    results: list[tuple | None] = [None] * len(jobs)
    overflow: list[int] = []
    for chunk in length_chunks(jobs, band, payload=True):
        q, t, lo, tlens = jobs_to_tensors([jobs[i] for i in chunk], dev)
        payload, score, ri, bj = sw_forward(q, t, lo, tlens, band, emit_payload=True)
        ops_max = q.shape[1] + t.shape[1]
        cigar, meta = walk_rle(payload, lo, score, ri, bj, band, ops_max, maxrun)
        score_h = score.cpu().numpy()
        cigar_h = cigar.cpu().numpy().view(np.uint32)
        meta_h = meta.cpu().numpy()
        for x, i in enumerate(chunk):
            n_runs, q0, q1, t0, t1, nm = (int(v) for v in meta_h[x])
            if score_h[x] <= 0:
                continue
            if n_runs > maxrun:
                overflow.append(i)
                continue
            results[i] = (int(score_h[x]), q0, q1, t0, t1, cigar_h[x, :n_runs].copy(), nm)
    if overflow:
        LAUNCHES["walk_overflow"] += len(overflow)
        host = run_jobs_host([jobs[i] for i in overflow], band)
        for i, r in zip(overflow, host):
            results[i] = r
    return results
