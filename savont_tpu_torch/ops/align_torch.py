"""Banded affine Smith-Waterman forward on the card (kernel 1,
csrc/sw_forward.cu) and its plain PyTorch version.

Counterparts in the JAX package: align_pallas.sw_forward_pallas and the
payload mode of _pallas_call_traced (the Pallas kernel), and
align_jax.sw_forward_meta(smooth=False) / _forward_payload (its XLA plain
references).  Both versions here take RAW planner corridors (any
non-decreasing per-row advance), so every job runs through the kernel and
equals the host oracle (ops/host_dp.py run_jobs_host / run_jobs_nm_host)
without smoothing, lag gates or side paths.

`sw_forward` is the wrapper: it runs the plain version only for tensors on
the CPU, and for CUDA tensors launches the kernel or raises.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ..device import resolve_device
from .align import GAP_EXT, GAP_OPEN, MATCH, MISMATCH
from .build import build_kernels
from .host_dp import NEG

# kernel launches on the card, and calls of the plain versions through the
# wrappers on the CPU; "walk_overflow" counts pairs whose CIGAR overflowed
# maxrun and were re-run on the host (traceback_torch)
LAUNCHES = {"sw_forward_nm": 0, "sw_forward_payload": 0, "sw_walk": 0, "walk_overflow": 0}
REFERENCE_CALLS = {"sw_forward_nm": 0, "sw_forward_payload": 0, "sw_walk": 0}

MAX_BAND = 256             # 32 lanes x 8 cells, the kernel's widest instantiation
PAIRS_PER_LAUNCH = 16384   # bounds the packed q/t/lo tensors of one launch
PAYLOAD_BYTES = 1 << 30    # bounds the (B, Lq, band) u8 payload of one launch


def reset_counters() -> None:
    for d in (LAUNCHES, REFERENCE_CALLS):
        for k in d:
            d[k] = 0


@contextmanager
def launch_on(device):
    """The launch context of a kernel wrapper: `device` current.  It records
    no event: device time is read from a profiler trace.  The inputs must
    lie on the current card: a rank on another card
    (parallel/distributed.py) made its own current before it allocated
    anything, and a tensor elsewhere means it did not."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise RuntimeError(f"kernel inputs on {device}, but the current card is "
                           f"cuda:{torch.cuda.current_device()}: make the rank's card current "
                           "(torch.cuda.set_device) before its first allocation")
    with torch.cuda.device(device):
        yield


def jobs_to_tensors(jobs, device) -> tuple[torch.Tensor, ...]:
    """Pack AlignJobs into padded int32 tensors (q, t, lo, tlens) on `device`,
    with align_jax._pack_jobs's conventions: query padding code 5, target
    padding code 6 (neither ever matches), lo (B, Lq+1) with lo[:, 0] =
    lo[:, 1] and the job's last lo extended flat over padded rows."""
    B = len(jobs)
    Lq = max(len(j.qcodes) for j in jobs)
    Lt = max(len(j.tcodes) for j in jobs)
    q = np.full((B, Lq), 5, dtype=np.int32)
    t = np.full((B, Lt), 6, dtype=np.int32)
    lo = np.empty((B, Lq + 1), dtype=np.int32)
    tlens = np.empty(B, dtype=np.int32)
    for i, j in enumerate(jobs):
        n = len(j.qcodes)
        q[i, :n] = j.qcodes
        t[i, : len(j.tcodes)] = j.tcodes
        lo[i, 0] = j.lo[0]
        lo[i, 1 : n + 1] = j.lo
        lo[i, n + 1 :] = j.lo[-1]
        tlens[i] = len(j.tcodes)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (q, t, lo, tlens))


def length_chunks(jobs, band: int, payload: bool) -> list[list[int]]:
    """Job indices sorted by query length and cut into launches: at most
    PAIRS_PER_LAUNCH pairs and, with a payload, at most PAYLOAD_BYTES of
    (pairs x padded Lq x band) bytes.  Chunking changes only padding."""
    lens = np.fromiter((len(j.qcodes) for j in jobs), np.int64, len(jobs))
    return [c.tolist() for c in length_chunks_lens(lens, band, payload)]


def length_chunks_lens(lens: np.ndarray, band: int, payload: bool,
                       group: np.ndarray | None = None) -> list[np.ndarray]:
    """length_chunks on an array of query lengths (a flat plan's q_lens_j).
    With `group` (non-decreasing ids, every group of one length) no launch
    boundary falls inside a group, so the jobs of one pair stay together."""
    order = np.argsort(lens, kind="stable")
    ls = lens[order]
    gs = group[order] if group is not None else None
    chunks: list[np.ndarray] = []
    start = 0
    for i in range(1, len(order)):
        full = i - start >= PAIRS_PER_LAUNCH or (
            payload and (i - start + 1) * int(ls[i]) * band > PAYLOAD_BYTES)
        if full and (gs is None or gs[i] != gs[i - 1]):
            chunks.append(order[start:i])
            start = i
    if len(order) > start:
        chunks.append(order[start:])
    return chunks


def gather_rows(pool: torch.Tensor, off: torch.Tensor, lens: torch.Tensor, width: int,
                fill: int, *, first: int = 0, reverse: torch.Tensor | None = None,
                extend: bool = False) -> torch.Tensor:
    """Padded int32 rows (B, width) gathered on the pool's device from a flat
    pool: row i, column first + c holds pool[off[i] + c] for c < lens[i],
    read backward from the row's end where reverse[i].  Other columns hold
    `fill`, or with `extend` the row's
    nearest value (its first value before `first`, its last one past the
    end: the flat extension of a corridor).  The vectorised counterpart of
    jobs_to_tensors' per-job loop."""
    n = lens[:, None]
    c = torch.arange(width, device=pool.device)[None, :] - first
    inside = (c >= 0) & (c < n)
    if extend:
        c = torch.minimum(c.clamp(min=0), (n - 1).clamp(min=0))
        inside = n > 0
    if reverse is not None:
        c = torch.where(reverse[:, None], n - 1 - c, c)
    vals = pool[(off[:, None] + c).clamp(0, max(pool.numel() - 1, 0))]
    return torch.where(inside, vals.to(torch.int32), fill).contiguous()


def plan_to_device(plan: tuple, t_pool: np.ndarray, tlens_pool: np.ndarray, device) -> dict:
    """The arrays of a flat plan (align_batch._plan_soa_indexed) that kernel
    1's tensors are packed from, and the padded target pool, on `device`."""
    (_owner_j, _uq_j, _st_j, tid_j, q_cat, q_off_j, q_lens_j,
     _t_cat, _t_off_j, _t_lens_j, lo_flat, lo_off_j, _qlens_all, _band) = plan
    dev = resolve_device(device)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    return {
        "q_cat": up(q_cat, np.uint8), "lo_flat": up(lo_flat, np.int32),
        "q_off": up(q_off_j, np.int64), "q_lens": up(q_lens_j, np.int64),
        "lo_off": up(lo_off_j, np.int64), "tid": up(tid_j, np.int64),
        "t_pool": up(t_pool, np.int32), "tlens_pool": up(tlens_pool, np.int32),
    }


def plan_tensors(dp: dict, sel: torch.Tensor, q: torch.Tensor | None = None):
    """Kernel 1's (q, t, lo, tlens) for the plan jobs `sel` (int64, on the
    device) of plan_to_device's dict, with jobs_to_tensors' conventions:
    query padding 5, lo[:, 0] = lo[:, 1], the last lo extended flat; t and
    tlens are gathered from the target pool by the jobs' target ids.  `q`
    replaces the plan's own query codes (stage 4 packs raw-byte codes)."""
    lens = dp["q_lens"][sel]
    Lq = int(lens.max())
    if q is None:
        q = gather_rows(dp["q_cat"], dp["q_off"][sel], lens, Lq, 5)
    lo = gather_rows(dp["lo_flat"], dp["lo_off"][sel], lens, Lq + 1, 0, first=1, extend=True)
    tid = dp["tid"][sel]
    return q, dp["t_pool"][tid].contiguous(), lo, dp["tlens_pool"][tid].contiguous()


def _check_forward_inputs(q, t, lo, tlens, band: int) -> None:
    for name, x, nd in (("q", q, 2), ("t", t, 2), ("lo", lo, 2), ("tlens", tlens, 1)):
        if x.dtype != torch.int32 or x.dim() != nd or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {nd}-D int32 tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    B, Lq = q.shape
    if t.shape[0] != B or lo.shape != (B, Lq + 1) or tlens.shape != (B,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} t {tuple(t.shape)} "
                         f"lo {tuple(lo.shape)} tlens {tuple(tlens.shape)}")
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"band {band} outside 1..{MAX_BAND}")
    if bool((lo[:, 0] < 0).any()) or bool((lo[:, 1:] < lo[:, :-1]).any()):
        raise ValueError("lo must be non-negative and non-decreasing along each row")


def sw_forward(q, t, lo, tlens, band: int, emit_payload: bool = False, device=None):
    """Banded forward over B pairs.

    q (B, Lq) / t (B, Lt) int32 codes (0..3 bases, 4 ambiguous, 5 / 6
    padding), lo (B, Lq+1) int32 raw corridor, tlens (B,) int32.  With
    `device`, the inputs are moved there first.
    Returns out (B, 4) int32 = [score, q_end, t_end, nm] in NM mode, and
    (payload (B, Lq, band) uint8, score, ri, bj) with (B,) int32 vectors in
    payload mode.  CPU tensors take the plain PyTorch version; CUDA tensors
    launch kernel 1 or raise."""
    if device is not None:
        dev = resolve_device(device)
        q, t, lo, tlens = (x.to(dev) for x in (q, t, lo, tlens))
    _check_forward_inputs(q, t, lo, tlens, band)
    key = "sw_forward_payload" if emit_payload else "sw_forward_nm"
    if q.device.type == "cpu":
        REFERENCE_CALLS[key] += 1
        return sw_forward_reference(q, t, lo, tlens, band, emit_payload)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = build_kernels()
    B, Lq = q.shape
    if emit_payload:
        out = torch.empty((3, B), dtype=torch.int32, device=q.device)
        payload = torch.empty((B, Lq, band), dtype=torch.uint8, device=q.device)
    else:
        out = torch.empty((B, 4), dtype=torch.int32, device=q.device)
        payload = None
    with launch_on(q.device):
        rc = lib.sw_forward_launch(
            q.data_ptr(), t.data_ptr(), lo.data_ptr(), tlens.data_ptr(),
            B, Lq, t.shape[1], band, MATCH, MISMATCH, GAP_OPEN, GAP_EXT,
            int(emit_payload), out.data_ptr(),
            payload.data_ptr() if payload is not None else None,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_forward kernel launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    if emit_payload:
        return payload, out[0], out[1], out[2]
    return out


def sw_forward_reference(q, t, lo, tlens, band: int, emit_payload: bool = False):
    """Plain PyTorch version of kernel 1, vectorised over pairs with a Python
    loop over rows: the same recurrence and tie rules, the same outputs.
    The previous-row sources are gathers (take_along_axis semantics), and
    the E prefix max is log2(band) doubling steps that keep the later lane
    on ties (torch.cummax promises nothing about ties)."""
    dev = q.device
    B, Lq = q.shape
    i32 = torch.int32
    je = torch.arange(band, dtype=i32, device=dev)
    jl = je.long()
    tlast = (tlens.long() - 1).clamp(min=0)[:, None]
    H = torch.zeros((B, band), dtype=i32, device=dev)
    F = torch.full((B, band), NEG, dtype=i32, device=dev)
    nmh = torch.zeros_like(H)
    nmf = torch.zeros_like(H)
    bv, br, bte, bnm = (torch.zeros_like(H) for _ in range(4))
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    payload = (
        torch.empty((B, Lq, band), dtype=torch.uint8, device=dev) if emit_payload else None
    )

    def take(a, idx, ok, fill):
        return torch.where(ok, a.gather(1, idx.clamp(0, band - 1)), fill)

    for r in range(1, Lq + 1):
        l = lo[:, r : r + 1]
        dl = l - lo[:, r - 1 : r]
        cols = l + je
        tc = t.gather(1, torch.minimum(cols.long(), tlast))
        qc = q[:, r - 1 : r]
        is_match = (tc == qc) & (qc < 4) & (tc < 4)
        s = torch.where(is_match, MATCH, MISMATCH).to(i32)

        src = jl + dl.long()  # up = lane j+dl, diag = lane j+dl-1
        up_in = src < band
        d_in = (src >= 1) & (src - 1 < band)
        h_up, f_up = take(H, src, up_in, NEG), take(F, src, up_in, NEG)
        h_diag = take(H, src - 1, d_in, NEG)
        left = (je == 0) & (cols == 0)
        h_diag = torch.where(left, 0, h_diag)

        from_h = (h_up - GAP_OPEN) >= f_up
        Fr = (torch.maximum(h_up - GAP_OPEN, f_up) - GAP_EXT).clamp(min=NEG)
        Gr = torch.maximum((h_diag + s).clamp(min=0), Fr)
        g_zero = Gr == 0
        g_f = ~g_zero & (Gr == Fr)

        sv = Gr + GAP_EXT * je
        if not emit_payload:
            nmf_n = torch.where(from_h, take(nmh, src, up_in, 0), take(nmf, src, up_in, 0)) + 1
            nm_diag = torch.where(left, 0, take(nmh, src - 1, d_in, 0))
            nmg = torch.where(
                g_zero, 0, torch.where(g_f, nmf_n, nm_diag + (~is_match).to(i32))
            )
            sm = nmg - je
        shift = 1
        while shift < band:
            rv = torch.cat([neg_col.expand(B, shift), sv[:, :-shift]], dim=1)
            cur = sv >= rv  # ties keep the current (later) lane
            if not emit_payload:
                rm = torch.cat([torch.zeros_like(sm[:, :shift]), sm[:, :-shift]], dim=1)
                sm = torch.where(cur, sm, rm)
            sv = torch.where(cur, sv, rv)
            shift *= 2
        run_v = torch.cat([neg_col, sv[:, :-1]], dim=1)
        Er = (run_v - GAP_OPEN - GAP_EXT * je).clamp(min=NEG)
        use_g = Gr >= Er
        Hr = torch.where(cols < tlens[:, None], torch.where(use_g, Gr, Er), NEG)
        better = Hr > bv  # strict: each lane keeps its earliest row

        if emit_payload:
            g_left = torch.cat([neg_col, Gr[:, :-1]], dim=1)
            exit_e = Er == g_left - (GAP_OPEN + GAP_EXT)
            bits = (
                use_g.to(i32) | (g_zero.to(i32) << 1) | (g_f.to(i32) << 2)
                | (exit_e.to(i32) << 3) | (from_h.to(i32) << 4)
                | ((~is_match).to(i32) << 5)
            )
            payload[:, r - 1] = bits.to(torch.uint8)
        else:
            run_m = torch.cat([torch.zeros_like(sm[:, :1]), sm[:, :-1]], dim=1)
            nmh_n = torch.where(use_g, nmg, run_m + je)
            bnm = torch.where(better, nmh_n, bnm)
            nmh, nmf = nmh_n, nmf_n
        bv = torch.where(better, Hr, bv)
        br = torch.where(better, r, br)
        bte = torch.where(better, cols + 1, bte)
        H, F = Hr, Fr

    # winner across lanes: max value, then earliest row, then lowest lane
    vmax = bv.amax(dim=1, keepdim=True)
    at_v = bv == vmax
    rmin = torch.where(at_v, br, Lq + 1).amin(dim=1, keepdim=True)
    lane = torch.where(at_v & (br == rmin), je, band).amin(dim=1, keepdim=True).long()
    score, ri = vmax[:, 0], rmin[:, 0]
    if emit_payload:
        return payload, score.contiguous(), ri.contiguous(), lane[:, 0].to(i32)
    return torch.stack(
        [score, ri, bte.gather(1, lane)[:, 0], bnm.gather(1, lane)[:, 0]], dim=1
    ).contiguous()


def sw_forward_jobs(jobs, band: int, device) -> list[tuple | None]:
    """run_jobs_nm contract on the card: per job (score, 0, q_end, 0, t_end,
    [], nm), or None when score <= 0.  The starts are 0, as in the route
    this replaces (the Pallas NM route of the JAX package's run_jobs_nm): the
    kernel carries no start metadata, and its consumer (the stage-7 NM
    tie-break) reads only nm."""
    results: list[tuple | None] = [None] * len(jobs)
    for chunk in length_chunks(jobs, band, payload=False):
        q, t, lo, tlens = jobs_to_tensors([jobs[i] for i in chunk], device)
        out = sw_forward(q, t, lo, tlens, band).cpu().numpy()
        for x, i in enumerate(chunk):
            score, q_end, t_end, nm = (int(v) for v in out[x])
            if score > 0:
                results[i] = (score, 0, q_end, 0, t_end, [], nm)
    return results
