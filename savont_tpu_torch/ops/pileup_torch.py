"""Stage-4 pileup count matrices on the device: banded forward, winner per
pair, traceback walk of the winner only, and the four scatter-adds, with
only the count buffers leaving the card.

The counterpart of the JAX package's align_jax.sw_pileup_counts and
_pileup_counts_from_payload.  Those are XLA code on top of the forward and
the walk; here the forward is kernel 1 in payload mode (align_torch.
sw_forward) and the walk kernel 2 (traceback_torch.walk_rle), both launched
for CUDA tensors, and the rest is tensor code on the same device: kernel 2's
run-length rows (forward order) become per-run start positions by cumulative
sums, the match and deletion runs are expanded to per-base positions with
repeat_interleave, and index_add_ scatters into flat int32 buffers.  Integer
adds commute, so the counts do not depend on the order of the atomics.

Where the JAX version sends masked entries out of range under mode="drop",
each buffer here has one extra sink slot at its end, sliced off by
`strip_sinks`.

Rows are flat: instead of `slots` candidate rows per pair, `pair` names each
row's pair (the jobs of a pair adjacent), and the winner of a pair is its
highest score, the earliest row on ties (align_pairs' rule), found with the
key score * B - row and a segment maximum rather than argmax's tie order.
"""
from __future__ import annotations

import torch

from .align_torch import sw_forward
from .traceback_torch import MAXRUN, walk_rle

COUNT_KEYS = ("bq", "dels", "ins", "hph")


def new_count_buffers(total_L: int, nq: int, use_hp: bool, device) -> dict[str, torch.Tensor]:
    """Zeroed flat int32 count buffers on `device`, each with its sink slot:
    bq (total_L*nq*2), dels (total_L), ins (total_L*nq), hph (total_L*64)."""
    sizes = {"bq": total_L * nq * 2, "dels": total_L, "ins": total_L * nq}
    if use_hp:
        sizes["hph"] = total_L * 64
    return {k: torch.zeros(n + 1, dtype=torch.int32, device=device) for k, n in sizes.items()}


def strip_sinks(acc: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v[:-1] for k, v in acc.items()}


def pair_winners(score: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
    """Per row, whether it is its pair's winner: positive score, the pair's
    highest, the earliest row among equals.  `pair` holds one id per row,
    equal ids adjacent."""
    B = score.shape[0]
    _, inv = torch.unique_consecutive(pair, return_inverse=True)
    key = score.long() * B - torch.arange(B, device=score.device)
    best = torch.full((int(inv[-1]) + 1 if B else 0,), torch.iinfo(torch.int64).min,
                      dtype=torch.int64, device=score.device)
    best.scatter_reduce_(0, inv, key, "amax", include_self=True)
    return (key == best[inv]) & (score > 0)


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.cumsum(dim) - x


def add_pileup_counts(acc, cigar, meta, rows, q, t, lvl, hp, off, tlens, nq: int) -> None:
    """Scatter the alignments of `rows` (int64 row indices; their CIGAR rows
    complete) into the count buffers `acc`, with the semantics of
    pipeline/pileup.read_pileup_indices: a match or mismatch counts its
    base at (position, quality level, is_ref), a deleted position counts
    once, an insertion run counts once at the position before it with the
    quality level of its first base, and with acc["hph"] a matched base
    counts its homopolymer run length."""
    if rows.numel() == 0:
        return
    n_runs = int(meta[rows, 0].max())
    if n_runs == 0:
        return
    cg = cigar[rows, :n_runs].long()
    r_len = (cg >> 4) & 0x0FFFFFFF
    r_op = cg & 0xF
    # start of every run on the target and the oriented query
    r_t0 = meta[rows, 3].long()[:, None] + _exclusive_cumsum(r_len * (r_op != 1), 1)
    r_q0 = meta[rows, 1].long()[:, None] + _exclusive_cumsum(r_len * (r_op != 2), 1)
    row2 = rows[:, None].expand_as(cg)
    Lq, Lt = q.shape[1], t.shape[1]
    tl2 = tlens[rows].long()[:, None]
    off2 = off[rows].long()[:, None]

    # insertion runs: one event each, at the target position before the run
    is_i = (r_op == 1) & (r_len > 0)
    tp = r_t0 - 1
    ok = is_i & (tp >= 0) & (tp < tl2) & (r_q0 >= 0)
    lv = lvl[row2, r_q0.clamp(0, Lq - 1)].long()
    acc["ins"].index_add_(
        0, torch.where(ok, (off2 + tp) * nq + lv, acc["ins"].numel() - 1).reshape(-1),
        torch.ones(ok.numel(), dtype=torch.int32, device=ok.device))

    # match and deletion runs, expanded to one entry per base
    keep = (r_op != 1) & (r_len > 0)
    k_len = r_len[keep]
    run_of = torch.repeat_interleave(torch.arange(k_len.numel(), device=k_len.device), k_len)
    within = torch.arange(run_of.numel(), device=k_len.device) - _exclusive_cumsum(k_len, 0)[run_of]
    b_op = r_op[keep][run_of]
    b_row = row2[keep][run_of]
    tpos = r_t0[keep][run_of] + within
    qpos = r_q0[keep][run_of] + within * (b_op == 0)
    in_t = (tpos >= 0) & (tpos < tl2.expand_as(cg)[keep][run_of])
    pos = off2.expand_as(cg)[keep][run_of] + tpos
    one = torch.ones(run_of.numel(), dtype=torch.int32, device=k_len.device)

    is_d = (b_op == 2) & in_t
    acc["dels"].index_add_(0, torch.where(is_d, pos, acc["dels"].numel() - 1), one)

    is_m = (b_op == 0) & in_t & (qpos >= 0)
    qi = qpos.clamp(0, Lq - 1)
    is_ref = (q[b_row, qi] == t[b_row, tpos.clamp(0, Lt - 1)]).long()
    lv = lvl[b_row, qi].long()
    acc["bq"].index_add_(
        0, torch.where(is_m, (pos * nq + lv) * 2 + is_ref, acc["bq"].numel() - 1), one)
    if "hph" in acc:
        hpv = hp[b_row, qi].long()
        acc["hph"].index_add_(0, torch.where(is_m, pos * 64 + hpv, acc["hph"].numel() - 1), one)


def sw_pileup_counts(
    q, t, lo, tlens, lvl, hp, off, pair, total_L: int, nq: int, band: int, ops_max: int,
    use_hp: bool = False, acc: dict | None = None, maxrun: int = MAXRUN,
) -> dict:
    """Banded forward + winner per pair + walk + count scatter for B rows.

    q / t / lo / tlens as align_torch.sw_forward (q and t may hold raw-byte
    codes >= 33 beside 0..3: only codes < 4 match in the DP, and is_ref
    compares the codes as they are); lvl (B, Lq) the quality level of each
    oriented query base; hp (B, Lq) its clamped homopolymer run length (read
    with use_hp only); off (B,) the flat offset of the row's consensus; pair
    (B,) the row's pair id, equal ids adjacent.  Counts are added into `acc`
    (new_count_buffers; made here when None).

    Returns acc's buffers under their keys (sinks included), plus "score"
    (B,), "is_win" (B,), "meta" (B, 6) of kernel 2, and "overflow": the
    indices of winner rows whose CIGAR has more than maxrun runs.  Those
    rows are not counted here; the caller counts them on the host."""
    if acc is None:
        acc = new_count_buffers(total_L, nq, use_hp, q.device)
    payload, score, ri, bj = sw_forward(q, t, lo, tlens, band, emit_payload=True)
    is_win = pair_winners(score, pair)
    walk_score = torch.where(is_win, score, 0)
    cigar, meta = walk_rle(payload, lo, walk_score, ri, bj, band, ops_max, maxrun)
    fits = meta[:, 0] <= maxrun
    add_pileup_counts(acc, cigar, meta, torch.nonzero(is_win & fits)[:, 0],
                      q, t, lvl, hp, off, tlens, nq)
    return {**acc, "score": score, "is_win": is_win, "meta": meta,
            "overflow": torch.nonzero(is_win & ~fits)[:, 0]}
