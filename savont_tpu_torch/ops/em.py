"""Vectorized EM over (group, member) incidence rows.

Both EM loops in the reference share one shape — stage-7 depth refinement
over read equivalence classes (alignment.rs:1951-2003) and classify's
taxonomy EM weighted by ASV depth (classify.rs:24-117):

    for each group g with weight w_g and member set M_g:
        denom_g = sum_{a in M_g} abund[a]
        new[a] += w_g * abund[a] / denom_g      for a in M_g
    new /= total;  stop when max |abund - new| < conv

The dict-of-tuples loop is O(iters * sum|M_g|) of Python interpreter time;
this module flattens the incidence structure into parallel arrays
(row r: group_ids[r] -> item_ids[r]) and runs each iteration as two
bincounts.  np.bincount accumulates sequentially in row order, so with rows
enumerated group-major (the dict iteration order) the result is
BIT-IDENTICAL to the reference-shaped Python loop — tests/test_em.py pins
that.

`em_abundances_torch` is the same fixed point in float32 on a torch device
(index_add_ + a Python loop); it converges to the same answer but is not
bit-pinned: float32 index_add_ on a CUDA device adds in no fixed order.
With `stage7_tie_sets` and `stage7_em` it is the port's counterpart of the
JAX package's stage-7 device step (parallel/mesh.py sharded_stage7_align's
tie-set closure, sharded_stage7_em), held to it by the tests.  No route
calls the three: the emitted depths come from the host float64 EM
(pipeline/stage7_em._run_em), which matches the reference's loop bit for
bit, where a float32 EM on the card would not.
"""
from __future__ import annotations

import numpy as np

__all__ = ["em_abundances", "em_abundances_torch", "groups_to_rows", "stage7_em", "stage7_tie_sets"]

EM_CONV = 0.01  # stage7_em stops below EM_CONV / assigned reads, as the host EM does


def groups_to_rows(groups) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten an iterable of (member_tuple, weight) into row arrays
    (group_ids, item_ids, group_weights), preserving iteration order."""
    group_ids_parts = []
    item_parts = []
    weights = []
    for g, (members, weight) in enumerate(groups):
        group_ids_parts.append(np.full(len(members), g, dtype=np.int64))
        item_parts.append(np.asarray(members, dtype=np.int64))
        weights.append(weight)
    if not weights:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float64))
    return (
        np.concatenate(group_ids_parts),
        np.concatenate(item_parts),
        np.asarray(weights, dtype=np.float64),
    )


def em_abundances(
    group_ids: np.ndarray,
    item_ids: np.ndarray,
    group_weights: np.ndarray,
    n_items: int,
    total: float,
    conv: float,
    max_iter: int,
) -> np.ndarray:
    """EM fixed point; bit-identical to the group-major Python loop."""
    abund = np.full(n_items, 1.0 / n_items)
    if len(group_ids) == 0:
        return abund
    n_groups = len(group_weights)
    w_row = group_weights[group_ids]
    for _ in range(max_iter):
        a_row = abund[item_ids]
        denom = np.bincount(group_ids, weights=a_row, minlength=n_groups)
        d_row = denom[group_ids]
        safe = d_row > 0
        contrib = np.where(safe, w_row * a_row / np.where(safe, d_row, 1.0), 0.0)
        new = np.bincount(item_ids, weights=contrib, minlength=n_items)
        if new.sum() > 0:
            new = new / total
        max_change = float(np.abs(abund - new).max())
        abund = new
        if max_change < conv:
            break
    return abund



def em_abundances_torch(
    group_ids,
    item_ids,
    group_weights,
    n_items: int,
    total: float,
    conv: float,
    max_iter: int,
    stats: dict | None = None,
):
    """The EM fixed point of em_abundances in float32 on the device of
    `group_ids` (int64 tensors group_ids, item_ids; float32 group_weights):
    the counterpart of the JAX package's em_abundances_jax.  Its while_loop
    is a Python loop here, and reading the change each iteration waits for
    the device.  Returns the (n_items,) float32 abundances; `stats`, when
    given, receives the iteration count under "iters"."""
    import torch

    dev = group_ids.device
    n_groups = group_weights.shape[0]
    w_row = group_weights[group_ids]
    abund = torch.full((n_items,), 1.0 / n_items, dtype=torch.float32, device=dev)
    it, change = 0, float("inf")
    while it < max_iter and change >= conv:
        a_row = abund[item_ids]
        denom = torch.zeros(n_groups, dtype=torch.float32, device=dev).index_add_(0, group_ids, a_row)
        d_row = denom[group_ids]
        safe = d_row > 0
        contrib = torch.where(safe, w_row * a_row / torch.where(safe, d_row, 1.0), 0.0)
        new = torch.zeros(n_items, dtype=torch.float32, device=dev).index_add_(0, item_ids, contrib)
        new = torch.where(new.sum() > 0, new / total, new)
        change = float((abund - new).abs().max())
        abund = new
        it += 1
    if stats is not None:
        stats["iters"] = it
    return abund


def stage7_tie_sets(score, nm, row_read, row_asv, n_asvs: int):
    """Tie-set closure over flat job rows (the reference's
    _stage7_align_local after its forward): a row is valid when its score
    is positive; the winner of a (read, ASV) is its highest score, the
    earliest row on ties; a read's tie set is its winners at its least NM.
    score / nm int32 and row_read / row_asv int64 tensors of one length, in
    plan order.  Returns in_tie (bool).  No route calls it (module
    docstring)."""
    import torch

    n = score.shape[0]
    dev = score.device
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    valid = score > 0
    key = score.long() * n - torch.arange(n, device=dev)
    _, grp = torch.unique(row_read * n_asvs + row_asv, return_inverse=True)
    lowest = torch.iinfo(torch.int64).min
    best = torch.full((int(grp.max()) + 1,), lowest, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, grp, torch.where(valid, key, lowest), "amax", include_self=True)
    winner = valid & (key == best[grp])
    big = 1 << 20
    _, rd = torch.unique(row_read, return_inverse=True)
    nm_eff = torch.where(winner, nm.long(), big)
    best_nm = torch.full((int(rd.max()) + 1,), big, dtype=torch.int64, device=dev)
    best_nm.scatter_reduce_(0, rd, nm_eff, "amin", include_self=True)
    return winner & (nm_eff == best_nm[rd])


def stage7_em(in_tie, row_read, row_asv, n_asvs: int, em_iters: int, conv: float = EM_CONV,
              stats: dict | None = None):
    """EM fixed point over the tie sets (the reference's _stage7_em_local):
    every assigned read weighs 1, responsibilities are proportional to the
    abundances inside its tie set, uniform start, stop at em_iters or when
    the largest change falls below conv / assigned reads.  Returns (abund
    (n_asvs,) float32 on the rows' device, assigned read count).  No route
    calls it (module docstring)."""
    import torch

    rd_all = row_read[in_tie]
    if rd_all.numel() == 0:
        return torch.full((n_asvs,), 1.0 / n_asvs, dtype=torch.float32, device=in_tie.device), 0
    reads, rd = torch.unique(rd_all, return_inverse=True)
    count = int(reads.numel())
    abund = em_abundances_torch(
        rd, row_asv[in_tie], torch.ones(count, dtype=torch.float32, device=in_tie.device),
        n_asvs, float(count), conv / count, em_iters, stats,
    )
    return abund, count
