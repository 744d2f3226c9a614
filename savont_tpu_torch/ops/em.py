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
"""
from __future__ import annotations

import numpy as np

__all__ = ["em_abundances", "groups_to_rows"]


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

