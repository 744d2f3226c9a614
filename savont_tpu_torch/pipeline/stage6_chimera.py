"""Stage 6: chimera detection and filtering (chimera.rs).

Behavioral parity note: the reference computes pairwise similarities but
stores them under (j, i) with j > i while every lookup uses (min, max)
(chimera.rs:454 vs 143/175/227) — the lookups can never hit.  The OBSERVED
behavior is therefore: chimera_score is always 0; the single-parent rule
(chimera.rs:220-250) never fires (similarity defaults to 1.0 -> mismatches
0); and the bipartite rule's thresholds collapse to parent_similarity = 0.0:
coverage in [0.63, 1.8).  We reproduce the observed behavior and skip the
dead pairwise-similarity computation.
"""
from __future__ import annotations

import logging

import numpy as np

from ..config import ClusterArgs
from ..core import ConsensusSequence
from ..ops.align import TargetIndex
from ..ops.encode import revcomp_bytes

log = logging.getLogger("savont")


def calculate_match_lengths(
    cigar: list[tuple[int, int]],
    query_seq: bytes,
    target_seq: bytes,
    query_start: int,
    query_end: int,
    target_start: int,
    target_end: int,
    rc: bool,
    args: ClusterArgs,
) -> tuple[int | None, int | None]:
    """Perfect-match prefix/suffix lengths allowing chimera_allowable_errors
    with 15 bp PCR slack (chimera.rs:274-399).  Matches accumulate across
    ops until the error budget is exhausted; indels are free."""
    allow = args.chimera_allowable_errors
    pcr_slack = 15
    cigar = [(int(v) >> 4, int(v) & 0xF) for v in np.asarray(cigar, dtype=np.uint32)]

    left = 0
    num_errs = 0
    qp, tp = query_start, target_start
    for length, op in cigar:
        if num_errs > allow:
            break
        if op == 0:
            for i in range(length):
                if qp + i < len(query_seq) and tp + i < len(target_seq):
                    if query_seq[qp + i] == target_seq[tp + i]:
                        left += 1
                    else:
                        num_errs += 1
                        if num_errs > allow and qp + i >= pcr_slack:
                            break
            qp += length
            tp += length
        elif op == 1:
            qp += length
        elif op == 2:
            tp += length

    right = 0
    num_errs = 0
    qp, tp = query_end, target_end
    for length, op in reversed(cigar):
        if num_errs > allow:
            break
        if op == 0:
            for i in range(length):
                if query_seq[qp - i - 1] == target_seq[tp - i - 1]:
                    right += 1
                else:
                    num_errs += 1
                    if num_errs > allow and qp - i + pcr_slack <= len(query_seq):
                        break
            qp -= length
            tp -= length
        elif op == 1:
            qp -= length
        elif op == 2:
            tp -= length

    min_match = args.chimera_detect_length if args.chimera_detect_length is not None else max(args.min_read_length // 10, 100)
    right_opt: int | None = right
    left_opt: int | None = left
    if right < min_match or left >= right:
        right_opt = None
    if left < min_match or right >= left:
        left_opt = None
    if rc:
        return right_opt, left_opt
    return left_opt, right_opt


def detect_chimeras(
    consensuses: list[ConsensusSequence],
    args: ClusterArgs,
    precomputed_hits: tuple[list, list] | None = None,
) -> set[int]:
    """Returns indices of chimeric consensuses (chimera.rs:37-269).

    precomputed_hits: stage-5's (all_vs_all_hits, tagged_consensus_list) —
    merge_similar_consensuses hands it over when no merge changed the list,
    tagged with the exact list object the hits were computed over.  The
    hits are trusted only if that tag IS the list passed here (object
    identity); anything else recomputes, so a drifting caller invariant
    degrades to a recompute instead of silently wrong chimera calls."""
    if not consensuses:
        return set()
    for c in consensuses:
        c.get_decompressed()

    seqs = [c.get_decompressed().tobytes() for c in consensuses]
    if (
        precomputed_hits is not None
        and precomputed_hits[1] is consensuses
        and len(precomputed_hits[0]) == len(consensuses)
    ):
        all_hits = precomputed_hits[0]
    else:
        from ..ops.align_batch import map_batch

        index = TargetIndex([c.get_decompressed() for c in consensuses])
        all_hits = map_batch(index, seqs, no_diag=True, device=args.device)

    chimeric: set[int] = set()
    for qi, qc in enumerate(consensuses):
        qseq = seqs[qi]
        qd = qc.depth
        qlen = len(qseq)
        left_refs: list[tuple[int, int]] = []
        right_refs: list[tuple[int, int]] = []
        for m in all_hits[qi]:
            ri = m.target_id
            # only higher-depth consensuses are parent candidates
            if ri == qi or consensuses[ri].depth <= qd * 3:
                continue
            rseq = seqs[ri]
            if m.strand == -1:
                q0 = qlen - m.query_end
                q1 = qlen - m.query_start
                fq = revcomp_bytes(qseq)
                is_rc = True
            else:
                q0, q1 = m.query_start, m.query_end
                fq = qseq
                is_rc = False
            lm, rm = calculate_match_lengths(
                m.cigar, fq, rseq, q0, q1, m.target_start, m.target_end, is_rc, args
            )
            if lm is not None:
                left_refs.append((ri, lm))
            if rm is not None:
                right_refs.append((ri, rm))

        # observed bipartite rule (parent_similarity lookups always miss -> 0.0)
        found = False
        for lref, llen in left_refs:
            if found:
                break
            for rref, rlen in right_refs:
                if lref == rref:
                    continue
                coverage = (llen + rlen) / qlen
                # (0.9 * max(0.0, 0.7)).min(0.8) = 0.63; upper bound 1.8
                if coverage >= 0.63 and coverage < 1.8:
                    log.debug(
                        "chimera: consensus %d (depth %d) = %d + %d (cov %.2f)",
                        qc.id, qd, consensuses[lref].id, consensuses[rref].id, coverage,
                    )
                    chimeric.add(qi)
                    found = True
                    break
        qc.chimera_score = 0
    log.info("Stage 6: detected %d chimeras", len(chimeric))
    return chimeric


def filter_chimeras(
    consensuses: list[ConsensusSequence], chimeric: set[int]
) -> list[ConsensusSequence]:
    out = [c for i, c in enumerate(consensuses) if i not in chimeric]
    log.info("Stage 6: %d -> %d consensuses after chimera filtering", len(consensuses), len(out))
    return out
