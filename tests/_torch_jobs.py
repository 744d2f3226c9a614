"""Seed-pinned planner jobs shared by the savont_tpu_torch tests.

Each job set holds corridors whose largest per-row advance is 1, exactly 2
(small deletions), and above 2 (a structural deletion), on both strands,
plus an unrelated pair.  Inputs are made with numpy from a fixed seed and
need no external data."""
import numpy as np

from savont_tpu.ops.align import TargetIndex
from savont_tpu.ops.align_batch import plan_jobs
from savont_tpu.ops.encode import revcomp_bytes

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(rng, n: int) -> bytes:
    return rng.choice(BASES, n).astype(np.uint8).tobytes()


def substitute(rng, seq: bytes, rate: float) -> bytearray:
    q = bytearray(seq)
    for p in rng.choice(len(q), int(rate * len(q)), replace=False):
        q[p] = b"ACGT"[rng.integers(4)]
    return q


def max_advance(job) -> int:
    return int(np.diff(job.lo).max()) if len(job.lo) > 1 else 0


def mixed_jobs(seed: int, band: int, n: int = 12, lmin: int = 300, lmax: int = 600):
    """Jobs of kinds cycling: substitutions only, 2-6 bp deletions, one
    60 bp deletion, unrelated query; odd trials reverse-complemented."""
    rng = np.random.default_rng(seed)
    jobs = []
    for trial in range(n):
        t = rand_seq(rng, int(rng.integers(lmin, lmax)))
        q = substitute(rng, t, 0.04)
        kind = trial % 4
        if kind == 1:
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(30, len(q) - 40))
                del q[p : p + int(rng.integers(2, 7))]
        elif kind == 2:
            del q[len(q) // 2 : len(q) // 2 + 60]
        elif kind == 3:
            q = bytearray(rand_seq(rng, len(t)))
        q = bytes(q)
        if trial % 2:
            q = revcomp_bytes(q)
        jobs.extend(plan_jobs(TargetIndex([t]), q, band=band, min_anchors=2))
    return jobs


def substitution_jobs(seed: int, band: int, n: int, length: int):
    """Substitution-only jobs: corridors advance by at most 1 per row."""
    rng = np.random.default_rng(seed)
    jobs = []
    while len(jobs) < n:
        t = rand_seq(rng, length)
        q = bytes(substitute(rng, t, 0.03))
        jobs.extend(plan_jobs(TargetIndex([t]), q, band=band, min_anchors=2))
    return jobs[:n]

