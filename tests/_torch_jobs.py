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
    60 bp deletion, unrelated query; odd trials reverse-complemented
    (savont_tpu's planner over mixed_pairs)."""
    jobs = []
    for q, t in mixed_pairs(seed, n, lmin, lmax):
        jobs.extend(plan_jobs(TargetIndex([t]), q, band=band, min_anchors=2))
    return jobs


def mixed_pairs(seed: int, n: int = 12, lmin: int = 300, lmax: int = 600) -> list[tuple[bytes, bytes]]:
    """The (query, target) pairs behind mixed_jobs."""
    rng = np.random.default_rng(seed)
    pairs = []
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
        pairs.append((q, t))
    return pairs


def substitution_jobs(seed: int, band: int, n: int, length: int):
    """Substitution-only jobs: corridors advance by at most 1 per row."""
    rng = np.random.default_rng(seed)
    jobs = []
    while len(jobs) < n:
        t = rand_seq(rng, length)
        q = bytes(substitute(rng, t, 0.03))
        jobs.extend(plan_jobs(TargetIndex([t]), q, band=band, min_anchors=2))
    return jobs[:n]



def clear_caches() -> None:
    """Empty the module-level state of both packages that a pipeline run
    fills (parsed reads and their encodes, the planner's code and minimizer
    memos, the planner-code registry), so two runs in one process start
    alike."""
    import savont_tpu.ops.align
    import savont_tpu.ops.align_batch
    import savont_tpu.ops.encode
    import savont_tpu.pipeline.stage1_kmers
    import savont_tpu_torch.ops.align
    import savont_tpu_torch.ops.align_batch
    import savont_tpu_torch.ops.encode
    import savont_tpu_torch.pipeline.stage1_kmers

    for pkg in (savont_tpu, savont_tpu_torch):
        s1 = pkg.pipeline.stage1_kmers
        s1._READ_CACHE.clear()
        s1._ENCODE_CACHE.clear()
        s1._READ_CACHE_BYTES = 0
        for cache in (pkg.ops.align._MINI_CACHE, pkg.ops.align._IDMINI_CACHE,
                      pkg.ops.align_batch._QCODE_CACHE, pkg.ops.align_batch._IDCODE_CACHE,
                      pkg.ops.encode._CODES_REG):
            cache.clear()
