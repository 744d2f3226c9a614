"""Validation oracle: check emitted ASVs against a reference ASV set.

Mirrors the reference's primary acceptance test
(tests/integration_test.rs:91-160): every produced ASV must align to some
reference ASV with NM=0 (minimap2 map_ont as oracle there; our banded
aligner here, plus an exact-substring fast path which is strictly stronger).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .io.fastx import read_fastx
from .ops.align import TargetIndex, map_query
from .ops.encode import revcomp_bytes


@dataclass
class AsvValidation:
    header: str
    nm: int | None  # None = unmapped (or mapped below the coverage floor)
    exact_substring: bool
    ref_hit: str | None
    coverage: float = 1.0  # aligned-span fraction of the ASV length


#: Minimum aligned-span fraction for a non-exact hit to count.  minimap2's
#: primary mapping of a clean full-length ASV covers essentially the whole
#: query (integration_test.rs:147-159 takes the primary hit's NM); without
#: this floor a chimeric ASV with one clean local span and a divergent tail
#: could pass NM=0 on the local banded hit alone.
MIN_QUERY_COVERAGE = 0.95


def validate_asvs(asv_fasta: str, ref_fasta: str) -> list[AsvValidation]:
    refs = [(r.id, r.seq.upper()) for r in read_fastx(ref_fasta)]
    asvs = [(r.id, r.seq.upper()) for r in read_fastx(asv_fasta)]
    index = TargetIndex([np.frombuffer(s, dtype=np.uint8) for _, s in refs])

    results = []
    for header, seq in asvs:
        rc = revcomp_bytes(seq)
        exact = None
        for rid, rseq in refs:
            if seq in rseq or rc in rseq or rseq in seq or rseq in rc:
                exact = rid
                break
        if exact is not None:
            results.append(AsvValidation(header, 0, True, exact))
            continue
        hits = map_query(index, seq)
        covered = [
            m for m in hits
            if (m.query_end - m.query_start) >= MIN_QUERY_COVERAGE * len(seq)
        ]
        if not covered:
            # Mapped-but-partial reports the best partial hit's coverage so
            # the failure is diagnosable, but nm stays None: a local span is
            # not evidence the whole ASV is clean.
            cov = 0.0
            if hits:
                b = min(hits, key=lambda m: m.nm)
                cov = (b.query_end - b.query_start) / len(seq)
            results.append(AsvValidation(header, None, False, None, cov))
        else:
            best = min(covered, key=lambda m: m.nm)
            results.append(
                AsvValidation(
                    header,
                    best.nm,
                    False,
                    refs[best.target_id][0],
                    (best.query_end - best.query_start) / len(seq),
                )
            )
    return results


def main() -> None:
    import sys

    res = validate_asvs(sys.argv[1], sys.argv[2])
    perfect = sum(1 for r in res if r.nm == 0)
    print(f"{perfect}/{len(res)} ASVs perfect (NM=0)")
    for r in res:
        status = "EXACT" if r.exact_substring else (f"NM={r.nm}" if r.nm is not None else "UNMAPPED")
        print(f"  {status:10} {r.header.split()[0]} -> {r.ref_hit}")
    sys.exit(0 if perfect == len(res) and res else 1)


if __name__ == "__main__":
    main()
