"""Plain readers of the files the outputs are judged from, and the inputs'
ground truth the checks compare them with.  Nothing here imports the port."""
from __future__ import annotations

import gzip
from math import ceil
from pathlib import Path

from .sample import revcomp


def read_fasta(path: Path) -> list[tuple[str, bytes]]:
    """(header line without '>', sequence upper-cased) in file order; a
    sequence may span lines, and a path ending in .gz is decompressed."""
    with (gzip.open if path.suffix == ".gz" else open)(path, "rb") as f:
        data = f.read()
    out: list[tuple[str, bytes]] = []
    for rec in (b"\n" + data).split(b"\n>")[1:]:
        head, _, body = rec.partition(b"\n")
        out.append((head.rstrip(b"\r").decode(),
                    body.replace(b"\n", b"").replace(b"\r", b"").upper()))
    return out


def read_table(path: Path) -> list[dict[str, str]]:
    """A tab-separated file with a header line, as one dict a row."""
    lines = path.read_text().splitlines()
    if not lines:
        return []
    cols = lines[0].split("\t")
    return [dict(zip(cols, ln.split("\t"))) for ln in lines[1:] if ln]


def feature_depths(path: Path) -> dict[str, float]:
    """feature-table.tsv: ASV name -> total depth over its samples."""
    out = {}
    for ln in path.read_text().splitlines()[1:]:
        parts = ln.split("\t")
        if len(parts) >= 2:
            out[parts[0]] = sum(float(x) for x in parts[1:])
    return out


# An ASV is right for a template when it equals the template, or a piece of
# it, on either strand with no edit (NM=0, the repository's own test of an
# ASV), and keeps at least MIN_COVER of its length.  The variant sites lie 60
# or more bases from either end, so such a piece tells a template from its
# variant.
MIN_COVER = 0.99


def containing(seq: bytes, seqs: list[bytes], min_cover: float = MIN_COVER) -> list[int]:
    """The indices of seqs that hold seq or its reverse complement whole,
    where seq is at least min_cover of their length."""
    rc = revcomp(seq)
    return [j for j, t in enumerate(seqs)
            if len(seq) >= min_cover * len(t) and (seq in t or rc in t)]


class Records:
    """A database's records as its format's plain reader gives them (each
    record's sequence in the DNA alphabet, upper-cased, its species and its
    genus), and the records that hold a sequence.  A record of length L can
    hold a sequence of at least MIN_COVER * L bases only where the sequence
    covers its KEY bases from offset ceil((1 - MIN_COVER) * L), so each
    record is indexed by that piece and a sequence looks up its own first
    pieces."""

    KEY = 32

    def __init__(self, seqs: list[bytes], species: list[str], genus: list[str]):
        self.seqs, self.ranks = seqs, {"species": species, "genus": genus}
        self.keys: dict[bytes, list[int]] = {}
        for i, s in enumerate(self.seqs):
            o = ceil((1 - MIN_COVER) * len(s))
            self.keys.setdefault(s[o:o + self.KEY], []).append(i)

    def holding(self, seq: bytes) -> set[int]:
        """The records that hold seq (either strand) whole, seq being at
        least MIN_COVER of their length."""
        out = set()
        # the key's place in seq: at most ceil((1 - MIN_COVER) * L), L <= len(seq) / MIN_COVER
        last = ceil((1 - MIN_COVER) * len(seq) / MIN_COVER)
        for q in (seq, revcomp(seq)):
            for p in range(last + 1):
                for i in self.keys.get(q[p:p + self.KEY], ()):
                    if len(seq) >= MIN_COVER * len(self.seqs[i]) and q in self.seqs[i]:
                        out.add(i)
        return out

    def taxa_holding(self, seq: bytes, rank: str) -> set[str]:
        """The `rank` names of every record that holds seq."""
        return {self.ranks[rank][i] for i in self.holding(seq)}


def abundance_gap(got: dict[str, float], want: dict[str, float]) -> float:
    """The widest gap between two abundance tables, over their union."""
    keys = set(got) | set(want)
    return max((abs(got.get(k, 0.0) - want.get(k, 0.0)) for k in keys), default=0.0)
