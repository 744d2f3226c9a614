"""A plain SINTAX, the yardstick the port's `sintax` is held to.

It follows savont's sintax.rs as SURVEY.md (section 3.3 and the `sintax`
row of its table) describes it, in plain Python and NumPy on the host, and
imports neither savont_tpu nor savont_tpu_torch:

- k-mers: the canonical 12-mers of a sequence upper-cased, each base two
  bits (A 0, C 1, G 2, T and U 3, any other byte 0, as sintax.rs:37-55
  encodes it), the smaller of the forward word and that of the reverse
  complement;
- queries: for ASV a and iteration j of n_iter, 32 k-mers drawn, with
  replacement, from the ASV's k-mers in order, by a xorshift64 (shifts 13,
  7, 17) seeded with a * n_iter + j + 1 (0 read as 1), each draw the next
  number modulo the count of k-mers;
- scores: a pair's score against a reference is the number of its 32 draws
  that are among the reference's k-mers, a draw repeated counting each time
  (sintax.rs:219-273); the pair goes to the reference of the highest score
  above 0;
- votes: per rank, the name most of a pair's iterations voted for (the
  first voted for among equals), its bootstrap the votes over n_iter, and
  the name reported where the bootstrap is at least min_bootstrap
  (sintax.rs:276-411, species always UNCLASSIFIED);
- outputs: asv_mappings.tsv and genus_abundance.tsv in the program's
  formats (taxonomy.rs's genus writer), ASVs by depth, largest first.

The database is read by this file's own readers: emu-1 (species_taxid.fasta,
the key the header up to its first ':', taxonomy.tsv's row of twelve
columns or more) and silva-138.2 (FASTA, gzip or not, the key the header's
first token up to its first '.'; TAXMAP's line of six fields or more, the
last of an accession winning, its path's levels from the domain down and
"UNKNOWN" past the path's end).  A record whose key has no row is skipped.

Departures from sintax.rs:
- sintax.rs scores the references in parallel, each pair's best kept under
  a lock, so which of two references of the same score wins depends on the
  threads' order; here, as in the program, the earliest record of the file
  wins a tie;
- the references are scored in blocks of BLOCK, on the host's threads, and
  a block's scores are counted through one table of the distinct drawn
  k-mers (a k-mer's draws a pair) rather than a map from k-mer to pairs.

    python3 -m benchmark.plain_sintax --asv-dir DIR --db DB --out OUT [--threads N]
"""
from __future__ import annotations

import argparse
import gzip
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

K = 12
DRAWS = 32
BLOCK = 1024  # references scored at once, at most
RANKS = ("species", "genus", "family", "order", "class", "phylum", "superkingdom")
MASK64 = (1 << 64) - 1

CODE = np.zeros(256, dtype=np.uint32)
for _i, _b in enumerate(b"ACGT"):
    CODE[_b] = _i
CODE[ord("U")] = 3


# ── the database ────────────────────────────────────────────────────────────


def _fasta(path: Path):
    """(header without '>', sequence) of each record, lines joined, each
    line without its surrounding whitespace."""
    with (gzip.open if path.name.endswith(".gz") else open)(path, "rb") as f:
        head, parts = None, []
        for line in f:
            if line.startswith(b">"):
                if head is not None:
                    yield head, b"".join(parts)
                head, parts = line[1:].rstrip(b"\r\n").decode(), []
            else:
                parts.append(line.strip())
        if head is not None:
            yield head, b"".join(parts)


def _rows(path: Path, min_fields: int):
    """The tab-separated rows after the header line with at least
    min_fields fields."""
    with (gzip.open(path, "rt") if path.name.endswith(".gz") else open(path)) as f:
        next(f, None)
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) >= min_fields:
                yield fields


def read_database(db_dir: Path):
    """(FASTA path, key of a header, key -> the names of RANKS) of an emu-1
    or silva-138.2 directory, told apart by its .savont_db marker."""
    marker = db_dir / ".savont_db"
    fmt = marker.read_text().strip() if marker.exists() else db_dir.name
    if fmt == "emu-1":
        ranks = {f[0]: (f[1], f[2], f[3], f[4], f[5], f[6], f[8])
                 for f in _rows(db_dir / "taxonomy.tsv", 12)}
        return db_dir / "species_taxid.fasta", (lambda h: h.split(":")[0]), ranks
    if fmt == "silva-138.2":
        names = sorted(p.name for p in db_dir.iterdir())
        fasta = next(n for n in names if n.endswith((".fasta", ".fasta.gz", ".fa.gz")))
        taxmap = [n for n in names if n.startswith("taxmap_") and n.endswith((".txt", ".txt.gz"))][-1]
        ranks = {}
        for f in _rows(db_dir / taxmap, 6):
            path = [x.strip() for x in f[3].split(";")]
            level = [path[j] if j < len(path) else "UNKNOWN" for j in range(6)]
            ranks[f[0]] = (f[4], level[5], level[4], level[3], level[2], level[1], level[0])

        def key(h):
            tok = h.split()
            return tok[0].split(".")[0] if tok else None

        return db_dir / fasta, key, ranks
    raise ValueError(f"plain sintax: no reader for the database format {fmt!r}")


# ── k-mers and draws ────────────────────────────────────────────────────────


def kmers(seq: bytes) -> np.ndarray:
    """The canonical K-mers of seq upper-cased, one a position, in order."""
    return _words(CODE[np.frombuffer(seq.upper(), dtype=np.uint8)])


def _words(c: np.ndarray) -> np.ndarray:
    """The canonical K-mer at each position of the codes c that has K codes
    from it on."""
    n = len(c) - K + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    fwd = np.zeros(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for j in range(K):
        fwd = (fwd << np.uint32(2)) | c[j:j + n]
        rev = rev | ((np.uint32(3) - c[j:j + n]) << np.uint32(2 * j))
    return np.minimum(fwd, rev)


def draws(asvs: list[bytes], n_iter: int) -> np.ndarray:
    """(len(asvs) * n_iter, DRAWS) int64: pair a * n_iter + j's draws, -1
    for an ASV without a k-mer."""
    out = np.full((len(asvs) * n_iter, DRAWS), -1, dtype=np.int64)
    for a, seq in enumerate(asvs):
        km = kmers(seq).tolist()
        if not km:
            continue
        for j in range(n_iter):
            s = max(a * n_iter + j + 1, 1) & MASK64
            row = []
            for _ in range(DRAWS):
                s ^= (s << 13) & MASK64
                s ^= s >> 7
                s ^= (s << 17) & MASK64
                row.append(km[s % len(km)])
            out[a * n_iter + j] = row
    return out


# ── scores ──────────────────────────────────────────────────────────────────


class Scorer:
    """Each pair's best score and the earliest reference that has it, over
    blocks of references given in file order."""

    def __init__(self, drawn: np.ndarray):
        self.n_pairs = len(drawn)
        live = drawn >= 0
        self.keys = np.unique(drawn[live])  # the distinct drawn k-mers
        self.lut = np.full(1 << (2 * K), -1, dtype=np.int32)
        self.lut[self.keys] = np.arange(len(self.keys))
        # (distinct k-mer, pair) -> draws of it, one entry a draw, by k-mer
        d = self.lut[drawn[live]]
        pair = np.repeat(np.arange(self.n_pairs, dtype=np.int32), DRAWS)[live.ravel()]
        order = np.argsort(d, kind="stable")
        self.pair_of = pair[order]
        self.start = np.searchsorted(d[order], np.arange(len(self.keys) + 1)).astype(np.int32)
        self.best = np.zeros(self.n_pairs, dtype=np.int64)
        self.ref = np.full(self.n_pairs, -1, dtype=np.int64)
        # references a block: a block's table of counts holds at most 2^24
        self.block_refs = max(1, min(BLOCK, (1 << 24) // max(self.n_pairs, 1)))

    def block(self, seqs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """The block's best score a pair and the block's first reference
        with it (an index into seqs)."""
        lens = np.array([len(q) for q in seqs], dtype=np.int64)
        w = self.lut[_words(CODE[np.frombuffer(b"".join(seqs).upper(), dtype=np.uint8)])]
        # the reference of each position, and whether its K-mer lies inside it
        ref = np.repeat(np.arange(len(seqs), dtype=np.int64), lens)[:len(w)]
        end = np.repeat(np.cumsum(lens), lens)[:len(w)]
        ok = (np.arange(len(w)) + K <= end) & (w >= 0)
        # each distinct (reference, drawn k-mer) once, then each of its draws
        r, d = np.divmod(np.unique(ref[ok] * len(self.keys) + w[ok]), len(self.keys))
        n = self.start[d + 1] - self.start[d]
        first = np.repeat(self.start[d] - (np.cumsum(n, dtype=np.int32) - n), n) + \
            np.arange(int(n.sum()), dtype=np.int32)
        cell = np.repeat((r * self.n_pairs).astype(np.int32), n) + self.pair_of[first]
        counts = np.bincount(cell, minlength=len(seqs) * self.n_pairs).reshape(len(seqs), self.n_pairs)
        return counts.max(axis=0, initial=0), counts.argmax(axis=0)

    def take(self, score: np.ndarray, arg: np.ndarray, ordinals: list[int]) -> None:
        better = score > self.best
        self.best[better] = score[better]
        self.ref[better] = np.asarray(ordinals, dtype=np.int64)[arg[better]]


def best_references(fasta: Path, key, ranks: dict, drawn: np.ndarray, threads: int):
    """Each pair's best score and the RANKS names of its reference (None
    where no reference scores above 0)."""
    sc = Scorer(drawn)
    kept: list[tuple] = []  # the ranks of each kept record, by its index among them

    def blocks():
        seqs, ords = [], []
        for head, seq in _fasta(fasta):
            k = key(head)
            if k is None or k not in ranks:
                continue
            seqs.append(seq)
            ords.append(len(kept))
            kept.append(ranks[k])
            if len(seqs) == sc.block_refs:
                yield seqs, ords
                seqs, ords = [], []
        if seqs:
            yield seqs, ords

    with ThreadPoolExecutor(threads) as pool:
        pending = []
        for seqs, ords in blocks():
            pending.append((pool.submit(sc.block, seqs), ords))
            if len(pending) > 2 * threads:
                f, o = pending.pop(0)
                sc.take(*f.result(), o)
        for f, o in pending:  # in file order: an earlier block keeps a tie
            sc.take(*f.result(), o)
    return sc.best, [kept[r] if r >= 0 else None for r in sc.ref.tolist()]


# ── votes and outputs ───────────────────────────────────────────────────────


def _depth(header: str) -> int:
    """The ASV's depth from its name's last '_' field: the whole numbers of
    its '-' parts summed, at least 1."""
    name = header.split()[0] if header.split() else header
    total = 0
    for part in (name.split("_")[-1] if "_" in name else "1").split("-"):
        try:
            total += int(part)
        except ValueError:
            pass
    return max(total, 1)


def sintax(asv_dir: Path, db_dir: Path, out_dir: Path, n_iter: int = 100,
           min_bootstrap: float = 0.8, detailed: bool = False, threads: int = 1) -> None:
    """Write out_dir/asv_mappings.tsv and out_dir/genus_abundance.tsv for the
    ASVs of asv_dir/final_asvs.fasta against the database db_dir."""
    asvs = list(_fasta(asv_dir / "final_asvs.fasta"))
    fasta, key, ranks = read_database(db_dir)
    drawn = draws([s.upper() for _, s in asvs], n_iter)
    score, won = best_references(fasta, key, ranks, drawn, threads)
    depths = [_depth(h) for h, _ in asvs]
    total = sum(depths)

    hits = []
    for a, (head, _) in enumerate(asvs):
        votes = [dict() for _ in RANKS]
        for j in range(a * n_iter, (a + 1) * n_iter):
            if won[j] is not None and score[j] > 0:
                for v, name in zip(votes, won[j]):
                    v[name] = v.get(name, 0) + 1
        if not votes[0]:
            hits.append(None)
            continue
        top = []
        for v in votes:
            most = max(v.values())
            top.append((next(n for n, c in v.items() if c == most), most / n_iter))
        hits.append({"name": head.split()[0], "depth": depths[a],
                     "abundance": depths[a] / total if total else 0.0, "top": top})

    order = sorted(range(len(asvs)), key=lambda i: -(hits[i]["abundance"] if hits[i] else 0.0))
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "asv_mappings.tsv", "w") as f:
        f.write("asv_header\tdepth\tspecies_bootstrap\tgenus_bootstrap\tfamily_bootstrap\t"
                "order_bootstrap\tclass_bootstrap\tphylum_bootstrap\tsuperkingdom_bootstrap\t"
                "species\tgenus\tfamily\torder\tclass\tphylum\tsuperkingdom\n")
        for h in (hits[i] for i in order if hits[i] is not None):
            boots = "\t".join(f"{b:.3f}" for _, b in h["top"])
            names = "\t".join(["UNCLASSIFIED"] + [n if b >= min_bootstrap else "UNCLASSIFIED"
                                                  for n, b in h["top"][1:]])
            f.write(f"{h['name']}\t{h['depth']}\t{boots}\t{names}\n")

    genera: dict[tuple, float] = {}  # (genus, family, order, class, phylum, clade, superkingdom)
    for h in (hits[i] for i in order if hits[i] is not None):
        unc = f"UNCLASSIFIED-({h['name']})" if detailed else "UNCLASSIFIED"
        g = [n if b >= min_bootstrap else unc for n, b in h["top"][1:]]
        row = (*g[:5], "", g[5])  # sintax names no clade
        genera[row] = genera.get(row, 0.0) + h["abundance"]
    with open(out_dir / "genus_abundance.tsv", "w") as f:
        f.write("abundance\tgenus\tfamily\torder\tclass\tphylum\tclade\tsuperkingdom\n")
        for row, a in sorted(genera.items(), key=lambda x: -x[1]):
            f.write(f"{a}\t" + "\t".join(row) + "\n")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--asv-dir", type=Path, required=True)
    p.add_argument("--db", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--n-iter", type=int, default=100)
    p.add_argument("--min-bootstrap", type=float, default=0.8)
    p.add_argument("--detailed-unclassified", action="store_true")
    p.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    a = p.parse_args(argv)
    sintax(a.asv_dir, a.db, a.out, a.n_iter, a.min_bootstrap, a.detailed_unclassified, a.threads)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
