"""A SILVA SSU Ref NR99 138.2 database (silva-138.2) of a sample's
templates, made from the run's seed, and its plain reader.

build() writes what savont's `download silva-138.2` leaves on disk: FASTA
(gzip), TAXMAP and a `.savont_db` marker naming silva-138.2.  A FASTA header
is `>ACCESSION.start.stop Domain;...;Genus;Organism` (the path without its
last ';', then the organism name); sequences are in the RNA alphabet (U), in
lines of LINE bases.  TAXMAP has a header line, then one line a record:
primaryAccession, start, stop, the path ending in ';', organism_name and the
path's taxid, separated by tabs.

The records, graded as databases/emu-1.py grades them:
- every template, as a record of its own accession under its species
  (template j and its variant j + n_random are species j % n_random, genus
  Zymogenus_<species % 8>);
- near: intra-species operon variants (0.3% substitutions, 0-1 indels of
  1-30 bases; 15% of the rest), up to OPERONS of one template sharing an
  accession with their own start.stop, as the rRNA operons of one genome;
- sib: sibling species of the genus (2-8%, 0-3 indels; 35%); fam: relatives
  in another genus of the family (10-20%, 2-7 indels; 30%);
- background: random bases, Archaea and Eukaryota at their shares of the
  whole database (SHARES) and Bacteria the rest, with lengths by domain
  (LENGTHS; of Eukaryota one in EUK_LONG[0] is EUK_LONG[1]-EUK_LONG[2]
  long), a share SHORT_PATH of them with a path of four levels (no genus).
A share UNCULTURED of the sib, fam and background decoys is an "uncultured"
organism, and of the background ones in genus "uncultured" too; a share
IUPAC_SHARE of all decoys holds 1-IUPAC_MAX IUPAC bytes.  Decoys are drawn
from template k % n_templates in turn, and in batches of BATCH.  The seed
changes the draws, never the shape: the count of each kind, domain, path
depth and accession with several records follows from n_refs and the
sample alone.
"""
from __future__ import annotations

import gzip
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

import numpy as np

from benchmark.refio import Records, read_fasta
from benchmark.sample import BASES, Sample

KEYWORD = "silva-138.2"
FASTA = "SILVA_138.2_SSURef_NR99_tax_silva_trunc.fasta.gz"
TAXMAP = "taxmap_slv_ssu_ref_nr_138.2.txt"
TAXMAP_HEADER = "primaryAccession\tstart\tstop\tpath\torganism_name\ttaxid\n"
RNA = np.frombuffer(b"ACGU", dtype=np.uint8)
IUPAC = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)

# the shapes this writer sets itself (the configuration lists them under `assumed`)
LINE = 60                 # bases a FASTA line
GZIP_LEVEL = 1
SHARES = {"Archaea": 0.042, "Eukaryota": 0.113}  # of all records, drawn from the background
LENGTHS = {"Bacteria": (1200, 1600), "Archaea": (1200, 1600), "Eukaryota": (1400, 2600)}
EUK_LONG = (20, 2600, 4000)
OPERONS = 7               # records of one genome, at most
IUPAC_SHARE, IUPAC_MAX = 0.05, 8
UNCULTURED = 0.2
SHORT_PATH = 0.03
MAX_INDELS, MAX_INDEL_LEN = 7, 30
BATCH = 8192              # records drawn at once
THREADS = 4               # as the configurations' `threads`
ORGANISM_WORD = {"Bacteria": "bacterium", "Archaea": "archaeon", "Eukaryota": "eukaryote"}
SEED_PATH = ("Bacteria", "Bacillota", "Bacilli", "Bacillales")
# the decoys drawn from a template: share of the decoys, substitution rates, indels
GRADES = {"near": (0.15, (0.003, 0.003), (0, 1)), "sib": (0.35, (0.02, 0.08), (0, 3)),
          "fam": (0.30, (0.10, 0.20), (2, MAX_INDELS))}


def _derived(rng, tpl: np.ndarray, g: np.ndarray, sub: tuple, indels: tuple):
    """Rows of templates g with substitutions at a rate drawn per row from
    sub, and indels[0]-indels[1] indels of 1-MAX_INDEL_LEN bases placed on the
    template's coordinates, half of them deletions: (codes back to back,
    lengths)."""
    n, t = len(g), tpl.shape[1]
    codes = tpl[g]
    hit = rng.random((n, t), dtype=np.float32) < rng.uniform(*sub, n).astype(np.float32)[:, None]
    codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) % 4
    k = rng.integers(indels[0], indels[1] + 1, n)
    keep = np.ones((n, t), dtype=bool)
    ins = []  # (rows, template positions, lengths) of each slot's insertions
    span = np.arange(MAX_INDEL_LEN)
    for slot in range(indels[1]):
        length = rng.integers(1, MAX_INDEL_LEN + 1, n)
        at = rng.integers(0, t - MAX_INDEL_LEN, n)
        dele = rng.random(n) < 0.5
        rows = np.flatnonzero((slot < k) & dele)
        inside = span[None, :] < length[rows, None]
        keep[np.repeat(rows, inside.sum(1)), (at[rows, None] + span[None, :])[inside]] = False
        rows = np.flatnonzero((slot < k) & ~dele)
        ins.append((rows, at[rows], length[rows]))
    kept = keep.sum(1)
    r, at, length = (np.concatenate(x) for x in zip(*ins)) if ins else (np.zeros(0, np.int64),) * 3
    # an insertion goes before template base `at`, after the row's kept bases before it
    before = (np.cumsum(keep, axis=1, dtype=np.int32) - keep)[r, at]
    pos = (np.cumsum(kept) - kept)[r] + before
    flat = np.insert(codes[keep], np.repeat(pos, length),
                     rng.integers(0, 4, int(length.sum()), dtype=np.uint8))
    return flat, kept + np.bincount(r, weights=length, minlength=n).astype(np.int64)


def _background_lengths(rng, domains: list[str]) -> np.ndarray:
    lo = np.array([LENGTHS[d][0] for d in domains])
    hi = np.array([LENGTHS[d][1] for d in domains])
    euk = np.flatnonzero(np.array(domains) == "Eukaryota")
    long = euk[::EUK_LONG[0]]
    lo[long], hi[long] = EUK_LONG[1], EUK_LONG[2]
    return rng.integers(lo, hi + 1)


@lru_cache(maxsize=None)
def _seed_path(g: int, genus: str | None = None) -> str:
    return ";".join([*SEED_PATH, f"Zymofam_{g % 4}", genus or f"Zymogenus_{g % 8}"])


@lru_cache(maxsize=None)
def _background_path(j: int, domain: str, uncultured: bool, short: bool) -> str:
    if domain == "Bacteria":
        levels = ["Bacteria", f"Bgphylum_{j % 4}", f"Bgclass_{j % 8}", f"Bgorder_{j % 16}",
                  f"Bgfam_{j % 32}", f"Bggenus_{j}"]
    elif domain == "Archaea":
        levels = ["Archaea", f"Arphylum_{j % 2}", f"Arclass_{j % 4}", f"Arorder_{j % 8}",
                  f"Arfam_{j % 16}", f"Argenus_{j % 32}"]
    else:  # eukaryotic paths run deeper; savont reads their sixth level as the genus
        levels = ["Eukaryota"] + [f"Euclade{d}_{j % 2 ** d}" for d in range(1, 8)]
    if uncultured:
        levels = levels[:5] + ["uncultured"]
    return ";".join(levels[:4] if short else levels)


def _accessions(rng, n: int) -> list[str]:
    """n distinct GenBank-style accessions: two letters and six digits."""
    num = rng.choice(26 * 26 * 10**6, n, replace=False)
    letters = [chr(65 + a) + chr(65 + b) for a in range(26) for b in range(26)]
    return [f"{letters[x // 10**6]}{x % 10**6:06d}" for x in num.tolist()]


def build(sample: Sample, n_refs: int, rng, out_dir: Path) -> Path:
    """Write out_dir/silva (FASTA, TAXMAP, .savont_db) and return that
    directory."""
    tpl = np.stack([np.searchsorted(BASES, np.frombuffer(t, np.uint8)).astype(np.uint8)
                    for t in sample.templates])
    n_tpl, t_len = tpl.shape
    if t_len - MAX_INDELS * MAX_INDEL_LEN < LENGTHS["Bacteria"][0]:
        raise ValueError(f"silva-138.2: templates of {t_len} bases can lose "
                         f"{MAX_INDELS * MAX_INDEL_LEN} and must keep SILVA Ref's floor of "
                         f"{LENGTHS['Bacteria'][0]}")
    budget = n_refs - n_tpl
    if budget < 0:
        raise ValueError(f"silva-138.2: {n_refs} references cannot hold {n_tpl} templates")
    n_near, n_sib, n_fam = (int(budget * GRADES[k][0]) for k in ("near", "sib", "fam"))
    n_bg = budget - n_near - n_sib - n_fam
    n_arc = min(n_bg, max(1, round(SHARES["Archaea"] * n_refs)))
    n_euk = min(n_bg - n_arc, max(1, round(SHARES["Eukaryota"] * n_refs)))
    bg_domain = ["Archaea"] * n_arc + ["Eukaryota"] * n_euk + ["Bacteria"] * (n_bg - n_arc - n_euk)
    species = [j % sample.n_random for j in range(n_tpl)]

    # the near decoys of template g, in turn, fill genomes of up to OPERONS records
    near_g = np.arange(n_near) % n_tpl
    genomes, near_acc = np.unique(np.arange(n_near) // n_tpl // OPERONS * n_tpl + near_g,
                                  return_inverse=True)
    acc = _accessions(rng, n_tpl + len(genomes) + n_sib + n_fam + n_bg)
    acc_near, acc_rest = acc[n_tpl:n_tpl + len(genomes)], iter(acc[n_tpl + len(genomes):])
    iupac = np.zeros(budget, dtype=bool)
    iupac[rng.choice(budget, round(IUPAC_SHARE * budget), replace=False)] = True
    n_other = n_sib + n_fam + n_bg
    uncultured = np.zeros(n_other, dtype=bool)
    uncultured[rng.choice(n_other, round(UNCULTURED * n_other), replace=False)] = True
    short = np.zeros(n_bg, dtype=bool)
    short[rng.choice(n_bg, round(SHORT_PATH * n_bg), replace=False)] = True

    # (accession, start, path, organism) of every record, in file order
    meta = [(acc[j], 1, _seed_path(species[j]), f"Zymoseed species {species[j]}")
            for j in range(n_tpl)]
    starts = rng.integers(1, 6_000_000, n_near).tolist()
    meta += [(acc_near[a], start, _seed_path(species[g]), f"Zymoseed species {species[g]}")
             for a, start, g in zip(near_acc.tolist(), starts, near_g.tolist())]
    unc = iter(uncultured.tolist())
    meta += [(next(acc_rest), 1, _seed_path(species[i % n_tpl]),
              "uncultured bacterium" if next(unc) else f"Sibling sp. {i}") for i in range(n_sib)]
    meta += [(next(acc_rest), 1, _seed_path(species[i % n_tpl], f"Relgenus_{i % 64}"),
              "uncultured bacterium" if next(unc) else f"Relative sp. {i}") for i in range(n_fam)]
    for i, (d, s) in enumerate(zip(bg_domain, short.tolist())):
        u = next(unc)
        meta.append((next(acc_rest), 1, _background_path(i % 128, d, u, s),
                     f"uncultured {ORGANISM_WORD[d]}" if u else f"Background sp. {i}"))

    taxids: dict[str, int] = {}
    for m in meta:
        taxids.setdefault(m[2], len(taxids) + 1)
    kinds = [("tpl", n_tpl), ("near", n_near), ("sib", n_sib), ("fam", n_fam), ("bg", n_bg)]
    jobs, first = [], 0  # (kind, first record, first of its kind, count)
    for kind, n in kinds:
        jobs += [(kind, first + b0, b0, min(BATCH, n - b0)) for b0 in range(0, n, BATCH)]
        first += n
    seeds = rng.integers(0, 2**63, len(jobs)).tolist()

    def batch(j: int) -> tuple[bytes, str]:
        """Job j's records as a gzip member of FASTA and its TAXMAP lines."""
        kind, first, b0, b = jobs[j]
        r = np.random.default_rng(seeds[j])
        if kind == "tpl":
            flat, lengths = tpl[b0:b0 + b].ravel(), np.full(b, t_len)
        elif kind == "bg":
            lengths = _background_lengths(r, bg_domain[b0:b0 + b])
            flat = r.integers(0, 4, int(lengths.sum()), dtype=np.uint8)
        else:
            flat, lengths = _derived(r, tpl, np.arange(b0, b0 + b) % n_tpl, *GRADES[kind][1:])
        letters = RNA[flat]
        if kind != "tpl":  # IUPAC bytes at random places of the chosen decoys
            rows = np.flatnonzero(iupac[first - n_tpl:first - n_tpl + b])
            rows = np.repeat(rows, r.integers(1, IUPAC_MAX + 1, len(rows)))
            at = (np.cumsum(lengths) - lengths)[rows] + (r.random(len(rows)) * lengths[rows]).astype(int)
            letters[at] = IUPAC[r.integers(0, len(IUPAC), len(rows))]
        raw, o, fasta, lines = letters.tobytes(), 0, [], []
        for (a, start, path, organism), n in zip(meta[first:first + b], lengths.tolist()):
            seq, o, stop = raw[o:o + n], o + n, start + n - 1
            fasta.append(f">{a}.{start}.{stop} {path};{organism}\n".encode())
            fasta += [seq[i:i + LINE] + b"\n" for i in range(0, n, LINE)]
            lines.append(f"{a}\t{start}\t{stop}\t{path};\t{organism}\t{taxids[path]}\n")
        return gzip.compress(b"".join(fasta), GZIP_LEVEL, mtime=0), "".join(lines)

    out = out_dir / "silva"
    out.mkdir(parents=True, exist_ok=True)
    # numpy and zlib let go of the interpreter lock: the batches are drawn and
    # compressed on THREADS threads, and written in order as gzip members
    with ThreadPoolExecutor(THREADS) as pool, open(out / FASTA, "wb") as fa, \
            open(out / TAXMAP, "w") as tm:
        tm.write(TAXMAP_HEADER)
        for gz, lines in pool.map(batch, range(len(jobs))):
            fa.write(gz)
            tm.write(lines)
    (out / ".savont_db").write_text(KEYWORD)
    return out


def read(db_dir: Path) -> Records:
    """The directory read plainly: a record's key is its header up to the
    first '.'; the key's TAXMAP line (the last, where the accession has
    several) gives its species, the organism name, and its genus, the sixth
    level of the path split at ';' ("UNKNOWN" past the path's end); a record
    whose key has no line is skipped; U reads as T."""
    taxa: dict[str, tuple[str, str]] = {}
    with open(db_dir / TAXMAP) as f:
        next(f)
        for line in f:
            acc, _, _, path, organism, _ = line.rstrip("\n").split("\t")
            levels = [x.strip() for x in path.split(";")]
            taxa[acc] = (organism, levels[5] if len(levels) > 5 else "UNKNOWN")
    to_dna = bytes.maketrans(b"U", b"T")
    kept = [(taxa[h.split(".", 1)[0]], s.translate(to_dna))
            for h, s in read_fasta(db_dir / FASTA) if h.split(".", 1)[0] in taxa]
    return Records([s for _, s in kept], [t[0] for t, _ in kept], [t[1] for t, _ in kept])
