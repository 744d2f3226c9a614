"""An EMU-format database (emu-1) of a sample's templates, made from the
run's seed, and its plain reader.

build() is a frozen copy of the port's db/synth.build_emu_slice: every
template as a `seed_template<j>` record under its species, then graded decoys
drawn from the templates: intra-species operon variants (0.3% substitutions, 0-1
indels; 15% of the rest), sibling species of the genus (2-8%, 0-3 indels;
35%), same-family relatives (10-20%, 2-7 indels; 30%) and background
(shuffled, +-8% length, 25% substitutions).  One departure: the species of
the templates come from how the sample made them (template j and its
variant j + n_random are one species) where build_emu_slice aligns every
pair on the device and joins those at >= 99% identity; the two agree on
these templates (4-6 SNPs against about 75% identity between random ones).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.refio import Records, read_fasta, read_table
from benchmark.sample import BASES, Sample

TAXONOMY_HEADER = ("tax_id\tspecies\tgenus\tfamily\torder\tclass\tphylum\tclade\t"
                   "superkingdom\tsubspecies\tspecies subgroup\tspecies group\n")


def _mutate(rng, codes: np.ndarray, sub_rate: float, n_indels: int = 0) -> np.ndarray:
    out = codes.copy()
    n_sub = int(round(sub_rate * len(out)))
    if n_sub:
        pos = rng.choice(len(out), min(n_sub, len(out)), replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, len(pos)).astype(np.uint8)) % 4
    for _ in range(n_indels):
        ln = int(rng.integers(1, 31))
        at = int(rng.integers(0, max(len(out) - ln, 1)))
        if rng.random() < 0.5 and len(out) > ln + 50:
            out = np.concatenate([out[:at], out[at + ln:]])
        else:
            ins = rng.integers(0, 4, ln).astype(np.uint8)
            out = np.concatenate([out[:at], ins, out[at:]])
    return out


def build(sample: Sample, n_refs: int, rng, out_dir: Path) -> Path:
    """Write out_dir/emu (species_taxid.fasta, taxonomy.tsv, .savont_db) and
    return that directory."""
    seed_codes = [np.searchsorted(BASES, np.frombuffer(t, np.uint8)).astype(np.uint8)
                  for t in sample.templates]
    groups = [j % sample.n_random for j in range(len(seed_codes))]
    records: list[tuple[str, str, bytes]] = []
    tax_rows: dict[str, tuple] = {}

    def add_taxon(species, genus, family, order="Bacillales", cls="Bacilli",
                  phylum="Bacillota", kingdom="Bacteria"):
        tid = str(1000 + len(tax_rows))
        tax_rows[tid] = (species, genus, family, order, cls, phylum, "", kingdom, "", "", "")
        return tid

    species_tax = [add_taxon(f"Zymoseed species {g}", f"Zymogenus_{g % 8}", f"Zymofam_{g % 4}")
                   for g in range(max(groups) + 1)]
    for j, c in enumerate(seed_codes):
        records.append((species_tax[groups[j]], f"seed_template{j}", BASES[c].tobytes()))
    budget = n_refs - len(records)
    n_near, n_sib, n_fam = int(budget * 0.15), int(budget * 0.35), int(budget * 0.30)
    for i in range(n_near):
        g = int(rng.integers(0, len(seed_codes)))
        v = _mutate(rng, seed_codes[g], 0.003, n_indels=int(rng.integers(0, 2)))
        records.append((species_tax[groups[g]], f"operon_{i}", BASES[v].tobytes()))
    for i in range(n_sib):
        g = int(rng.integers(0, len(seed_codes)))
        gg = groups[g]
        tid = add_taxon(f"Sibling sp. {i}", f"Zymogenus_{gg % 8}", f"Zymofam_{gg % 4}")
        v = _mutate(rng, seed_codes[g], float(rng.uniform(0.02, 0.08)), n_indels=int(rng.integers(0, 4)))
        records.append((tid, f"sib_{i}", BASES[v].tobytes()))
    for i in range(n_fam):
        g = int(rng.integers(0, len(seed_codes)))
        gg = groups[g]
        tid = add_taxon(f"Relative sp. {i}", f"Relgenus_{i % 64}", f"Zymofam_{gg % 4}")
        v = _mutate(rng, seed_codes[g], float(rng.uniform(0.10, 0.20)), n_indels=int(rng.integers(2, 8)))
        records.append((tid, f"rel_{i}", BASES[v].tobytes()))
    for i in range(n_refs - len(records)):
        base = seed_codes[int(rng.integers(0, len(seed_codes)))]
        L = int(len(base) * rng.uniform(0.92, 1.08))
        v = _mutate(rng, rng.permutation(base)[: max(L, 600)].copy(), 0.25)
        tid = add_taxon(f"Background sp. {i}", f"Bggenus_{i % 128}", f"Bgfam_{i % 32}",
                        order="Other", cls="Other", phylum=f"Phylum_{i % 12}")
        records.append((tid, f"bg_{i}", BASES[v].tobytes()))

    out = out_dir / "emu"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "species_taxid.fasta", "wb") as f:
        f.write(b"".join(b">%s:%s\n%s\n" % (tid.encode(), rid.encode(), seq)
                         for tid, rid, seq in records))
    with open(out / "taxonomy.tsv", "w") as f:
        f.write(TAXONOMY_HEADER)
        for tid, row in tax_rows.items():
            f.write(tid + "\t" + "\t".join(row) + "\n")
    (out / ".savont_db").write_text("emu-1")
    return out


def read(db_dir: Path) -> Records:
    """The directory read plainly: a record's key is its header up to the
    first ':', its species and genus that tax_id's row of taxonomy.tsv; a
    record whose key has no row is skipped."""
    rank = {r["tax_id"]: r for r in read_table(db_dir / "taxonomy.tsv")}
    kept = [(rank[h.split(":", 1)[0]], s) for h, s in read_fasta(db_dir / "species_taxid.fasta")
            if h.split(":", 1)[0] in rank]
    return Records([s for _, s in kept], [r["species"] for r, _ in kept], [r["genus"] for r, _ in kept])
