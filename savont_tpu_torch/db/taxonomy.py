"""Taxonomy database model, loaders, and abundance writers.

Reference: taxonomy.rs.  Four DB formats: EMU (species_taxid.fasta +
12-column taxonomy.tsv), SILVA (taxmap TSV), GTDB (taxonomy in FASTA
headers), GreenGenes2 (header IS the lineage).  Yarza-style identity
thresholds assign the classification rank.
"""
from __future__ import annotations

import gzip
import logging
from collections.abc import Mapping
from dataclasses import dataclass, field
from pathlib import Path

log = logging.getLogger("savont")

RANKS = [
    "species", "genus", "family", "order", "class", "phylum",
    "clade", "superkingdom", "subspecies", "species_subgroup", "species_group",
]


@dataclass
class TaxonomyEntry:
    """taxonomy.rs:8-22."""

    tax_id: str = ""
    species: str = ""
    genus: str = ""
    family: str = ""
    order: str = ""
    class_: str = ""
    phylum: str = ""
    clade: str = ""
    superkingdom: str = ""
    subspecies: str = ""
    species_subgroup: str = ""
    species_group: str = ""


@dataclass
class Database:
    """taxonomy.rs:25-30."""

    fasta_path: Path
    taxonomy: dict[str, TaxonomyEntry]
    extract_key: "callable"


def _open_text(path: Path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


# ── header key extractors (taxonomy.rs:577-607) ──────────────────────────────


def extract_tax_id_from_header(header: str) -> str | None:
    """EMU: >2420510:emu_db:1 -> 2420510."""
    header = header.lstrip(">")
    return header.split(":")[0] if header else None


def extract_silva_accession_from_header(header: str) -> str | None:
    """SILVA: >AY846372.1.1779 ... -> AY846372.  Only the first token is
    split off: the rest of a SILVA header is the whole taxonomy path."""
    tok = header.lstrip(">").split(None, 1)
    if not tok:
        return None
    return tok[0].partition(".")[0]


def extract_gtdb_key_from_header(header: str) -> str | None:
    """GTDB: first whitespace token."""
    header = header.lstrip(">")
    tok = header.split()
    return tok[0] if tok else None


def extract_gg2_key_from_header(header: str) -> str | None:
    """GreenGenes2: the full trimmed header is the key."""
    header = header.lstrip(">").strip()
    return header or None


# ── loaders ──────────────────────────────────────────────────────────────────


def load_emu(db_dir: Path) -> Database:
    """taxonomy.rs:34-102."""
    fasta = db_dir / "species_taxid.fasta"
    tsv = db_dir / "taxonomy.tsv"
    if not fasta.exists():
        raise FileNotFoundError(f"FASTA file not found: {fasta}")
    if not tsv.exists():
        raise FileNotFoundError(f"Taxonomy file not found: {tsv}")
    taxonomy: dict[str, TaxonomyEntry] = {}
    with _open_text(tsv) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 12:
                log.warning("skipping malformed EMU taxonomy line %d", i + 1)
                continue
            e = TaxonomyEntry(
                tax_id=fields[0], species=fields[1], genus=fields[2], family=fields[3],
                order=fields[4], class_=fields[5], phylum=fields[6], clade=fields[7],
                superkingdom=fields[8], subspecies=fields[9],
                species_subgroup=fields[10], species_group=fields[11],
            )
            taxonomy[e.tax_id] = e
    return Database(fasta, taxonomy, extract_tax_id_from_header)


def load_silva(db_dir: Path) -> Database:
    """taxonomy.rs:105-205."""
    fasta = None
    taxmap = None
    for p in sorted(db_dir.iterdir()):
        n = p.name
        if n.endswith((".fasta", ".fasta.gz", ".fa.gz")) and fasta is None:
            fasta = p
        if n.startswith("taxmap_") and (n.endswith(".txt") or n.endswith(".txt.gz")):
            taxmap = p
    if fasta is None:
        raise FileNotFoundError(f"No FASTA file found in {db_dir}")
    if taxmap is None:
        raise FileNotFoundError(f"No taxmap file found in {db_dir}")
    with _open_text(taxmap) as f:
        return Database(fasta, SilvaTaxmap(f.read()), extract_silva_accession_from_header)


def _silva_entry(fields: list[str]) -> TaxonomyEntry:
    """A TAXMAP line's fields (accession, start, stop, path, organism,
    taxid) as the entry taxonomy.rs builds: the path's levels from the
    domain down, "UNKNOWN" past its end."""
    levels = [x.strip() for x in fields[3].split(";")]

    def lv(j):
        return levels[j] if j < len(levels) else "UNKNOWN"

    return TaxonomyEntry(
        tax_id=fields[5], species=fields[4], genus=lv(5), family=lv(4),
        order=lv(3), class_=lv(2), phylum=lv(1), superkingdom=lv(0),
    )


class SilvaTaxmap(Mapping):
    """SILVA's TAXMAP as a mapping from accession to TaxonomyEntry
    (taxonomy.rs:105-205): after the header line, every line of six fields
    or more, the last line of an accession winning.  An entry is built from
    its line the first time it is asked for: a call classifies with the
    entries of the references that win a pair, a few hundred of SILVA's
    510,000 lines, and asks of the rest only whether they are there."""

    def __init__(self, text: str):
        self._lines = text.split("\n")
        self._index = {line.partition("\t")[0]: i for i, line in enumerate(self._lines)
                       if i > 0 and line.count("\t") >= 5}
        self._entries: dict[str, TaxonomyEntry] = {}

    def __getitem__(self, key: str) -> TaxonomyEntry:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _silva_entry(self._lines[self._index[key]].split("\t"))
        return e

    def __contains__(self, key) -> bool:
        return key in self._index

    def __iter__(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)


def _parse_prefixed_lineage(tax_str: str) -> dict[str, str]:
    out: dict[str, str] = {}
    prefix_map = {"d__": "superkingdom", "p__": "phylum", "c__": "class_", "o__": "order",
                  "f__": "family", "g__": "genus", "s__": "species"}
    for level in tax_str.split(";"):
        level = level.strip()
        for pref, name in prefix_map.items():
            if level.startswith(pref):
                out[name] = level[len(pref):]
    return out


def load_gtdb(db_dir: Path) -> Database:
    """taxonomy.rs:208-306 — taxonomy parsed from .fna(.gz) headers."""
    fasta = None
    for p in sorted(db_dir.iterdir()):
        if p.name.endswith((".fna.gz", ".fna", ".fa.gz", ".fasta.gz", ".fa", ".fasta")):
            fasta = p
            break
    if fasta is None:
        raise FileNotFoundError(f"No FASTA file found in {db_dir}")
    taxonomy: dict[str, TaxonomyEntry] = {}
    with _open_text(fasta) as f:
        for line in f:
            if not line.startswith(">"):
                continue
            header = line[1:].rstrip("\n")
            parts = header.split(" ", 1)
            ref = parts[0]
            if not ref:
                continue
            rest = parts[1] if len(parts) > 1 else ""
            idx = rest.find(" [")
            tax_str = rest[:idx] if idx >= 0 else rest.strip()
            fields = _parse_prefixed_lineage(tax_str)
            taxonomy[ref] = TaxonomyEntry(tax_id=ref, **{k: v for k, v in fields.items()})
    return Database(fasta, taxonomy, extract_gtdb_key_from_header)


def load_gg2(db_dir: Path) -> Database:
    """taxonomy.rs:310-409 — header IS the lineage; empty ranks filled with
    Greengenes_unannotated."""
    fasta = None
    for p in sorted(db_dir.iterdir()):
        if p.name.endswith((".fa.gz", ".fasta.gz", ".fa")):
            fasta = p
            break
    if fasta is None:
        raise FileNotFoundError(f"No .fa.gz file found in {db_dir}")
    UNANN = "Greengenes_unannotated"
    taxonomy: dict[str, TaxonomyEntry] = {}
    with _open_text(fasta) as f:
        for line in f:
            if not line.startswith(">"):
                continue
            key = line[1:].strip()
            if not key:
                continue
            fields = _parse_prefixed_lineage(key)
            genus = fields.get("genus", "")
            epithet = fields.get("species", "")
            species = f"{genus} {epithet}" if genus and epithet else epithet
            fill = lambda s: s if s else UNANN
            taxonomy[key] = TaxonomyEntry(
                tax_id=key,
                species=fill(species),
                genus=fill(genus),
                family=fill(fields.get("family", "")),
                order=fill(fields.get("order", "")),
                class_=fill(fields.get("class_", "")),
                phylum=fill(fields.get("phylum", "")),
                superkingdom=fill(fields.get("superkingdom", "")),
            )
    return Database(fasta, taxonomy, extract_gg2_key_from_header)


# ── rank assignment (taxonomy.rs:442-573, Yarza thresholds) ──────────────────


@dataclass
class TaxonomyAssignment:
    tax_id: str = ""
    species: str = ""
    genus: str = ""
    family: str = ""
    order: str = ""
    class_: str = ""
    phylum: str = ""
    clade: str = ""
    superkingdom: str = ""
    subspecies: str = ""
    species_subgroup: str = ""
    species_group: str = ""


def assign_taxonomy(
    entry: TaxonomyEntry,
    identity: float,
    species_threshold: float,
    genus_threshold: float,
    asv_header: str,
    detailed_unclassified: bool,
) -> TaxonomyAssignment:
    unc = f"UNCLASSIFIED-({asv_header})" if detailed_unclassified else "UNCLASSIFIED"
    # ranks preserved above the identity-determined level, UNCLASSIFIED below
    levels = [
        ("species", species_threshold),
        ("genus", genus_threshold),
        ("family", 86.5),
        ("order", 82.0),
        ("class_", 78.5),
        ("phylum", 75.0),
    ]
    a = TaxonomyAssignment(tax_id=entry.tax_id, clade=entry.clade, superkingdom=entry.superkingdom)
    cutoff_reached = False
    kept_any = False
    for rank, thresh in levels:
        if identity >= thresh and not cutoff_reached:
            setattr(a, rank, getattr(entry, rank))
            kept_any = True
            # once a rank is kept, all higher ranks are kept too
            for higher, _ in levels[levels.index((rank, thresh)) + 1 :]:
                setattr(a, higher, getattr(entry, higher))
            break
        setattr(a, rank, unc)
    if not kept_any:
        # fully unclassified below phylum threshold (taxonomy.rs:555-571)
        a.clade = unc
        a.superkingdom = unc
    if identity >= species_threshold:
        a.subspecies = entry.subspecies
        a.species_subgroup = entry.species_subgroup
        a.species_group = entry.species_group
    return a


# ── classification record + writers (taxonomy.rs:412-787) ────────────────────


@dataclass
class AsvClassification:
    asv_id: str
    asv_header: str
    hit_reference_id: str = ""
    abundance: float = 0.0
    best_hit_tax_id: str | None = None
    identity: float | None = None
    nm: int | None = None
    taxonomy: TaxonomyAssignment | None = None


def extract_depth_string(header: str) -> str:
    first = header.split()[0] if header.split() else header
    return first.split("_")[-1] if "_" in first else "1"


def parse_depth_token(token: str) -> int:
    vals = []
    for s in token.split("-"):
        try:
            vals.append(int(s))
        except ValueError:
            pass
    return max(sum(vals), 1)


def extract_depths_from_headers(headers: list[str]) -> list[int]:
    return [parse_depth_token(extract_depth_string(h.lstrip(">"))) for h in headers]


def write_species_abundance(classifications: list[AsvClassification], path) -> None:
    agg: dict[str, tuple[TaxonomyAssignment, float]] = {}
    for c in classifications:
        if c.taxonomy is None:
            continue
        t = c.taxonomy
        key = "|".join([t.species, t.genus, t.family, t.order, t.class_, t.phylum, t.clade, t.superkingdom])
        if key in agg:
            agg[key] = (agg[key][0], agg[key][1] + c.abundance)
        else:
            agg[key] = (t, c.abundance)
    rows = sorted(agg.values(), key=lambda x: -x[1])
    with open(path, "w") as f:
        f.write("abundance\tspecies\tgenus\tfamily\torder\tclass\tphylum\tclade\tsuperkingdom\n")
        for t, a in rows:
            f.write(f"{a}\t{t.species}\t{t.genus}\t{t.family}\t{t.order}\t{t.class_}\t{t.phylum}\t{t.clade}\t{t.superkingdom}\n")


def write_genus_abundance(classifications: list[AsvClassification], path) -> None:
    agg: dict[str, tuple[TaxonomyAssignment, float]] = {}
    for c in classifications:
        if c.taxonomy is None:
            continue
        t = c.taxonomy
        key = "|".join([t.genus, t.family, t.order, t.class_, t.phylum, t.clade, t.superkingdom])
        if key in agg:
            agg[key] = (agg[key][0], agg[key][1] + c.abundance)
        else:
            agg[key] = (t, c.abundance)
    rows = sorted(agg.values(), key=lambda x: -x[1])
    with open(path, "w") as f:
        f.write("abundance\tgenus\tfamily\torder\tclass\tphylum\tclade\tsuperkingdom\n")
        for t, a in rows:
            f.write(f"{a}\t{t.genus}\t{t.family}\t{t.order}\t{t.class_}\t{t.phylum}\t{t.clade}\t{t.superkingdom}\n")


def write_asv_mappings(classifications: list[AsvClassification], path) -> None:
    with open(path, "w") as f:
        f.write(
            "asv_header\tdepth\talignment_identity\tnumber_mismatches\ttax_id\tspecies\tgenus\t"
            "family\torder\tclass\tphylum\tclade\tsuperkingdom\treference\n"
        )
        for c in classifications:
            depth = extract_depth_string(c.asv_header)
            if c.taxonomy is not None and c.identity is not None:
                t = c.taxonomy
                f.write(
                    f"{c.asv_header}\t{depth}\t{c.identity:.2f}\t{c.nm or 0}\t"
                    f"{c.best_hit_tax_id or 'NA'}\t{t.species}\t{t.genus}\t{t.family}\t{t.order}\t"
                    f"{t.class_}\t{t.phylum}\t{t.clade}\t{t.superkingdom}\t{c.hit_reference_id}\n"
                )
            else:
                unc = "\t".join(["UNCLASSIFIED"] * 9)
                f.write(f"{c.asv_header}\t{depth}\tNA\tNA\tNA\t{unc}\n")
