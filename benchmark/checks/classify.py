"""The check of one `classify` call's outputs.

The reference: each input ASV takes the species and genus of the database
records that equal it (either strand; the sample's templates are records of
the database), and a taxon's abundance is its ASVs' share of the input
depth (the feature table both sides read).  Numbers:
- asv_taxon_wrong: ASVs whose row in asv_mappings.tsv gives another
  species or another genus than the reference, or none (exact: limit 0);
- abundance_gap: the widest gap between species_abundance.tsv and
  genus_abundance.tsv and the reference's shares of each rank.
"""
from __future__ import annotations

from pathlib import Path

from ..refio import abundance_gap, read_table
from . import taxa

# each number's limit: see PERF.md, section 2, for the readings they were set from
LIMITS = {"asv_taxon_wrong": 0.0, "abundance_gap": 0.01}


def judge(out: Path, setup) -> dict[str, float]:
    files = [out / "asv_mappings.tsv", out / "species_abundance.tsv", out / "genus_abundance.tsv"]
    n = len(taxa.reference(setup).asvs)
    if not all(f.exists() for f in files):
        return {"asv_taxon_wrong": float(n), "abundance_gap": 1.0}
    ref = taxa.reference(setup)
    rows = read_table(files[0])
    return {
        "asv_taxon_wrong": float(taxa.wrong_rows(rows, ref, "species", "genus")),
        "abundance_gap": max(
            abundance_gap(taxa.abundances(read_table(files[1]), "species"), ref.shares("species")),
            abundance_gap(taxa.abundances(read_table(files[2]), "genus"), ref.shares("genus"))),
    }


def control(setup, out: Path) -> None:
    """The reference's answer with the species rank not resolved (each ASV
    called at its genus, as a classification that stops at the genus
    threshold would give), written in the program's formats."""
    ref = taxa.reference(setup)
    called = {h: f"{ref.genus[h]} sp." for h in ref.asvs}
    taxa.write(out, ref, "species", called, with_genus=True)
