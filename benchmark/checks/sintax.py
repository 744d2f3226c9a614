"""The check of one `sintax` call's outputs.

The reference is classify's (checks/taxa.py) at the genus rank.  Numbers:
- asv_genus_wrong: ASVs whose row in asv_mappings.tsv gives another genus
  than the reference, or none (exact: limit 0);
- genus_abundance_gap: the widest gap between genus_abundance.tsv and the
  reference's shares.
"""
from __future__ import annotations

from pathlib import Path

from ..refio import abundance_gap, read_table
from . import taxa

# each number's limit: see PERF.md, section 2, for the readings they were set from
LIMITS = {"asv_genus_wrong": 0.0, "genus_abundance_gap": 0.01}


def judge(out: Path, setup) -> dict[str, float]:
    ref = taxa.reference(setup)
    files = [out / "asv_mappings.tsv", out / "genus_abundance.tsv"]
    if not all(f.exists() for f in files):
        return {"asv_genus_wrong": float(len(ref.asvs)), "genus_abundance_gap": 1.0}
    return {
        "asv_genus_wrong": float(taxa.wrong_rows(read_table(files[0]), ref, "genus")),
        "genus_abundance_gap": abundance_gap(taxa.abundances(read_table(files[1]), "genus"),
                                             ref.shares("genus")),
    }


def control(setup, out: Path) -> None:
    """The reference's answer with the genus rank not resolved (every ASV
    left unclassified at the genus, as bootstrap support under the
    threshold would give), written in the program's formats."""
    ref = taxa.reference(setup)
    taxa.write(out, ref, "genus", {h: "UNCLASSIFIED" for h in ref.asvs})
