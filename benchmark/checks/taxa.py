"""The plain reference of classify and sintax (not a check of its own: no
traffic names it).  Each input ASV takes the taxa of the database records
that hold it with no edit (refio.Records.holding over the records that the
database format's plain reader, databases/<format>.py read(), gives: the
sample's templates are records of the database); a taxon's abundance is its
ASVs' share of the input depth."""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path

from ..refio import Records, feature_depths, read_fasta


class Reference:
    def __init__(self, asv_dir: Path, db: Records):
        depths = feature_depths(asv_dir / "feature-table.tsv")
        self.asvs: dict[str, float] = {}
        self.species: dict[str, str] = {}
        self.genus: dict[str, str] = {}
        self.species_ok: dict[str, set] = {}
        self.genus_ok: dict[str, set] = {}
        for head, seq in read_fasta(asv_dir / "final_asvs.fasta"):
            h = head.split()[0]
            self.asvs[h] = depths.get(h, 0.0)
            self.species_ok[h] = db.taxa_holding(seq, "species")
            self.genus_ok[h] = db.taxa_holding(seq, "genus")
            self.species[h] = min(self.species_ok[h], default="UNCLASSIFIED")
            self.genus[h] = min(self.genus_ok[h], default="UNCLASSIFIED")

    def shares(self, rank: str) -> dict[str, float]:
        of = self.species if rank == "species" else self.genus
        total = sum(self.asvs.values()) or 1.0
        out: dict[str, float] = defaultdict(float)
        for h, d in self.asvs.items():
            out[of[h]] += d / total
        return dict(out)


def reference(setup) -> Reference:
    """The setup's reference, worked out once a run."""
    if getattr(setup, "taxa_reference", None) is None:
        setup.taxa_reference = Reference(setup.asv_dir, setup.db_format.read(setup.db_dir))
    return setup.taxa_reference


def wrong_rows(rows: list[dict], ref: Reference, *ranks: str) -> int:
    """ASVs with a row naming, at one of `ranks`, a taxon outside the
    reference's, or with no row."""
    ok = {"species": ref.species_ok, "genus": ref.genus_ok}
    seen: dict[str, bool] = {}
    for r in rows:
        h = r.get("asv_header", "")
        if h in ref.asvs:
            seen[h] = seen.get(h, True) and all(r.get(k) in ok[k][h] for k in ranks)
    return sum(1 for h in ref.asvs if not seen.get(h, False))


def abundances(rows: list[dict], rank: str) -> dict[str, float]:
    out: dict[str, float] = defaultdict(float)
    for r in rows:
        out[r.get(rank, "")] += float(r.get("abundance", 0.0))
    return dict(out)


def write(out: Path, ref: Reference, rank: str, called: dict[str, str], with_genus: bool = False) -> None:
    """asv_mappings.tsv and the abundance table(s) of an answer that calls
    ASV h `called[h]` at `rank` (the other rank as the reference has it)."""
    out.mkdir(parents=True, exist_ok=True)
    total = sum(ref.asvs.values()) or 1.0
    sp = called if rank == "species" else ref.species
    ge = called if rank == "genus" else ref.genus
    with open(out / "asv_mappings.tsv", "w") as f:
        f.write("asv_header\tdepth\tspecies\tgenus\n")
        f.writelines(f"{h}\t{d}\t{sp[h]}\t{ge[h]}\n" for h, d in ref.asvs.items())
    tables = [("species", sp), ("genus", ge)] if with_genus or rank == "species" else [("genus", ge)]
    for name, of in tables:
        share: dict[str, float] = defaultdict(float)
        for h, d in ref.asvs.items():
            share[of[h]] += d / total
        with open(out / f"{name}_abundance.tsv", "w") as f:
            f.write(f"abundance\t{name}\n")
            f.writelines(f"{v}\t{k}\n" for k, v in share.items())
