"""Database registry + downloads (databases.rs, download.rs)."""
from __future__ import annotations

import logging
import subprocess
from dataclasses import dataclass
from pathlib import Path

from . import taxonomy

log = logging.getLogger("savont")

MARKER_FILE = ".savont_db"
# GTDB r232 disabled in the reference registry too (databases.rs:8)
KEYWORDS = ["emu-1", "silva-138.2", "greengenes2-2024.09"]


@dataclass
class DatabaseDef:
    keyword: str
    description: str
    download: "callable"
    load: "callable"
    extract_key: "callable"


def _run(cmd: list[str]) -> None:
    r = subprocess.run(cmd)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd[0]} returned non-zero for {' '.join(cmd)}")


def download_emu(dest: Path) -> None:
    """databases.rs:110-145 — OSF tarball, flattened into dest."""
    tar = dest / "emu_default.tar.gz"
    _run(["wget", "--content-disposition", "https://osf.io/8qcwd/download", "-O", str(tar)])
    _run(["tar", "-xzf", str(tar), "-C", str(dest)])
    tar.unlink(missing_ok=True)
    sub = dest / "emu_default"
    if sub.is_dir():
        for p in sub.iterdir():
            p.rename(dest / p.name)
        sub.rmdir()


def download_silva(dest: Path) -> None:
    """databases.rs:147-168."""
    base = "https://www.arb-silva.de/fileadmin/silva_databases/current/Exports"
    _run(["wget", f"{base}/SILVA_138.2_SSURef_NR99_tax_silva_trunc.fasta.gz", "-P", str(dest)])
    _run(["wget", f"{base}/taxonomy/taxmap_slv_ssu_ref_nr_138.2.txt.gz", "-P", str(dest)])
    _run(["gzip", "-d", str(dest / "taxmap_slv_ssu_ref_nr_138.2.txt.gz")])


def download_gg2(dest: Path) -> None:
    """databases.rs:181-190."""
    _run(["wget", "https://zenodo.org/records/14169078/files/gg2_2024_09_toSpecies_trainset.fa.gz", "-P", str(dest)])


ALL = [
    DatabaseDef("emu-1", "EMU default 16S rRNA database", download_emu, taxonomy.load_emu, taxonomy.extract_tax_id_from_header),
    DatabaseDef("silva-138.2", "SILVA SSU Ref NR99 v138.2", download_silva, taxonomy.load_silva, taxonomy.extract_silva_accession_from_header),
    DatabaseDef("greengenes2-2024.09", "GreenGenes2 2024.09 species-level trainset from DADA2", download_gg2, taxonomy.load_gg2, taxonomy.extract_gg2_key_from_header),
]


def find(keyword: str) -> DatabaseDef | None:
    for d in ALL:
        if d.keyword == keyword:
            return d
    return None


def write_marker(d: Path, keyword: str) -> None:
    (d / MARKER_FILE).write_text(keyword)


def read_marker(d: Path) -> str | None:
    p = d / MARKER_FILE
    return p.read_text().strip() if p.exists() else None


def load_database(d: Path) -> taxonomy.Database:
    """Marker file -> directory basename -> registry (databases.rs:83-106)."""
    keyword = read_marker(d) or d.name
    dd = find(keyword)
    if dd is None:
        raise SystemExit(
            f"Unknown database keyword '{keyword}'. Available: {', '.join(KEYWORDS)}"
        )
    log.info("Detected database type '%s' for %s", keyword, d)
    return dd.load(d)


def download(location: str, dbs: list[str]) -> None:
    """download.rs:5-31."""
    for kw in dbs:
        dd = find(kw)
        if dd is None:
            raise SystemExit(f"Unknown database '{kw}'. Available: {', '.join(KEYWORDS)}")
        dest = Path(location) / kw
        dest.mkdir(parents=True, exist_ok=True)
        log.info("Downloading '%s' (%s) to %s ...", kw, dd.description, dest)
        dd.download(dest)
        write_marker(dest, kw)
        log.info("'%s' downloaded. Use with: python -m savont_tpu_torch classify -d %s", kw, dest)
