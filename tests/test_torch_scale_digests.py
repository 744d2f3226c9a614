"""chip_smoke.py phase "scale" off the card: its sample is pinned, and its
pinned digests are those of the JAX package's host runs at full size.

`python -m savont_tpu asv` on scale_sample's 100,000 reads of 48 templates,
then the JAX package's build_emu_slice of those templates at 100,000
references, `classify` of the ASVs and of write_hard_asvs' ASVs and `sintax`
of the ASVs, each in a fresh process (so classify aligns at band 128, as the
port always does), laid out as the scale phase lays out its directory.  The
port's build_emu_slice writes the same database bytes.

A file of its own, apart from test_torch_chip_smoke.py, so that the
workers that split the suite by file run its two minutes beside the rest."""
import gzip
import hashlib
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

import chip_smoke
from savont_tpu.validate import validate_asvs

ROOT = Path(__file__).resolve().parent.parent
# sha256 of the decompressed fastq and of the templates of scale_sample
SCALE_SAMPLE = ("5f559da6ecda40035a3c1dd123bf5bfe74ed4f7dc6ac50d859a64c81813a805f",
                "816261ae9ee6140ac810cb5b69bf5ed80b18b9150c0f7a2497a8489e0988f0d1")
DB_FILES = ("species_taxid.fasta", "taxonomy.tsv", ".savont_db")


def _host(*argv: str) -> None:
    """One JAX package host run in a fresh process."""
    r = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]


@pytest.fixture(scope="module")
def scale_runs(tmp_path_factory):
    """The scale phase's directory as the JAX package's host runs leave it:
    reads.fq.gz, templates.fa, asv/ (asv, then classify into it), db/emu,
    hard/ (write_hard_asvs, then classify into it) and sintax/."""
    d = tmp_path_factory.mktemp("scale")
    chip_smoke.scale_sample(d / "reads.fq.gz", d / "templates.fa")
    _host("-m", "savont_tpu", "asv", str(d / "reads.fq.gz"), "-o", str(d / "asv"), "-t", "4")
    _host("-c", "import sys; from savont_tpu.db.synth import build_emu_slice; "
                "build_emu_slice(sys.argv[1], sys.argv[2], n_refs=int(sys.argv[3]), "
                "seed=int(sys.argv[4]))",
          str(d / "templates.fa"), str(d / "db"), str(chip_smoke.SCALE_DB_REFS),
          str(chip_smoke.DB_SEED))
    db_dir = d / "db" / "emu"
    chip_smoke.write_hard_asvs(db_dir / "species_taxid.fasta", d / "hard")
    for sub in ("asv", "hard"):
        _host("-m", "savont_tpu", "classify", "-i", str(d / sub), "-d", str(db_dir))
    _host("-m", "savont_tpu", "sintax", "-i", str(d / "asv"), "-o", str(d / "sintax"), "-d",
          str(db_dir))
    return d


def test_scale_sample_is_pinned(scale_runs):
    """100,000 reads of 48 templates of 1,450 bp, in even abundance (2,083
    or 2,084 reads a template), the same bytes as when the digests were
    taken."""
    d = scale_runs
    fq = gzip.decompress((d / "reads.fq.gz").read_bytes())
    tpl = (d / "templates.fa").read_bytes()
    assert (hashlib.sha256(fq).hexdigest(), hashlib.sha256(tpl).hexdigest()) == SCALE_SAMPLE
    lines = fq.split(b"\n")
    per = Counter(h[1:].split(b"_")[0] for h in lines[0::4] if h)
    assert sum(per.values()) == chip_smoke.N_READS_SCALE
    assert len(per) == chip_smoke.N_TEMPLATES_SCALE and set(per.values()) == {2083, 2084}
    seqs = [s for s in tpl.split(b"\n")[1::2]]
    assert len(seqs) == chip_smoke.N_TEMPLATES_SCALE
    assert {len(s) for s in seqs} == {chip_smoke.TEMPLATE_LEN}


def test_scale_digests_equal_host_run(scale_runs):
    """DIGESTS_SCALE are the outputs of the JAX package's host `asv`: 48
    ASVs, each at NM=0 against its template."""
    d = scale_runs
    assert chip_smoke.output_digests(d / "asv") == chip_smoke.DIGESTS_SCALE
    val = validate_asvs(str(d / "asv" / "final_asvs.fasta"), str(d / "templates.fa"))
    assert len(val) == chip_smoke.N_TEMPLATES_SCALE and all(v.nm == 0 for v in val)


def test_scale_classification_digests_equal_host_runs(scale_runs):
    """DIGESTS_SCALE_CLASSIFICATION are the files of the JAX package's host
    build_emu_slice, classify (the scale ASVs and the hard ASVs) and sintax,
    each in a fresh process: every scale ASV and every hard ASV classified."""
    d = scale_runs
    got = {rel: hashlib.sha256((d / rel).read_bytes()).hexdigest()
           for rel in chip_smoke.DIGESTS_SCALE_CLASSIFICATION}
    print(got)
    assert got == chip_smoke.DIGESTS_SCALE_CLASSIFICATION
    for sub, n in (("asv", chip_smoke.N_TEMPLATES_SCALE), ("hard", chip_smoke.N_HARD)):
        rows = (d / sub / "asv_mappings.tsv").read_text().splitlines()[1:]
        assert len(rows) == n and all(r.split("\t")[2] != "NA" for r in rows)


def test_both_packages_build_the_same_scale_database(scale_runs, tmp_path):
    """The port's build_emu_slice (its species grouping on the CPU) writes
    the JAX package's database bytes at 100,000 references."""
    from savont_tpu_torch.db.synth import build_emu_slice

    out = build_emu_slice(scale_runs / "templates.fa", tmp_path / "db",
                          n_refs=chip_smoke.SCALE_DB_REFS, seed=chip_smoke.DB_SEED, device="cpu")
    assert out["n_refs"] == chip_smoke.SCALE_DB_REFS
    for name in DB_FILES:
        assert (tmp_path / "db" / "emu" / name).read_bytes() == \
            (scale_runs / "db" / "emu" / name).read_bytes(), name
