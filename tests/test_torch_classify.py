"""The port's classify against the JAX package's host classify, on the CPU.

The same seed-drawn database and ASVs (numpy) go through
savont_tpu.pipeline.classify (its host route: align_pairs_nm with real
starts) and savont_tpu_torch.pipeline.classify with --device cpu (the
classify route on the kernels' plain versions).  Tolerance 0: the bytes of
every output file.  Also the classify route pair by pair against the JAX
package's align_pairs_nm_indexed(coords=True), batched against per-ASV
calls, the taxonomy loaders of both packages, the minimizer-table cache
read across packages, and download with its fetches mocked."""
import dataclasses
import gzip
from pathlib import Path

import numpy as np
import pytest

import savont_tpu.ops.align as jax_align
from savont_tpu.config import ClassifyArgs as JaxClassifyArgs
from savont_tpu.db import registry as jax_registry
from savont_tpu.db import taxonomy as jax_tax
from savont_tpu.ops.align_batch import align_pairs_nm_indexed as jax_nm_indexed
from savont_tpu.pipeline import classify as jax_classify
from savont_tpu_torch.config import ClassifyArgs
from savont_tpu_torch.db import registry, taxonomy
from savont_tpu_torch.ops import align as port_align
from savont_tpu_torch.ops import align_batch
from savont_tpu_torch.ops.align_torch import REFERENCE_CALLS, reset_counters
from savont_tpu_torch.pipeline import classify as port_classify

from _torch_jobs import reference_native  # noqa: F401  (autouse: savont_tpu's native libraries whole)
from _torch_jobs import (
    foreign_ends, graded_refs, rand_seq, read_outputs, substitute, write_asv_dir, write_emu_db,
    write_silva_db,
)

OUTPUTS = ("species_abundance.tsv", "genus_abundance.tsv", "asv_mappings.tsv")


@pytest.fixture
def fresh_band(monkeypatch):
    """Both packages at the band of a fresh process (128), restored after."""
    monkeypatch.setattr(jax_align, "DEFAULT_BAND", 128)
    monkeypatch.setattr(port_align, "DEFAULT_BAND", 128)


def _asvs(refs, seed: int) -> list[bytes]:
    """An exact reference, a degraded one (6%: genus level), four with 3-12
    foreign bases at either end and 1-4% substitutions on both strands (one
    the 1,426-bp ASV with 6 foreign leading bases and 4% substitutions, whose
    identity needs its real query start), a 1,370-bp piece of a reference,
    and an unrelated sequence."""
    rng = np.random.default_rng(seed)
    return [
        refs[0][4],
        bytes(substitute(rng, refs[13][4], 0.06)),
        foreign_ends(rng, refs[21][4], 6, 0, 0.04, False)[:1426],
        foreign_ends(rng, refs[32][4], 9, 12, 0.02, True),
        foreign_ends(rng, refs[44][4], 0, 7, 0.01, True),
        foreign_ends(rng, refs[55][4], 3, 5, 0.03, False),
        refs[67][4][40:1410],
        rand_seq(rng, 1450),
    ]


def _run_both(tmp_path, db_dir, in_dir, **kw):
    jax_classify.classify(
        JaxClassifyArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "jax"), db=str(db_dir), **kw),
        jax_registry.load_database(db_dir))
    reset_counters()
    port_classify.classify(
        ClassifyArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "port"), db=str(db_dir),
                     device="cpu", **kw),
        registry.load_database(db_dir))
    assert REFERENCE_CALLS["sw_forward_nm"] >= 1
    return read_outputs(tmp_path / "jax", OUTPUTS), read_outputs(tmp_path / "port", OUTPUTS)


@pytest.mark.parametrize("case", ["single", "pooled", "detailed", "silva"])
def test_classify_equals_jax_host(tmp_path, fresh_band, case):
    """The exact, degraded, foreign-ended (both strands), cut and unrelated
    ASVs: one sample, two pooled samples (the wide writers),
    --detailed-unclassified, and one sample against the same references in
    the silva-138.2 format (write_silva_db: RNA in 60-base lines under gzip,
    an accession of two records, IUPAC bytes, a record TAXMAP lacks)."""
    refs = graded_refs(seed=71)
    (write_silva_db if case == "silva" else write_emu_db)(tmp_path / "db", refs)
    seqs = _asvs(refs, seed=72)
    samples = depths = None
    if case == "pooled":
        samples = ["sampleA", "sampleB"]
        depths = [[7 * i + 3, 50 - 5 * i] for i in range(len(seqs))]
    in_dir = write_asv_dir(tmp_path / "run", seqs, samples, depths)
    kw = {"detailed_unclassified": True} if case == "detailed" else {}
    want, got = _run_both(tmp_path, tmp_path / "db", in_dir, **kw)
    assert got == want
    rows = want["asv_mappings.tsv"].decode().splitlines()[1:]
    if case in ("single", "silva"):
        by_asv = {r.split("\t")[0]: r.split("\t") for r in rows}
        assert by_asv["final_consensus_0_depth_10"][2] == "100.00"
        assert by_asv["final_consensus_1_depth_20"][5] == "UNCLASSIFIED"
        assert by_asv["final_consensus_1_depth_20"][6] == "Genus1"
    if case == "detailed":
        assert any("UNCLASSIFIED-(" in r for r in rows)


def test_classify_after_narrowed_band_equals_fresh_jax(tmp_path, fresh_band):
    """An asv run narrows the port's module-wide band to 48; classify in the
    same process still aligns at 128 and equals a fresh JAX run."""
    refs = graded_refs(seed=73)
    write_emu_db(tmp_path / "db", refs)
    in_dir = write_asv_dir(tmp_path / "run", _asvs(refs, seed=74))
    port_align.set_default_band(48)
    want, got = _run_both(tmp_path, tmp_path / "db", in_dir)
    assert got == want


def test_classify_keeps_all_60_min_nm_ties(tmp_path, fresh_band):
    """60 references one substitution away from the ASV all tie at the
    least NM and all stand in asv_mappings.tsv, as in the JAX package."""
    rng = np.random.default_rng(75)
    template = rand_seq(rng, 1500)
    refs = []
    for i, p in enumerate(rng.choice(np.arange(100, 1400), 60, replace=False)):
        s = bytearray(template)
        s[p] = {65: 67, 67: 71, 71: 84, 84: 65}[s[p]]
        refs.append((str(200 + i), f"Species {i}", f"Genus{i}", "Fam", bytes(s)))
    refs += [(str(900 + j), f"Decoy {j}", "Decoy", "Fam", rand_seq(rng, 1500)) for j in range(2)]
    write_emu_db(tmp_path / "db", refs)
    in_dir = write_asv_dir(tmp_path / "run", [template], depths=[[100]])
    want, got = _run_both(tmp_path, tmp_path / "db", in_dir)
    assert got == want
    assert len(want["asv_mappings.tsv"].decode().splitlines()) == 61


def test_classify_route_equals_jax_pair_by_pair(fresh_band):
    """Every (ASV, candidate) pair of the graded database: the route with
    every pair its own group (so every aligned pair gets its starts) equals
    the JAX host route in every field, strand and target start included."""
    refs = graded_refs(seed=76, n_bases=4)
    seqs = _asvs(graded_refs(seed=76, n_bases=7), seed=77)
    targets = [r[4] for r in refs]
    qi = np.repeat(np.arange(len(seqs)), len(targets))
    ti = np.tile(np.arange(len(targets)), len(seqs))
    want = jax_nm_indexed(seqs, targets, qi, ti, 128, coords=True)
    got = align_batch.align_pairs_nm_indexed(seqs, targets, qi, ti, 128, device="cpu")
    fields = ("score", "nm", "strand", "query_start", "query_end", "target_start", "target_end")

    def key(m):
        return None if m is None else tuple(getattr(m, f) for f in fields)

    assert [key(m) for m in got] == [key(m) for m in want]
    assert sum(m is not None for m in want) >= 20
    assert any(m is not None and m.strand == -1 and m.query_start > 0 for m in want)


def test_classify_route_batched_equals_per_asv(fresh_band):
    """One call over every ASV's candidates equals one call per ASV, the
    starts of the written hits included; only those hits run kernels 1 + 2."""
    refs = graded_refs(seed=78, n_bases=2)
    seqs = _asvs(graded_refs(seed=78, n_bases=7), seed=79)[:5]
    targets = [r[4] for r in refs]
    qi = np.repeat(np.arange(len(seqs)), len(targets))
    ti = np.tile(np.arange(len(targets)), len(seqs))
    stats = align_batch.CLASSIFY_STATS
    before = dict(stats)
    batched = align_batch.align_pairs_nm_indexed(seqs, targets, qi, ti, 128, device="cpu",
                                                 groups=qi)
    written = stats["start_jobs"] - before["start_jobs"]
    per = []
    for a in range(len(seqs)):
        sel = qi == a
        per += align_batch.align_pairs_nm_indexed(seqs, targets, qi[sel], ti[sel], 128,
                                                  device="cpu", groups=qi[sel])
    assert [None if m is None else dataclasses.astuple(m) for m in batched] == \
        [None if m is None else dataclasses.astuple(m) for m in per]
    assert 0 < written < stats["jobs"] - before["jobs"]


def test_build_emu_slice_equals_jax(tmp_path, fresh_band):
    """The same seed FASTA and seed give the same database files, byte for
    byte, and the same ground truth: seeds within 0.5% of each other join
    one species through the classify route's NM and starts."""
    from savont_tpu.db.synth import build_emu_slice as jax_build
    from savont_tpu_torch.db.synth import build_emu_slice

    rng = np.random.default_rng(84)
    seeds = [rand_seq(rng, int(rng.integers(1300, 1500))) for _ in range(4)]
    seeds += [bytes(substitute(rng, seeds[0], 0.005)), bytes(substitute(rng, seeds[1], 0.004))[20:]]
    fa = tmp_path / "seeds.fa"
    fa.write_text("".join(f">seed{i}\n{q.decode()}\n" for i, q in enumerate(seeds)))
    want = jax_build(fa, tmp_path / "jax", n_refs=300, seed=11)
    got = build_emu_slice(fa, tmp_path / "port", n_refs=300, seed=11, device="cpu")
    for name in ("species_taxid.fasta", "taxonomy.tsv", ".savont_db"):
        assert (got["out"] / name).read_bytes() == (want["out"] / name).read_bytes(), name
    assert {k: v for k, v in got.items() if k != "out"} == {k: v for k, v in want.items() if k != "out"}
    assert got["tax_of_seed"]["seed0"] == got["tax_of_seed"]["seed4"]
    assert got["tax_of_seed"]["seed1"] == got["tax_of_seed"]["seed5"]
    assert len(set(got["tax_of_seed"].values())) == 4


def test_table_cache_read_across_packages(tmp_path):
    """<fasta>.savont_idx.npz: a cache written by either package loads in
    the other with the same arrays as a fresh build."""
    refs = graded_refs(seed=80, n_bases=3)
    seqs = [r[4] for r in refs]
    for writer, reader in ((jax_classify, port_classify), (port_classify, jax_classify)):
        fa = tmp_path / f"{writer.__name__}.fasta"
        fa.write_text("".join(f">{i}\n{s.decode()}\n" for i, s in enumerate(seqs)))
        built = writer._load_or_build_table(fa, seqs)
        assert Path(str(fa) + ".savont_idx.npz").exists()
        loaded = reader._load_or_build_table(fa, [])
        fresh = reader.DbMinimizerTable(seqs)
        for t in (built, loaded):
            assert (t.w, t.k) == (fresh.w, fresh.k)
            assert np.array_equal(t.hashes, fresh.hashes) and np.array_equal(t.ids, fresh.ids)


def _tax_files(tmp_path, fmt: str) -> Path:
    d = tmp_path / fmt
    d.mkdir()
    if fmt == "emu":
        write_emu_db(d, [("101", "Listeria monocytogenes", "Listeria", "Listeriaceae", b"ACGT"),
                         ("102", "E. coli", "Escherichia", "Enterobacteriaceae", b"TTGA")])
        with open(d / "taxonomy.tsv", "a") as f:
            f.write("103\tshort row\n")
    elif fmt == "silva":
        with gzip.open(d / "SILVA_138.2_SSURef_NR99_tax_silva_trunc.fasta.gz", "wt") as f:
            f.write(">AY846372.1.1779 Bacteria;Bacillota\nACGU\n")
        (d / "taxmap_slv_ssu_ref_nr_138.2.txt").write_text(
            "primaryAccession\tstart\tstop\tpath\torganism_name\ttaxid\n"
            "AY846372\t1\t1779\tBacteria;Bacillota;Bacilli;Lactobacillales;Listeriaceae;"
            "Listeria;\tListeria monocytogenes\t42\n"
            "AB000001\t1\t1500\tArchaea;\tsp.\t7\n")
    elif fmt == "gtdb":
        (d / "mock_gtdb.fna").write_text(
            ">RS_GCF_000001405.40~NC_000001.11 d__Bacteria;p__Pseudomonadota;"
            "c__Gammaproteobacteria;o__Enterobacterales;f__Enterobacteriaceae;"
            "g__Escherichia;s__Escherichia coli [location=1..1500]\nACGT\n"
            ">GB_GCA_000007185.1~AE017221.1 d__Archaea;p__Thermoproteota\nTTTT\n")
    else:
        with gzip.open(d / "gg2_2024_09_toSpecies_trainset.fa.gz", "wt") as f:
            f.write(">d__Bacteria;p__Bacillota;c__;o__;f__;g__Listeria;s__monocytogenes;\nACGT\n"
                    ">d__Bacteria;p__Pseudomonadota;c__Gamma;o__;f__;g__;s__;\nTTTT\n")
    return d


@pytest.mark.parametrize("fmt", ["emu", "silva", "gtdb", "gg2"])
def test_taxonomy_loaders_equal_jax(tmp_path, fmt):
    d = _tax_files(tmp_path, fmt)
    load = {"emu": "load_emu", "silva": "load_silva", "gtdb": "load_gtdb", "gg2": "load_gg2"}[fmt]
    want = getattr(jax_tax, load)(d)
    got = getattr(taxonomy, load)(d)
    assert got.fasta_path == want.fasta_path and len(got.taxonomy) >= 2
    assert {k: dataclasses.asdict(v) for k, v in got.taxonomy.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.taxonomy.items()}
    for header in (">101:emu_db:1", ">AY846372.1.1779 x", ">RS_GCF_1~NC_2 d__B", ">d__B;p__F; "):
        assert got.extract_key(header) == want.extract_key(header)


@pytest.mark.parametrize("identity", [100.0, 99.0, 96.0, 94.5, 90.0, 84.0, 80.0, 76.0, 70.0])
def test_assign_taxonomy_equals_jax(identity):
    e = dict(tax_id="1", species="S", genus="G", family="F", order="O", class_="C", phylum="P",
             clade="Cl", superkingdom="K", subspecies="ss", species_subgroup="sg",
             species_group="gr")
    for detailed in (False, True):
        want = jax_tax.assign_taxonomy(jax_tax.TaxonomyEntry(**e), identity, 99.0, 94.5, "h", detailed)
        got = taxonomy.assign_taxonomy(taxonomy.TaxonomyEntry(**e), identity, 99.0, 94.5, "h", detailed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_download_with_mocked_fetch(tmp_path, monkeypatch):
    """Per keyword a directory, the fetch commands of the JAX package's
    registry and the marker file; an unknown keyword aborts.  _run is
    mocked in both packages: nothing reaches the network."""
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_registry, "_run", lambda cmd: calls["jax"].append(cmd))
    monkeypatch.setattr(registry, "_run", lambda cmd: calls["port"].append(cmd))
    kws = ["emu-1", "silva-138.2", "greengenes2-2024.09"]
    jax_registry.download(str(tmp_path / "jax"), kws)
    registry.download(str(tmp_path / "port"), kws)
    norm = {k: [[a.replace(str(tmp_path / k), "DEST") for a in c] for c in v] for k, v in calls.items()}
    assert norm["port"] == norm["jax"] and len(norm["port"]) == 6
    for kw in kws:
        assert registry.read_marker(tmp_path / "port" / kw) == kw
    db = registry.load_database(_tax_files(tmp_path, "emu"))
    assert set(db.taxonomy) == {"101", "102"}
    with pytest.raises(SystemExit, match="Unknown database"):
        registry.download(str(tmp_path), ["not-a-db"])
