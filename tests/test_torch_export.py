"""The port's export against the JAX package's, on the CPU: the same run
directories (seed-drawn with numpy, some classified by the JAX package's
classify or sintax first) through both, byte for byte in every output."""
import numpy as np
import pytest

import savont_tpu.ops.align as jax_align
from savont_tpu.config import ClassifyArgs, ExportArgs as JaxExportArgs, SintaxArgs
from savont_tpu.db import registry as jax_registry
from savont_tpu.pipeline import classify as jax_classify
from savont_tpu.pipeline import export as jax_export
from savont_tpu.pipeline import sintax as jax_sintax
from savont_tpu_torch.config import ExportArgs
from savont_tpu_torch.pipeline import export as port_export

from _torch_jobs import reference_native  # noqa: F401  (autouse: savont_tpu's native libraries whole)
from _torch_jobs import graded_refs, rand_seq, read_outputs, substitute, write_asv_dir, write_emu_db

OUTPUTS = ("merged_feature_table.tsv", "merged_rep_seqs.fasta", "merged_asv_taxonomy.tsv",
           "merged_taxon_counts.tsv")


def _runs(tmp_path, seed: int, taxonomy: str | None):
    """Two run directories that share ASVs, one a prefix of a shared ASV
    plus 7 bases (fuzzy merge) and one its reverse complement, the first of
    two samples; with `taxonomy`, both classified first by the JAX package's
    classify or sintax."""
    from savont_tpu.ops.encode import revcomp_bytes

    rng = np.random.default_rng(seed)
    refs = graded_refs(seed, n_bases=3)
    shared = bytes(substitute(rng, refs[0][4], 0.01))
    a = write_asv_dir(tmp_path / "r1", [shared, refs[11][4], shared[:1200] + rand_seq(rng, 7)],
                      ["s1", "s2"], [[30, 4], [12, 0], [5, 5]])
    b = write_asv_dir(tmp_path / "r2", [revcomp_bytes(shared), refs[22][4], shared[:1200]],
                      depths=[[40], [9], [3]])
    if taxonomy:
        write_emu_db(tmp_path / "db", refs)
        db = jax_registry.load_database(tmp_path / "db")
        for d in (a, b):
            if taxonomy == "classify":
                jax_classify.classify(ClassifyArgs(input_dir=str(d), db=""), db)
            else:
                jax_sintax.sintax(SintaxArgs(input_dir=str(d), db="", n_iter=20), db)
    return [str(a), str(b)]


@pytest.mark.parametrize("case", ["plain", "no_fuzzy", "relabel", "classify", "sintax"])
def test_export_equals_jax(tmp_path, monkeypatch, case):
    monkeypatch.setattr(jax_align, "DEFAULT_BAND", 128)
    dirs = _runs(tmp_path, 91, case if case in ("classify", "sintax") else None)
    kw = {"no_fuzzy": case == "no_fuzzy",
          "relabel": ["A", "B", "C"] if case == "relabel" else None}
    jax_export.export(JaxExportArgs(input_dirs=dirs, output_dir=str(tmp_path / "jax"), **kw))
    port_export.export(ExportArgs(input_dirs=dirs, output_dir=str(tmp_path / "port"), **kw))
    want = read_outputs(tmp_path / "jax", OUTPUTS)
    assert read_outputs(tmp_path / "port", OUTPUTS) == want
    table = want["merged_feature_table.tsv"].decode().splitlines()
    assert len(table) == (6 if case == "no_fuzzy" else 5)
    if case in ("classify", "sintax"):
        assert "Genus0" in want["merged_asv_taxonomy.tsv"].decode()


def test_export_relabel_count_mismatch_aborts(tmp_path):
    dirs = _runs(tmp_path, 92, None)
    with pytest.raises(SystemExit, match="relabel"):
        port_export.export(ExportArgs(input_dirs=dirs, output_dir=str(tmp_path / "o"),
                                      relabel=["only-one"]))


def test_seq_hash_and_fuzzy_merge_equal_jax():
    rng = np.random.default_rng(93)
    s1 = rand_seq(rng, 120)
    for s in (s1, s1.lower(), b"ACGTTGCAACGT", rand_seq(rng, 1500)):
        assert port_export.seq_hash(s) == jax_export.seq_hash(s)
    tables = []
    for mod in (jax_export, port_export):
        table = {mod.seq_hash(s): (s, [3, k]) for k, s in
                 enumerate((s1, s1 + rand_seq(np.random.default_rng(1), 7),
                            s1 + rand_seq(np.random.default_rng(2), 15)))}
        lineage = {mod.seq_hash(s1): "Bacteria;Firmicutes"}
        n = mod.fuzzy_merge_table(table, lineage)
        tables.append((n, table, lineage))
    assert tables[0] == tables[1] and tables[0][0] >= 1
