"""The port's sintax against the JAX package, on the CPU.

Kernel 6's plain version (the references' rows of k-mers) is held to the
host extraction it took over, np.unique(extract_kmers(seq.upper())), over
chip_smoke's cases for kernel 6.  Kernel 3's plain version
(ops/sintax_torch.py), through its public entry and through the route's
lower entry (the query index, ragged rows), is
held to the JAX package's mesh step sharded_sintax_scores on a one-device
CPU mesh, over chip_smoke's edge cases (the inputs the card run holds the
kernel to), and the port's device scores to the host stream _host_scores; the port's
`sintax --device cpu` to the JAX package's host sintax and to the plain
SINTAX (benchmark/plain_sintax.py), byte for byte, on emu-1 and silva-138.2
databases.  Tolerance 0: the keys are integers and the outputs bytes."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from savont_tpu.config import SintaxArgs as JaxSintaxArgs
from savont_tpu.db import registry as jax_registry
from savont_tpu.parallel.mesh import make_mesh, sharded_sintax_scores
from savont_tpu.pipeline import sintax as jax_sintax
from savont_tpu_torch.config import SintaxArgs
from savont_tpu_torch.db import registry, taxonomy
from savont_tpu_torch.io import fastx
from savont_tpu_torch.io.fastx import read_fastx
from savont_tpu_torch.ops import sintax_torch
from savont_tpu_torch.ops.encode import revcomp_bytes
from savont_tpu_torch.pipeline import sintax as port_sintax

from _torch_jobs import reference_native  # noqa: F401  (autouse: savont_tpu's native libraries whole)
from benchmark import plain_sintax
from _torch_jobs import (
    SILVA_ORPHAN, graded_refs, rand_seq, read_outputs, substitute, write_asv_dir, write_emu_db,
    write_silva_db,
)

OUTPUTS = ("genus_abundance.tsv", "asv_mappings.tsv")
ROOT = Path(__file__).resolve().parent.parent
N_EDGE = len(chip_smoke.sintax_edge_cases())
N_REF = len(chip_smoke.sintax_ref_cases())


def _jax_keys(case) -> np.ndarray:
    """Per chunk the JAX step on one CPU device, max'ed across chunks as its
    route does."""
    step = sharded_sintax_scores(make_mesh(1), case["queries"])
    want = np.zeros(len(case["queries"]), dtype=np.uint32)
    for r0 in range(0, len(case["refk"]), case["chunk"]):
        want = np.maximum(want, np.asarray(step(case["refk"][r0 : r0 + case["chunk"]],
                                                case["ridx"][r0 : r0 + case["chunk"]])))
    return want.astype(np.int64)


def _plain_keys(case) -> np.ndarray:
    q = torch.from_numpy(sintax_torch.kernel_kmers(case["queries"]))
    acc = torch.zeros(q.shape[0], dtype=torch.int32)
    refk = torch.from_numpy(sintax_torch.kernel_kmers(case["refk"]))
    ridx = torch.from_numpy(case["ridx"].astype(np.int32))
    calls = sintax_torch.REFERENCE_CALLS["sintax_scores"]
    for r0 in range(0, refk.shape[0], case["chunk"]):
        sintax_torch.sintax_scores(q, refk[r0 : r0 + case["chunk"]].contiguous(),
                                   ridx[r0 : r0 + case["chunk"]].contiguous(), acc)
    assert sintax_torch.REFERENCE_CALLS["sintax_scores"] > calls
    return sintax_torch.keys_int64(acc).numpy()


@pytest.mark.parametrize("k", range(N_EDGE))
def test_kernel3_plain_equals_jax_mesh_step(k):
    """The public entry (JAX layout) accumulating the same chunks as the JAX
    step."""
    case = chip_smoke.sintax_edge_cases()[k]
    got = _plain_keys(case)
    assert np.array_equal(got, _jax_keys(case)), case["name"]
    if case["name"] == "ties_chunks":
        scores = got >> 26
        assert scores.max() == 32 and (got[[0, 17, 299]] == 0).all()
        # pair 1's 32 repeated slots lie in row 1 only: score 32, ordinal 1
        assert got[1] == (32 << 26) | (0x3FFFFFF - 1)
    if case["name"] == "max_ordinal":
        # score 32 at ordinal 2^26 - 1: bit 31 and no ordinal bit
        assert got[0] == 1 << 31
    if case["name"] == "hot_key":
        assert (got >> 26).min() == 0 and ((got >> 26) >= 4).sum() == len(got) - 1


@pytest.mark.parametrize("k", range(N_EDGE))
def test_kernel3_rows_plain_equals_jax_mesh_step(k):
    """The lower entry's plain version on what the route gives it: the host
    stream's CSR (query_index on the uint32 query matrix, as _host_scores
    builds it) and each chunk's rows with the padding stripped, and with it
    kept (kernel 6's layout: unique k-mers, then ROW_PAD to the row's
    capacity, each pad a miss)."""
    case = chip_smoke.sintax_edge_cases()[k]
    index = sintax_torch.index_on(*sintax_torch.query_index(case["queries"], np.uint32(0xFFFFFFFE)),
                                  len(case["queries"]), "cpu")
    acc = torch.zeros(len(case["queries"]), dtype=torch.int32)
    padded = torch.zeros_like(acc)
    for r0 in range(0, len(case["refk"]), case["chunk"]):
        ridx = torch.from_numpy(case["ridx"][r0 : r0 + case["chunk"]].astype(np.int32))
        rows = [r[r != 0xFFFFFFFF] for r in case["refk"][r0 : r0 + case["chunk"]]]
        kmers, row_off = sintax_torch.ragged_rows(rows)
        sintax_torch.sintax_scores_rows(index, torch.from_numpy(kmers), torch.from_numpy(row_off),
                                        ridx, acc)
        part = sintax_torch.kernel_kmers(case["refk"][r0 : r0 + case["chunk"]])
        sintax_torch.sintax_scores_rows(index, torch.from_numpy(part.reshape(-1)),
                                        torch.arange(len(part) + 1) * part.shape[1], ridx, padded)
    assert np.array_equal(sintax_torch.keys_int64(acc).numpy(), _jax_keys(case)), case["name"]
    assert torch.equal(padded, acc), case["name"]


def test_edge_cases_reach_the_kernels_limits():
    """The cases that stand for kernel 3's limits reach them: more distinct
    query k-mers than a block holds in shared memory, more pairs than a
    tile, a key held by every pair, a row longer than 12,288 beside rows of
    one k-mer."""
    cases = {c["name"]: c for c in chip_smoke.sintax_edge_cases()}
    keys, off, _ = sintax_torch.query_index(cases["many_keys"]["queries"], np.uint32(0xFFFFFFFE))
    assert len(keys) > chip_smoke.SINTAX_SMEM_KEYS
    assert len(cases["many_pairs"]["queries"]) > 2 * chip_smoke.SINTAX_PAIR_TILE
    hot = cases["hot_key"]
    keys, off, pairs = sintax_torch.query_index(hot["queries"], np.uint32(0xFFFFFFFE))
    i = np.searchsorted(keys, hot["refk"][0, 0])
    assert off[i + 1] - off[i] >= 4 * (len(hot["queries"]) - 2) > chip_smoke.SINTAX_PAIR_TILE
    lens = (cases["short_long_rows"]["refk"] != 0xFFFFFFFF).sum(axis=1)
    assert lens.min() == 1 and lens.max() > 12288
    assert cases["max_ordinal"]["ridx"].max() == chip_smoke.ORD_MASK


def test_kernel3_pair_tile_matches_source():
    """chip_smoke's SINTAX_PAIR_TILE is the kernel's kPairTile (4 pairs a
    word, kWordsPerThread words a thread, kThreads threads), and its
    SINTAX_SMEM_KEYS the kernel's kSmemKeys."""
    src = (Path(chip_smoke.__file__).parent / "savont_tpu_torch/ops/csrc/sintax_scores.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert 4 * const["kWordsPerThread"] * const["kThreads"] == chip_smoke.SINTAX_PAIR_TILE
    assert const["kSmemKeys"] == chip_smoke.SINTAX_SMEM_KEYS


@pytest.mark.parametrize("k", range(N_EDGE))
def test_kernel3_dense_equals_jax_mesh_step(k):
    """The dense composition, the yardstick timed beside the kernel, is the
    same function: equal to the JAX step on every edge case."""
    case = chip_smoke.sintax_edge_cases()[k]
    q = torch.from_numpy(sintax_torch.kernel_kmers(case["queries"]))
    refk = torch.from_numpy(sintax_torch.kernel_kmers(case["refk"]))
    ridx = torch.from_numpy(case["ridx"].astype(np.int32))
    acc = torch.zeros(q.shape[0], dtype=torch.int32)
    for r0 in range(0, refk.shape[0], case["chunk"]):
        sintax_torch.sintax_scores_dense(q, refk[r0 : r0 + case["chunk"]], ridx[r0 : r0 + case["chunk"]], acc)
    assert np.array_equal(sintax_torch.keys_int64(acc).numpy(), _jax_keys(case)), case["name"]


def _host_csr_before(subs, sentinel, n_pairs):
    """The CSR construction _host_scores held inline before query_index."""
    live = subs.reshape(-1) != sentinel
    pair_of = np.repeat(np.arange(n_pairs, dtype=np.int64), subs.shape[1])[live]
    flat = subs.reshape(-1)[live]
    order = np.argsort(flat, kind="stable")
    flat, pair_of = flat[order], pair_of[order]
    keys = np.unique(flat)
    off = np.append(np.searchsorted(flat, keys, side="left"), len(flat)).astype(np.int64)
    return keys, off, pair_of


def test_query_index_equals_host_stream_csr():
    """query_index is the CSR _host_scores built: duplicate slots kept,
    sentinel slots dropped, each key's entries between its offsets,
    ascending by pair."""
    rng = np.random.default_rng(84)
    subs = rng.integers(0, 50, (40, 32)).astype(np.uint32)
    subs[3] = 0xFFFFFFFE
    subs[7, :] = 9
    subs[11, 5:] = 0xFFFFFFFE
    keys, off, pairs = sintax_torch.query_index(subs, np.uint32(0xFFFFFFFE))
    for got, want in zip((keys, off, pairs), _host_csr_before(subs, np.uint32(0xFFFFFFFE), 40)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(pairs) == 39 * 32 - 27 and 0xFFFFFFFE not in keys and 3 not in pairs
    assert off[0] == 0 and off[-1] == len(pairs) and len(off) == len(keys) + 1
    for i, key in enumerate(keys):
        seg = pairs[off[i] : off[i + 1]]
        assert np.array_equal(seg, np.sort(seg))
        assert np.array_equal(np.bincount(seg, minlength=40), (subs == key).sum(axis=1))
    assert (pairs[off[np.searchsorted(keys, 9)] : off[np.searchsorted(keys, 9) + 1]] == 7).sum() >= 32


def test_ragged_rows_equal_padded_rows():
    """The route's ragged chunk is the padded chunk the route built before,
    the padding stripped."""
    rng = np.random.default_rng(85)
    pend = [np.unique(rng.integers(0, 1 << 24, n)).astype(np.uint32) for n in (1, 300, 17, 1500, 2)]
    L = max(8, 1 << (max(len(a) for a in pend) - 1).bit_length())
    refk = np.full((len(pend), L), sintax_torch.ROW_PAD, dtype=np.int32)
    for i, a in enumerate(pend):
        refk[i, : len(a)] = a
    kmers, row_off = sintax_torch.ragged_rows(pend)
    assert kmers.dtype == np.int32 and row_off.dtype == np.int64 and row_off[0] == 0
    for r in range(len(pend)):
        assert np.array_equal(kmers[row_off[r] : row_off[r + 1]], refk[r][refk[r] != sintax_torch.ROW_PAD])
    assert row_off[-1] == len(kmers) == sum(map(len, pend))
    # the public entry's unpadding of the same rows gives the same layout
    got = sintax_torch.unpadded_rows(torch.from_numpy(refk))
    assert np.array_equal(got[0].numpy(), kmers) and np.array_equal(got[1].numpy(), row_off)


def test_kernel3_wrapper_checks():
    q = torch.zeros((4, 32), dtype=torch.int32)
    refk = torch.zeros((2, 8), dtype=torch.int32)
    ridx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        sintax_torch.sintax_scores(q[:, :31].contiguous(), refk, ridx, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        sintax_torch.sintax_scores(q, refk.long(), ridx, torch.zeros(4, dtype=torch.int32))
    index = sintax_torch.index_on(*sintax_torch.query_index(q.numpy(), sintax_torch.QUERY_SENTINEL),
                                  4, "cpu")
    kmers, row_off = torch.zeros(3, dtype=torch.int32), torch.tensor([0, 1, 3])
    with pytest.raises(ValueError, match="CUDA"):
        sintax_torch.sintax_scores_rows_launch(index, kmers, row_off, ridx, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        sintax_torch.sintax_scores_rows(index, kmers, row_off.int(), ridx, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape mismatch"):
        sintax_torch.sintax_scores_rows(index, kmers, row_off, ridx, torch.zeros(5, dtype=torch.int32))


def _edge_db(tmp_path, seed: int, fmt: str = "emu-1"):
    """Graded references plus the edges of the host stream: two references
    of equal sequence under different taxa (ties: the earlier is kept), a
    reference of 9 bases (no k-mer), one whose taxon is missing, and ASVs of
    10 bases (no k-mer: sentinel rows) and 14 bases (3 k-mers, so slots
    repeat and a reference that holds them scores 32).  In fmt emu-1 or
    silva-138.2 (write_silva_db's shapes: RNA, 60-base lines, gzip, an
    accession of two records, IUPAC bytes); the same ASVs in both."""
    rng = np.random.default_rng(seed)
    refs = graded_refs(seed, n_bases=3)
    short = rand_seq(rng, 14)
    refs.insert(5, ("2001", "Twin A", "TwinGenus", "Fam9", refs[12][4]))
    refs += [("2002", "Twin B", "OtherGenus", "Fam9", refs[12][4]),
             ("2003", "Tiny", "TinyGenus", "Fam9", rand_seq(rng, 9)),
             ("2004", "Holder", "HolderGenus", "Fam9", rand_seq(rng, 300) + short)]
    orphan = rand_seq(rng, 500)
    if fmt == "silva-138.2":
        write_silva_db(tmp_path / "db", refs, seed)
    else:
        write_emu_db(tmp_path / "db", refs)
        with open(tmp_path / "db" / "species_taxid.fasta", "a") as f:
            f.write(f">9999:emu_db:0\n{orphan.decode()}\n")
    asvs = [refs[0][4], bytes(substitute(rng, refs[12][4], 0.05)),
            revcomp_bytes(bytes(substitute(rng, refs[25][4], 0.08))), rand_seq(rng, 10), short,
            rand_seq(rng, 1400)]
    return tmp_path / "db", asvs


def _kept_refs(db) -> int:
    """The database's references the host stream scores: a key, a taxon and
    a k-mer (12 bases or more)."""
    return sum(1 for rec in read_fastx(str(db.fasta_path))
               if (key := db.extract_key(rec.id)) is not None and db.taxonomy.get(key) is not None
               and len(rec.seq) >= 12)


def test_device_scores_equal_host_stream(tmp_path, monkeypatch):
    """The port's device scores, in chunks of 4 references so that ties fall
    across launches, against the host stream of the same package; every
    kept reference with a k-mer scored, none of its rows extracted on a
    card."""
    db_dir, asvs = _edge_db(tmp_path, 81)
    db = registry.load_database(db_dir)
    subs = port_sintax.query_matrix(asvs, 20)
    monkeypatch.setattr(port_sintax, "CHUNK_ROWS", 4)
    for k in ("refs", "kmer_rows_card"):
        monkeypatch.setitem(port_sintax.SCORE_STATS, k, 0)
    dev_scores, dev_tax = port_sintax._device_scores(subs, db, len(subs), "cpu")
    assert port_sintax.SCORE_STATS["refs"] == _kept_refs(db) > 0
    assert port_sintax.SCORE_STATS["kmer_rows_card"] == 0
    host_scores, host_tax = port_sintax._host_scores(subs, port_sintax.QUERY_SENTINEL, db, len(subs))
    assert np.array_equal(dev_scores, host_scores)
    assert [None if e is None else dataclasses.astuple(e) for e in dev_tax] == \
        [None if e is None else dataclasses.astuple(e) for e in host_tax]
    assert dev_scores.max() == 32 and (dev_scores[60:80] == 0).all()


# (database format, --detailed-unclassified, the yardstick): the JAX
# package's host sintax, or the plain SINTAX of benchmark/plain_sintax.py
SINTAX_CASES = [pytest.param("emu-1", False, "jax", id="False"),
                pytest.param("emu-1", True, "jax", id="True")] + [
    pytest.param(fmt, detailed, yardstick, id=f"{fmt}-{detailed}-{yardstick}")
    for fmt, yardstick in (("silva-138.2", "jax"), ("emu-1", "plain"), ("silva-138.2", "plain"))
    for detailed in (False, True)]


@pytest.mark.parametrize("fmt, detailed, yardstick", SINTAX_CASES)
def test_sintax_equals_jax_host(tmp_path, fmt, detailed, yardstick):
    """The port's `sintax --device cpu` against the JAX package's host
    sintax, or the plain SINTAX, byte for byte, on the edge database in
    either format."""
    db_dir, asvs = _edge_db(tmp_path, 82, fmt)
    in_dir = write_asv_dir(tmp_path / "run", asvs)
    kw = {"detailed_unclassified": detailed, "n_iter": 50}
    if yardstick == "jax":
        jax_sintax.sintax(JaxSintaxArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "want"),
                                        db=str(db_dir), **kw), jax_registry.load_database(db_dir))
    else:
        plain_sintax.sintax(in_dir, db_dir, tmp_path / "want", n_iter=50, detailed=detailed)
    port_sintax.sintax(SintaxArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "port"),
                                  db=str(db_dir), device="cpu", **kw), registry.load_database(db_dir))
    want = read_outputs(tmp_path / "want", OUTPUTS)
    assert read_outputs(tmp_path / "port", OUTPUTS) == want
    assert "Genus0" in want["asv_mappings.tsv"].decode()


def test_plain_sintax_imports_neither_package():
    """The plain SINTAX runs where nothing imports JAX: loading it loads no
    module of savont_tpu or savont_tpu_torch, nor jax."""
    code = ("import sys, benchmark.plain_sintax; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('savont_tpu', 'savont_tpu_torch', 'jax', 'jaxlib', 'torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_silva_entries_built_for_winners_only(tmp_path, monkeypatch):
    """On the SILVA edge database, in chunks of 4 references: the device
    scores equal the host stream's (the record TAXMAP lacks is skipped and
    keeps its record index, so the ordinals, and the earliest of two equal
    references, are as before); every kept record is counted, and TAXMAP
    entries are built only for the references that win a pair."""
    db_dir, asvs = _edge_db(tmp_path, 87, "silva-138.2")
    db = registry.load_database(db_dir)
    assert isinstance(db.taxonomy, taxonomy.SilvaTaxmap) and not db.taxonomy._entries
    assert SILVA_ORPHAN not in db.taxonomy and len(db.taxonomy) == 33  # 34 refs, two share an accession
    subs = port_sintax.query_matrix(asvs, 20)
    monkeypatch.setattr(port_sintax, "CHUNK_ROWS", 4)
    for k in ("refs", "db_records", "db_kept", "db_bases"):
        monkeypatch.setitem(port_sintax.SCORE_STATS, k, 0)
    dev_scores, dev_tax = port_sintax._device_scores(subs, db, len(subs), "cpu")
    built = set(db.taxonomy._entries)
    winners = {e.tax_id for e in dev_tax if e is not None}
    assert {db.taxonomy[k].tax_id for k in built} == winners and len(built) < len(db.taxonomy)
    st = port_sintax.SCORE_STATS
    records = list(read_fastx(str(db.fasta_path)))
    assert st["db_records"] == len(records) == 35 and st["db_kept"] == 34
    assert st["db_bases"] == sum(len(r.seq) for r in records)
    assert st["refs"] == _kept_refs(db) == 33  # the 9-base record has no k-mer
    host_scores, host_tax = port_sintax._host_scores(subs, port_sintax.QUERY_SENTINEL, db, len(subs))
    assert np.array_equal(dev_scores, host_scores)
    assert [None if e is None else dataclasses.astuple(e) for e in dev_tax] == \
        [None if e is None else dataclasses.astuple(e) for e in host_tax]
    assert dev_scores.max() == 32 and "2004" in winners  # the holder of the short ASV


@pytest.mark.parametrize("fmt", ["silva-138.2", "emu-1"])
def test_sintax_counts_its_inflate_workers(tmp_path, monkeypatch, fmt):
    """SCORE_STATS carries the database stream's inflate counts: SILVA's
    FASTA.gz, cut into chunks of 8 KiB, is inflated on threads - 1 workers
    from speculative starts that the real decode verified, and scores as on
    one thread; EMU's FASTA, plain text, is read by one thread whatever the
    threads, and the counts stay 0."""
    refs = graded_refs(88, n_bases=10)
    (write_silva_db if fmt == "silva-138.2" else write_emu_db)(tmp_path / "db", refs)
    db = registry.load_database(tmp_path / "db")
    subs = port_sintax.query_matrix([refs[3][4], refs[47][4][:900]], 10)
    monkeypatch.setattr(fastx, "CHUNK_BYTES", 8192)
    runs = []
    for threads in (4, 1):
        for k in fastx.INFLATE_COUNTS:
            monkeypatch.setitem(port_sintax.SCORE_STATS, k, 0)
        scores, taxa = port_sintax._device_scores(subs, db, len(subs), "cpu", threads)
        counts = {k: port_sintax.SCORE_STATS[k] for k in fastx.INFLATE_COUNTS}
        runs.append((scores, [None if e is None else dataclasses.astuple(e) for e in taxa], counts))
    (par_scores, par_tax, par), (one_scores, one_tax, one) = runs
    assert np.array_equal(par_scores, one_scores) and par_tax == one_tax and par_scores.max() == 32
    assert set(one.values()) == {0}
    workers = min(4, os.cpu_count() or 1) - 1
    if fmt == "emu-1" or workers < 2:
        assert set(par.values()) == {0}
    else:
        assert db.fasta_path.stat().st_size > 4 * 8192
        assert par["inflate_workers"] == workers and par["inflate_chunks_spec"] > 0
        assert par["inflate_fallback"] == 0


def test_extract_kmers_and_xorshift_equal_jax():
    rng = np.random.default_rng(83)
    for n in (0, 11, 12, 13, 200):
        s = rand_seq(rng, n) + b"acgtu"
        assert np.array_equal(port_sintax.extract_kmers(s), jax_sintax.extract_kmers(s))
    for seed in (0, 1, 42, 2**63 + 5):
        a, b = port_sintax.Xorshift(seed), jax_sintax.Xorshift(seed)
        assert [a.next_usize(97) for _ in range(50)] == [b.next_usize(97) for _ in range(50)]


@pytest.fixture(scope="module")
def ref_cases():
    return chip_smoke.sintax_ref_cases()


def _host_rows(seqs) -> list[np.ndarray]:
    """Each reference's row as the host extracted it before kernel 6:
    np.unique(extract_kmers(seq.upper())), then ROW_PAD to its capacity of
    max(len - 11, 0)."""
    rows = []
    for seq in seqs:
        row = np.full(max(len(seq) - 11, 0), sintax_torch.ROW_PAD, dtype=np.int32)
        u = np.unique(port_sintax.extract_kmers(seq.upper()))
        row[: len(u)] = u
        rows.append(row)
    return rows


def _code(kmer: bytes) -> int:
    return int(port_sintax.extract_kmers(kmer)[0])


@pytest.mark.parametrize("k", range(N_REF))
def test_kernel6_plain_equals_host_extraction(ref_cases, k):
    """Kernel 6's plain version, on each of the card's cases, gives every
    reference the host's sorted unique canonical 12-mers followed by
    ROW_PAD, at row_off, the cumulative capacities."""
    case = ref_cases[k]
    seqs = case["seqs"]
    joined, off, row_off = sintax_torch.ref_rows(seqs)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    assert bytes(joined) == b"".join(seqs)
    assert np.array_equal(off, np.concatenate(([0], np.cumsum(lens))))
    assert np.array_equal(row_off, np.concatenate(([0], np.cumsum(np.maximum(lens - 11, 0)))))
    calls = sintax_torch.REFERENCE_CALLS["sintax_ref_kmers"]
    got = sintax_torch.sintax_ref_kmers(sintax_torch.ref_rows_on(joined, off, row_off, "cpu"))
    assert sintax_torch.REFERENCE_CALLS["sintax_ref_kmers"] == calls + 1
    assert got.dtype == torch.int32 and got.shape == (row_off[-1],)
    rows = [got[row_off[r] : row_off[r + 1]].numpy() for r in range(len(seqs))]
    for r, (g, w) in enumerate(zip(rows, _host_rows(seqs))):
        assert np.array_equal(g, w), (case["name"], r)
    name = case["name"]
    if name == "bytes":
        assert set(joined) == set(range(256))
    if name == "lengths":
        assert [len(r) for r in rows] == [0, 0, 0, 1, 2, 0, 1, 3, 29, 0, 1]
        assert rows[6][0] == 0  # N encodes as A: NNNNNNNNNNNN is AAAAAAAAAAAA
    if name == "repeats":
        assert rows[0].tolist() == [0] + [sintax_torch.ROW_PAD] * 488
        assert (rows[1] != sintax_torch.ROW_PAD).sum() == 1 and (rows[4] != sintax_torch.ROW_PAD).sum() == 2
    if name == "revcomp":
        assert all(np.array_equal(rows[0], rows[i]) for i in (1, 2, 3))
    if name == "palindromes":
        assert rows[0].tolist() == [_code(b"AAACCCGGGTTT")]
        assert _code(b"AAACCCGGGTTT") == _code(revcomp_bytes(b"AAACCCGGGTTT"))
    if name == "tile_edges":
        assert [len(r) for r in rows[:6]] == [2047, 2048, 2049, 4096, 4097, 6143]
    if name == "emu_chunk":
        assert len(rows) == 4096 and 1330 <= lens.min() and lens.max() <= 1570
    if name == "long_rows":
        assert lens.max() - 11 > 2 * 57_000 and (rows[6] != sintax_torch.ROW_PAD).sum() <= 997


def test_kernel6_byte_code_equals_host_table():
    """The table the plain version encodes through (and the kernel's, in
    sintax_ref_kmers.cu) is the host's, for every byte."""
    assert np.array_equal(sintax_torch.BYTE_CODE.numpy(), port_sintax._BYTE_CODE.astype(np.int64))


def test_kernel6_tile_matches_source():
    """chip_smoke's SINTAX_REF_TILE is the kernel's kTile, and the plain
    version's K its kK."""
    src = (Path(chip_smoke.__file__).parent / "savont_tpu_torch/ops/csrc/sintax_ref_kmers.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kTile"] == chip_smoke.SINTAX_REF_TILE and const["kK"] == sintax_torch.K == 12


def test_kernel6_wrapper_checks():
    joined, off, row_off = sintax_torch.ref_rows([b"ACGT" * 10, b"AC"])
    with pytest.raises(ValueError, match="row_off"):
        sintax_torch.ref_rows_on(joined, off, row_off + 1, "cpu")
    rows = sintax_torch.ref_rows_on(joined, off, row_off, "cpu")
    assert rows.max_n == 29 and rows.n_kmers == 29
    with pytest.raises(ValueError, match="CUDA"):
        sintax_torch.sintax_ref_kmers_launch(rows, torch.empty(29, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        sintax_torch.sintax_ref_kmers(rows._replace(seqs=rows.seqs.int()))
    with pytest.raises(ValueError, match="one entry a row"):
        sintax_torch.sintax_ref_kmers(rows._replace(row_off=rows.row_off[:-1].contiguous()))
    empty = sintax_torch.ref_rows_on(*sintax_torch.ref_rows([]), "cpu")
    assert sintax_torch.sintax_ref_kmers(empty).shape == (0,)


def test_kernel6_card_route_without_card_raises(tmp_path):
    """--device cuda never falls back to the plain versions: the chunk's
    upload and the route raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the route runs there")
    with pytest.raises(RuntimeError):
        sintax_torch.ref_rows_on(*sintax_torch.ref_rows([b"ACGT" * 10]), "cuda")
    db_dir, asvs = _edge_db(tmp_path, 86)
    with pytest.raises(RuntimeError):
        port_sintax._device_scores(port_sintax.query_matrix(asvs, 2), registry.load_database(db_dir),
                                   len(asvs) * 2, "cuda")
