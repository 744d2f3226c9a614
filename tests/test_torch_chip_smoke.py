"""chip_smoke.py off the card: its pinned output digests are those of the
JAX package's host runs on its generated reads and classification inputs,
its bounds follow from the shapes, and it refuses to run (exit code not 0,
no result line) without a card or without the repository around it."""
import gzip
import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
import savont_tpu.ops.align as jax_align
from savont_tpu.config import ClassifyArgs, ClusterArgs, ExportArgs, SintaxArgs
from savont_tpu.db.registry import load_database
from savont_tpu.db.synth import build_emu_slice
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu.pipeline.classify import classify
from savont_tpu.pipeline.export import export
from savont_tpu.pipeline.sintax import sintax
from savont_tpu.validate import validate_asvs

from _torch_jobs import clear_caches

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """savont_tpu's host run_cluster on chip_smoke's two seed-pinned samples,
    laid out as phase 5 leaves its work directory: the main sample's
    templates.fa, its run in mesh/, the host-routes sample's in host/; and
    run_cluster(rrna_operon=True) on the operon phase's sample, in
    operon/host/ beside its reads and templates."""
    work = tmp_path_factory.mktemp("chip_smoke_work")
    rng = chip_smoke.main_path_rng()
    for tag, tpl, n in (("mesh", work / "templates.fa", chip_smoke.N_READS),
                        ("host", work / "small" / "templates.fa", chip_smoke.N_READS_SMALL)):
        tpl.parent.mkdir(exist_ok=True)
        fq = tpl.with_name("reads.fq.gz")
        chip_smoke.write_reads(fq, tpl, rng, n)
        clear_caches()
        run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(work / tag), threads=4))
    op = work / "operon"
    op.mkdir()
    chip_smoke.operon_sample(op / "reads.fq.gz", op / "templates.fa")
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(op / "reads.fq.gz")], output_dir=str(op / "host"),
                            threads=4, rrna_operon=True))
    return work


def test_pinned_digests_equal_host_run(host_runs):
    """The digests the card run is held to are those of savont_tpu's host
    run_cluster on the same seed-pinned reads (tolerance 0: bytes)."""
    assert chip_smoke.output_digests(host_runs / "mesh") == chip_smoke.DIGESTS
    val = validate_asvs(str(host_runs / "mesh" / "final_asvs.fasta"), str(host_runs / "templates.fa"))
    assert len(val) >= 5 and all(v.nm == 0 for v in val)


def test_small_sample_digests_equal_host_run(host_runs):
    """The same for the 1,500-read sample of the host-routes run, drawn
    after the main sample."""
    assert chip_smoke.output_digests(host_runs / "host") == chip_smoke.DIGESTS_SMALL
    val = validate_asvs(str(host_runs / "host" / "final_asvs.fasta"),
                        str(host_runs / "small" / "templates.fa"))
    assert len(val) >= 5 and all(v.nm == 0 for v in val)


def test_operon_digests_equal_host_run(host_runs):
    """The operon phase's digests are those of savont_tpu's host
    run_cluster(rrna_operon=True) on the operon sample: ten operon ASVs,
    each at NM=0 against its template."""
    op = host_runs / "operon"
    assert chip_smoke.output_digests(op / "host") == chip_smoke.DIGESTS_OPERON
    val = validate_asvs(str(op / "host" / "final_asvs.fasta"), str(op / "templates.fa"))
    assert len(val) == 10 and all(v.nm == 0 for v in val)


# sha256 of the decompressed fastq and of the templates of each earlier
# sample, as write_reads made them before it took a template length
EARLIER_SAMPLES = {
    "main": ("072d36e0ee8c5c0901dcef5c785bba6649c827e97848556fa205163be74f5185",
             "7264f33c4ee47d603c1fec210bc59441277f568819de93005a19befa0e86b3b7"),
    "small": ("35f0b4658e6316979d5fb0fd0e51899f3b18f53f6516dc2efe404db9758bfad5",
              "c4d3911171834e0628e7c34264d9366a8ef58ab6fc0837133675d6b2eadaf8be"),
    "kmer_cell": ("4772feff6ebbcf20ac593bb376c674758afdcd3470894a5db879e99d28ed32f5",
                  "b961089176f30668a31884fb246082ab60be76c359a2d2c851727ac063964bd8"),
}


def _sample_digests(fq, tpl):
    return (hashlib.sha256(gzip.decompress(fq.read_bytes())).hexdigest(),
            hashlib.sha256(tpl.read_bytes()).hexdigest())


def test_earlier_samples_did_not_move(tmp_path):
    """The main, host-routes and k-mer cell samples draw the same numbers as
    before write_reads took a template length (phase 3's make_pairs draws
    come before the main sample, so it covers them too), so DIGESTS,
    DIGESTS_SMALL and DIGESTS_CLASSIFICATION still hold."""
    import numpy as np

    rng = chip_smoke.main_path_rng()
    got = {}
    for tag, n in (("main", chip_smoke.N_READS), ("small", chip_smoke.N_READS_SMALL)):
        fq, tpl = tmp_path / f"{tag}.fq.gz", tmp_path / f"{tag}.fa"
        chip_smoke.write_reads(fq, tpl, rng, n)
        got[tag] = _sample_digests(fq, tpl)
    fq, tpl = tmp_path / "kmer.fq.gz", tmp_path / "kmer.fa"
    chip_smoke.write_reads(fq, tpl, np.random.default_rng(chip_smoke.KMER_SEED),
                           chip_smoke.N_KMER_READS)
    got["kmer_cell"] = _sample_digests(fq, tpl)
    assert got == EARLIER_SAMPLES


def test_operon_sample_is_one_operon_barcode(host_runs):
    """10,000 reads of 10 templates of 4,400 bp, every read inside the
    preset's 3,500-5,000 bp."""
    from savont_tpu_torch.io.fastx import read_fastx_records

    op = host_runs / "operon"
    tpls = [l for l in (op / "templates.fa").read_text().splitlines() if not l.startswith(">")]
    assert len(tpls) == 10 and {len(t) for t in tpls} == {chip_smoke.OPERON_TEMPLATE_LEN}
    reads = [r.seq for r in read_fastx_records(str(op / "reads.fq.gz"))]
    assert len(reads) == chip_smoke.N_READS_OPERON
    assert all(3500 <= len(r) <= 5000 for r in reads)


def test_classification_digests_equal_host_runs(host_runs, monkeypatch):
    """Phase 6's pinned digests are those of savont_tpu's host runs at the
    band of a fresh process (128; the asv runs above left its module-wide
    band at 48): build_emu_slice of the main sample's templates, classify of
    its ASVs and of the hard ASVs (two samples), sintax, and export of the
    two asv directories, relabelled."""
    monkeypatch.setattr(jax_align, "DEFAULT_BAND", 128)
    work = host_runs
    build_emu_slice(work / "templates.fa", work / "db", n_refs=chip_smoke.DB_REFS,
                    seed=chip_smoke.DB_SEED)
    db_dir = work / "db" / "emu"
    chip_smoke.write_hard_asvs(db_dir / "species_taxid.fasta", work / "hard")
    db = load_database(db_dir)
    for d in ("mesh", "hard"):
        classify(ClassifyArgs(input_dir=str(work / d), db=str(db_dir)), db)
    sintax(SintaxArgs(input_dir=str(work / "mesh"), output_dir=str(work / "sintax"),
                      db=str(db_dir)), db)
    export(ExportArgs(input_dirs=[str(work / "mesh"), str(work / "host")],
                      output_dir=str(work / "export"), relabel=list(chip_smoke.EXPORT_LABELS)))
    got = chip_smoke.classification_digests(work)
    print(got)
    assert got == chip_smoke.DIGESTS_CLASSIFICATION
    hard = (work / "hard" / "asv_mappings.tsv").read_text().splitlines()[1:]
    assert len({r.split("\t")[0] for r in hard}) == chip_smoke.N_HARD
    assert "sampleB" in (work / "hard" / "species_abundance.tsv").read_text()


def test_kernels_table_names_every_counter():
    """Every kernel the port counts launches of stands in chip_smoke's table
    with its source in the repository."""
    from savont_tpu_torch.ops import align_torch, kmers_torch, sintax_torch
    from savont_tpu_torch.probes import bitcast, i16ops, roll, roofline

    counted = set(align_torch.LAUNCHES) - {"walk_overflow"}
    for mod in (roofline, bitcast, i16ops, roll, sintax_torch, kmers_torch):
        counted |= set(mod.LAUNCHES)
    assert counted == set(chip_smoke.KERNELS)
    for src, rep in chip_smoke.KERNELS.values():
        assert (ROOT / src).is_file() and (ROOT / rep.split(":")[0]).is_file()


def test_walk_layout_matches_the_kernel_source():
    """walk_warp_bytes and walk_warps_per_block follow sw_walk.cu's
    make_layout and launch: its constants are chip_smoke's.  At operon
    shapes (band 128, ops_max about 9,000) a pair's warp keeps about 24 KB,
    and four pairs still share a block."""
    import re

    text = (ROOT / "savont_tpu_torch" / "ops" / "csrc" / "sw_walk.cu").read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+)", text).group(1))
             for k in ("kWarps", "kStages", "kMaxRows", "kWindowBytes")}
    assert const == {"kWarps": chip_smoke.WALK_WARPS, "kStages": chip_smoke.WALK_STAGES,
                     "kMaxRows": chip_smoke.WALK_MAX_ROWS,
                     "kWindowBytes": chip_smoke.WALK_WINDOW_BYTES}
    assert "constexpr int kMaxShared = 227 * 1024;" in text
    assert chip_smoke.walk_warp_bytes(128, 8800) == 3 * (4112 + 144) + 8800 + 2048
    assert chip_smoke.walk_warps_per_block(chip_smoke.walk_warp_bytes(128, 8800)) == 4
    assert chip_smoke.walk_warps_per_block(chip_smoke.walk_warp_bytes(48, 150_000)) == 1
    assert chip_smoke.walk_warps_per_block(chip_smoke.walk_warp_bytes(48, 60_000)) == 2


def test_operon_phase_stands_between_phases_7_and_8():
    """The docstring names the operon phase between phases 7 and 8, main()
    runs it there, its kernels 1 and 2 carry an operon sub-object in the
    kernels line, and the last two lines stay the kernels line and the
    result line."""
    import inspect

    doc = chip_smoke.__doc__
    assert doc.index("7. stage-1 k-mers") < doc.index("operon       -") < doc.index("8. ranks")
    src = inspect.getsource(chip_smoke.main)
    assert (src.index("stage1_kmers_phase(") < src.index("operon_phase(")
            < src.index("ranks_phase("))
    assert '"operon": {"launches": op["runs"]["mesh"]["launches"][name]' in src
    tail = [l.strip() for l in src.splitlines() if l.strip().startswith("log(")][-3:]
    assert tail[0] == "log(nvidia_smi_line())"
    assert tail[1] == 'log(json.dumps({"kernels": kernels}))'
    assert tail[2].startswith('log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,')


def test_scale_phase_stands_between_operon_and_phase_8():
    """The docstring names the scale phase between the operon phase and
    phase 8, main() runs it there, kernel 1 (NM) and kernel 3 carry a scale
    sub-object in the kernels line, scale_alone runs it alone, and the last
    two lines stay the kernels line and the result line."""
    import inspect

    doc = chip_smoke.__doc__
    assert doc.index("operon       -") < doc.index("scale        -") < doc.index("8. ranks")
    src = inspect.getsource(chip_smoke.main)
    assert (src.index("operon_phase(") < src.index("scale_phase(") < src.index("ranks_phase("))
    assert 'entry["scale"] = {"launches": sc["runs"]["asv"]["launches"][name], **sc[name]}' in src
    assert '"scale": {"launches": sc["classification"]["sintax"]["sintax_launches"][name],' in src
    assert "scale_phase(work, int32_ops_per_s)" in inspect.getsource(chip_smoke.scale_alone)
    tail = [l.strip() for l in src.splitlines() if l.strip().startswith("log(")][-3:]
    assert tail[0] == "log(nvidia_smi_line())"
    assert tail[1] == 'log(json.dumps({"kernels": kernels}))'
    assert tail[2].startswith('log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,')


def test_sw_bounds_from_shapes():
    shape = {"B": 2304, "Lq": 1450, "Lt": 1450, "band": 48, "walk_steps": 2304 * 1450,
             "walk_max_steps": 1460, "walk_rows": 2304 * 1450}
    b = chip_smoke.sw_bounds(shape, 10e12)
    cells = 2304 * 1450 * 48
    assert b["sw_forward_nm"]["cells"] == cells
    nm_ops_ms = cells * chip_smoke.OPS_PER_CELL["sw_forward_nm"] / 10e12 * 1e3
    assert b["sw_forward_nm"]["bound_ms"] >= nm_ops_ms
    assert b["sw_forward_payload"]["bound_ms"] >= cells / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["sw_walk"]["bound_by"] == "bytes"
    # kernel 2's bound counts the walked bytes; the whole rows it streams and
    # the longest walk's chain of shared-memory loads stand beside it
    walked = 2304 * 1450 * 5 + 2304 * (12 + 4 * chip_smoke.MAXRUN + 24)
    assert b["sw_walk"]["bound_ms"] == walked / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["sw_walk"]["whole_rows_ms"] == 2304 * 1450 * 52 / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["sw_walk"]["whole_rows_ms"] > b["sw_walk"]["bound_ms"]
    assert b["sw_walk"]["chain_floor_ms"] == 1460 * 30 / 1.98e9 * 1e3


# (pairs, rows, real k-mers, distinct query k-mers, hit-list entries): the
# first chunk of the classification cell at its timed shapes (the phase-5
# ASVs, the 40 hard ASVs), one pair of one k-mer, and 4,000 pairs that all
# hold every k-mer of every row (entries past the bytes)
BOUND_SHAPES = {
    "mesh": (1000, 4096, 5_894_144, 7340, 17_903_616),
    "hard": (4000, 4096, 5_894_144, 41_613, 21_860_352),
    "one_pair": (1, 4096, 5_894_144, 1, 40),
    "every_hit": (4000, 4096, 5_894_144, 41_613, 4000 * 5_894_144),
}


@pytest.mark.parametrize("shape", BOUND_SHAPES)
def test_sintax_bound_from_shapes(shape):
    """Kernel 3's bound is its function's, not its design's: its bytes (the
    real k-mers, no padding, the queries and ordinals read, the keys
    written) or, where they take longer, its shared-memory operations, one
    lookup a reference k-mer and one increment a hit-list entry, over 132
    SMs x 32 a clock.  The design's loads (a binary search of ceil(log2
    distinct) steps a k-mer, plus the increments) stand beside it."""
    P, R, kmers, distinct, entries = BOUND_SHAPES[shape]
    b = chip_smoke.sintax_bound(P, R, kmers, distinct, entries)
    steps = max(1, (max(distinct, 2) - 1).bit_length())
    assert b["ops"] == kmers + entries
    assert b["design_loads"] == kmers * steps + entries
    t_ops = b["ops"] / (132 * 32 * chip_smoke.SM_CLOCK_HZ) * 1e3
    t_bytes = 4 * (kmers + P * 32 + R + P) / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["bound_ms"] == max(t_ops, t_bytes)
    assert b["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")
    if shape in ("mesh", "hard"):
        # the rows' 23.6 MB set it, about 0.0071 ms; the design's 13 / 16
        # search steps a k-mer (76.6 M / 94.3 M loads) do not
        assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.0071) < 0.0002
        assert steps == {"mesh": 13, "hard": 16}[shape]
        assert b["design_loads"] / (132 * 32 * chip_smoke.SM_CLOCK_HZ) * 1e3 > b["bound_ms"]
    if shape == "one_pair":
        assert b["bound_by"] == "bytes"
    if shape == "every_hit":
        assert b["bound_by"] == "operations"


@pytest.mark.parametrize("k", chip_smoke.KMER_KS)
def test_kmer_edge_cases_cover_the_edges(k):
    """Phase 7's edge cases at k: reads of length 0, k - 1, k and k + 1;
    masked palindromes (dropped, so fewer valid positions than positions);
    homopolymers; a low middle-base quality, all-equal and absent
    qualities; batches of 1 and 65; a 5,000-bp read; reads of one tile of
    positions, one more, three tiles and past them; reads that start at
    every byte offset mod 16, the last ending the buffer off a 16-byte
    boundary; reads one position each side of one and two rounds of a
    position a thread; reads one position each side of a tile, their
    qualities all equal or equal but for the last base."""
    import numpy as np

    from savont_tpu_torch.ops.encode import encode_seq
    from savont_tpu_torch.ops.kmers import split_kmer_mid

    cases = {c["name"]: c for c in chip_smoke.kmer_edge_cases(k)}
    assert [len(r) for r in cases["lengths"]["reads"]] == [0, k - 1, k, k + 1]
    for name in ("palindrome", "palindrome_run"):
        (r,) = cases[name]["reads"]
        kept = split_kmer_mid(encode_seq(r), None, k, chip_smoke.MIN_BQ)
        assert len(kept) < len(r) - k + 1
    assert len(cases["palindrome_run"]["reads"][0]) == 20 * k
    assert any(set(r) == {ord("A")} for r in cases["homopolymer"]["reads"])
    low = cases["low_mid_quality"]["quals"][0]
    assert low.min() < chip_smoke.MIN_BQ and len(set(low.tolist())) > 1
    assert all(len(set(q.tolist())) == 1 for q in cases["all_equal_quality"]["quals"])
    assert cases["no_quality"]["quals"] is None
    assert any(q is None for q in cases["some_without_quality"]["quals"])
    assert len(cases["one_read"]["reads"]) == 1 and len(cases["65_reads"]["reads"]) == 65
    assert [len(r) for r in cases["operon_5000"]["reads"]] == [5000]
    tile = chip_smoke.KMER_TILE
    lens = [len(r) for r in cases["tile_edges"]["reads"]]
    assert lens[:3] == [tile + k - 1, tile + k, 3 * tile + k - 1] and lens[3] > 3 * tile + k
    # every start offset mod 16, the last read ending the buffer off a
    # 16-byte boundary
    lens = [len(r) for r in cases["offsets16"]["reads"]]
    assert lens == list(range(k - 1, k + 33))
    assert {int(s) % 16 for s in np.cumsum([0] + lens[:-1])} == set(range(16))
    assert sum(lens) % 16 != 0 and lens[-1] % 16 != 0
    threads = chip_smoke.KMER_THREADS
    assert [len(r) - k + 1 for r in cases["thread_edges"]["reads"]] == [
        threads - 1, threads, threads + 1, 2 * threads - 1, 2 * threads, 2 * threads + 1]
    tq = cases["tile_quality"]
    assert [len(r) - k + 1 for r in tq["reads"]] == [tile - 1, tile, tile, tile + 1, tile + 1]
    for i in (1, 3):  # all equal, below MIN_BQ: the gate is off
        assert len(set(tq["quals"][i].tolist())) == 1 and tq["quals"][i][0] < chip_smoke.MIN_BQ
    for i in (2, 4):  # the same but for the last base: the gate is on
        a = tq["quals"][i]
        assert (a[:-1] == tq["quals"][i - 1][:-1]).all() and a[-1] != a[0]


def test_kmer_tile_matches_the_kernel_sources():
    """KMER_TILE and KMER_THREADS are the kTile and kThreads of both kernel
    sources, so that the edge cases straddle the real tile and rounds."""
    import re

    for src in ("split_kmers.cu", "syncmers.cu"):
        text = (ROOT / "savont_tpu_torch" / "ops" / "csrc" / src).read_text()
        assert int(re.search(r"kThreads = (\d+);", text).group(1)) == chip_smoke.KMER_THREADS
        assert int(re.search(r"kTile = (\d+);", text).group(1)) == chip_smoke.KMER_TILE


@pytest.mark.parametrize("name", ["split_kmers", "syncmers"])
def test_kmer_bound_from_shapes(name):
    """Kernels 4 and 5 are bound by the larger of their bytes (codes, and
    phreds for kernel 4, read once; the offsets; 9 B written a position)
    and the integer operations their functions need a position over the
    int32 rate.  At the kernel cell's shape (20,000 reads, 28,963,837
    bases, 28,643,837 positions) and the measured 32.6 T int32 ops/s both
    are bound by bytes: kernel 4 about 0.0943 ms, kernel 5 at c = 11 about
    0.0857 ms (its 91 operations a position take 0.080)."""
    bases, pos, reads = 28_963_837, 28_643_837, 20_000
    b = chip_smoke.kmer_bound(name, bases, pos, reads, name == "split_kmers", 32.6e12)
    nbytes = bases * (2 if name == "split_kmers" else 1) + 16 * (reads + 1) + 9 * pos
    per_pos = 28 if name == "split_kmers" else 91
    assert b["bytes"] == nbytes and b["ops"] == per_pos * pos
    assert b["bound_ms"] == max(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3, per_pos * pos / 32.6e12 * 1e3)
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] - {"split_kmers": 0.0943, "syncmers": 0.0857}[name]) < 0.0001


@pytest.mark.parametrize("c, ops", [(1, 77), (2, 79), (3, 82), (4, 91), (7, 91), (8, 100),
                                    (11, 91), (21, 91), (31, 91)])
def test_syncmer_ops_do_not_grow_with_the_window(c, ops):
    """Kernel 5's function needs a count a position that stops growing with
    c: 77 for the hashes and k-mers, 9 for each sliding minimum (one for
    each distinct side width above 1: two for an even c from 6, whose sides
    differ by one), 2 for a compare with each side and 1 for their and; c =
    1 has no other hash to compare."""
    assert chip_smoke.syncmer_ops(c) == ops


def test_stage1_turns_alternate():
    """The stage-1 route is timed on both routes in turns, as often each,
    without -b and with it."""
    for order in (chip_smoke.STAGE1_ORDER, chip_smoke.STAGE1_BLOOM_ORDER):
        assert order.count("host") == order.count("mesh") >= 2
        assert order[:2] == ("host", "mesh") and order[2:4] == ("mesh", "host")
    assert chip_smoke.STAGE1_ORDER.count("mesh") >= 3 and chip_smoke.STAGE1_BLOOM_SIZE > 0


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    run = [sys.executable, "chip_smoke.py"]
    r = subprocess.run(run, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run(run, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
