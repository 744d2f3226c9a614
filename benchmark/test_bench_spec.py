"""CPU tests of the benchmark's resolution by name, its window arithmetic,
its trace reading, its samples and its import check.

    python3 -m pytest benchmark/ -q
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import spec
from benchmark.refio import read_fasta
from benchmark.run import Record, Runner
from benchmark.sample import make_sample, revcomp
from benchmark.trace import summarize
from benchmark.window import closed_loop, end_to_end

ROOT = Path(__file__).resolve().parent.parent


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.config["threads"] >= 1
        assert (spec.HERE / "checks" / f"{cell.traffic['check']}.py").exists()
        for m in cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        assert {m["name"] for m in cell.end_to_end} == set(cell.traffic["reports"]) | {"setup_s"}
        db_format = spec.load_module("databases", cell.config.get("db_format", "emu-1"))
        assert callable(db_format.build) and callable(db_format.read)


def test_a_cell_is_found_from_new_files_alone(tmp_path):
    """A later PR adds a configuration, a traffic mix and a metric as new
    files and new entries; the harness finds them with no edit."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench_dir / "configs" / "ont16s_emu.json").read_text())
    cfg.update(n_templates=300)
    (bench_dir / "configs" / "ont16s_300.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "asv.json").read_text())
    traffic["argv"] = traffic["argv"] + ["--stage1-backend", "mesh"]
    (bench_dir / "traffic" / "asv_mesh.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "calls_in_window.py").write_text(
        "def read(record):\n    return float(len(record.calls))\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ont16s_300", "source": "x", "file": "benchmark/configs/ont16s_300.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ont16s_300.asv_mesh", "config": "ont16s_300",
                               "traffic": "asv_mesh", "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "asv_reads_per_s")["workloads"].append(
        "ont16s_300.asv_mesh")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "CLI and driver",
                               "moves": "asv_reads_per_s", "workloads": ["ont16s_300.asv_mesh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("ont16s_300.asv_mesh", tmp_path, bench_dir)
    assert cell.config["n_templates"] == 300
    assert cell.traffic["argv"][-1] == "mesh"
    assert {m["name"] for m in cell.end_to_end} == {"asv_reads_per_s", "setup_s"}
    names = [m["name"] for m in cell.per_layer]
    assert "calls_in_window" in names and "classify_route_s" not in names
    reader = spec.load_module("metrics", "calls_in_window", bench_dir)
    assert reader.read(Record(calls=[{}, {}], window_s=1.0)) == 2.0


def fake_clock(times):
    it = iter(times)
    return lambda: next(it)


def test_window_counts_all_work_over_all_time():
    """Three calls of 100 reads, the second one stalled: the rate is the 300
    reads over the whole window, the stall included; a call starts only
    while the elapsed time is under the window's seconds."""
    # clock reads: t0, then for each call: loop test, start, end; then the
    # loop test that stops
    clock = fake_clock([0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 9.0, 9.0, 9.0, 11.0, 11.0])
    calls, window_s = closed_loop(lambda i: {"ok": True, "work": 100}, 10.0, clock)
    assert [c["wall_s"] for c in calls] == [2.0, 7.0, 2.0]
    assert window_s == 11.0  # the last call ran past the 10 s and counts whole
    assert end_to_end("work_per_s", calls, window_s) == pytest.approx(300 / 11.0)
    assert end_to_end("s_per_call", calls, window_s) == pytest.approx(11.0 / 3)


def test_window_counts_a_failed_call_as_no_work():
    clock = fake_clock([0.0, 0.0, 0.0, 4.0, 4.0, 4.0, 8.0, 8.0])
    oks = iter([True, False])
    calls, window_s = closed_loop(lambda i: {"ok": next(oks), "work": 50}, 5.0, clock)
    assert end_to_end("work_per_s", calls, window_s) == pytest.approx(50 / 8.0)


def test_trace_busy_and_idle_by_span():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench:asv call", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "asv:stage_1", "ts": 0, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "asv:stage_4", "ts": 400, "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::sw_forward_kernel<4, true>(int const*)", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "sw_walk_kernel(unsigned char const*)", "ts": 150, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 600, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 100},
    ]
    s = summarize(ev)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(250e-6)  # [100, 250] and [600, 700]
    assert s.op_s == pytest.approx({"sw_forward_kernel": 1e-4, "sw_walk_kernel": 1e-4, "Memcpy_HtoD": 1e-4})
    assert s.gap_s == pytest.approx({"asv:stage_1": 250e-6, "asv:stage_4": 400e-6, "bench:asv call": 100e-6})
    assert summarize([e for e in ev if e["cat"] != "user_annotation"]) is None


SAMPLE = {"n_reads": 600, "n_templates": 6, "template_len": 1450, "variant_snps": [4, 6],
          "substitution_rate": 0.015, "insertion_rate": 0.0,
          "deletions": [[0.30, 1, 2], [0.10, 2, 6], [0.02, 50, 50]]}


def read_seqs(fq: Path) -> list[bytes]:
    import gzip

    with gzip.open(fq, "rb") as f:
        return f.read().split(b"\n")[1::4]


def test_sample_shape_is_the_seeds_draws_only(tmp_path):
    """Two seeds: the same counts, lengths and abundance, other draws."""
    a = make_sample(SAMPLE, 1, tmp_path / "a")
    b = make_sample(SAMPLE, 2**31 + 7, tmp_path / "b")
    for s in (a, b):
        assert len(s.templates) == 6 and all(len(t) == 1450 for t in s.templates)
        assert np.bincount(s.read_template).tolist() == [100] * 6
        seqs = read_seqs(s.fastq)
        assert len(seqs) == 600 and all(1450 - 56 <= len(x) <= 1450 for x in seqs)
        for j in range(3):  # a variant differs from its parent by 4-6 SNPs
            assert 4 <= sum(x != y for x, y in zip(s.templates[j], s.templates[j + 3])) <= 6
        # about 1.5% substitutions: the reads without deletions against their templates
        def mismatches(q, t):
            return min(sum(x != y for x, y in zip(q, t)), sum(x != y for x, y in zip(revcomp(q), t)))
        errs = [mismatches(q, s.templates[j]) for q, j in zip(seqs, s.read_template) if len(q) == 1450]
        assert 0.010 < np.mean(errs) / 1450 < 0.020
    assert a.templates != b.templates
    assert make_sample(SAMPLE, 1, tmp_path / "c").templates == a.templates


def test_forbidden_modules_compares_top_level_names_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "savont_tpu", "savont_tpu.ops.align",
             "savont_tpu_torch", "savont_tpu_torch.cli", "jaxtyping", "flaxen", "numpy"]
    assert spec.forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                             "savont_tpu", "savont_tpu.ops.align"]


def test_nothing_the_benchmark_runs_loads_jax():
    code = ("import sys\n"
            "import benchmark.run, benchmark.control, benchmark.refio, benchmark.trace\n"
            "from benchmark.checks import asv, classify, sintax\n"
            "from benchmark.spec import HERE, load_module\n"
            "for f in sorted((HERE / 'databases').glob('*.py')):\n"
            "    load_module('databases', f.stem)\n"
            "import savont_tpu_torch.cli\n"
            "from savont_tpu_torch.pipeline import asv as a, classify as c, sintax as s\n"
            "from savont_tpu_torch.db import registry\n"
            "from benchmark.spec import forbidden_modules\n"
            "print(forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA card here: the run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ont16s.asv",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ont16s.asv",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_split_metric_falls_back_to_its_quantitys_reader():
    """`device_idle_pct.asv` has no file of its own and is read by
    `device_idle_pct.py`; `k3_device_ms.sintax` has one and keeps it."""
    idle = spec.load_module("metrics", "device_idle_pct.asv")
    assert idle.__file__.endswith("device_idle_pct.py")
    assert spec.load_module("metrics", "k3_device_ms.sintax").__file__.endswith("k3_device_ms.sintax.py")
    with pytest.raises(SystemExit):
        spec.load_module("metrics", "no_such_metric.asv")


def test_every_fresh_memo_is_in_the_program():
    """Each traffic's `fresh` names module state the port has, so a memo the
    program renames shows here, not as a cached re-run."""
    from benchmark.run import _resolve

    for path in sorted((spec.HERE / "traffic").glob("*.json")):
        refs = json.loads(path.read_text()).get("fresh", [])
        assert refs, path
        for ref in refs:
            mod, attr = _resolve(ref)
            assert hasattr(mod, attr), ref


def test_asv_dir_from_the_sample_is_what_classify_reads(tmp_path):
    """The classify and sintax input: every template, its read count as its
    depth, in the files and formats the port's classify reads."""
    from benchmark.sample import write_asv_dir
    from savont_tpu_torch.pipeline.classify import read_feature_table

    cfg = json.loads((spec.HERE / "configs" / "ont16s_emu.json").read_text())
    cfg.update(n_reads=100, n_templates=6, template_len=400)
    s = make_sample(cfg, 2**31 + 5, tmp_path / "sample")
    out = write_asv_dir(s, tmp_path / "asv")
    asvs = read_fasta(out / "final_asvs.fasta")
    assert [q for _, q in asvs] == s.templates
    names, per_asv = read_feature_table(out / "feature-table.tsv", [">" + h for h, _ in asvs])
    assert names == ["sample"]
    assert [d[0] for d in per_asv] == np.bincount(s.read_template, minlength=6).tolist()


# the inputs of the configurations at a small size and a fixed seed, as the
# harness wrote them before a database's format could be named: sha256 of each
# file (of a .gz file's contents, since gzip's header carries a time)
DIGEST_SIZES = {"ont16s_emu": ({"n_reads": 300, "n_templates": 6, "db_refs": 200}, "sintax"),
                "operon_ont": ({"n_reads": 100}, "asv")}
DIGEST_SEED = 2**31 + 101
DIGESTS = {
    "ont16s_emu/asv/feature-table.tsv":
        "452eb5db79fe79db3bce951e3b983e38210bc0d84add7cb7416145d5b9537cba",
    "ont16s_emu/asv/final_asvs.fasta":
        "a1dbaa34ad6de9a7cf10a867493cfd81256bd7c11d9bcca51195363be69df8e2",
    "ont16s_emu/db/emu/.savont_db":
        "68134bde8b3b44399bd2268f71bfc0fc0bcbdd3c4819b1a178a2674648adf3ee",
    "ont16s_emu/db/emu/species_taxid.fasta":
        "94383a0a56020eaa6ee0770506ed0131075c001809cd51bceb4453628eb1b202",
    "ont16s_emu/db/emu/taxonomy.tsv":
        "16c0edbdd6eb005002af82888e6e9e0286dd37fb9bae22feb47137de4cd8b995",
    "ont16s_emu/sample/reads.fq.gz":
        "aea85e06f609ff392185d7208c26e49665f4df2f01b739b898d179c878c6eee9",
    "ont16s_emu/sample/templates.fa":
        "c72f4398ca00bdccf6d768ad7f3aa306224d695391aa93bb053724aa5d92b55e",
    "ont16s_emu/warm_db/emu/.savont_db":
        "68134bde8b3b44399bd2268f71bfc0fc0bcbdd3c4819b1a178a2674648adf3ee",
    "ont16s_emu/warm_db/emu/species_taxid.fasta":
        "4cb08d93597d934e4c958b4bdde61725cd83099c5d675fa06241a3cf49e15809",
    "ont16s_emu/warm_db/emu/taxonomy.tsv":
        "a8a132ac155bdc663f3c0fa92325162550141e622829ca314c4f4defe2186153",
    "operon_ont/sample/reads.fq.gz":
        "96c9fe215df0c26142d5f8d41f9f82ffea74331c8bd2747c04c263c874b4beba",
    "operon_ont/sample/templates.fa":
        "34dce3c789803da888eb391fd88163cc1022e0037acd3a73ff2b35778ffe887a",
}


def small_cell(config: str, size: dict, traffic: str, **extra) -> spec.Cell:
    cfg = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())
    cfg.update(size, **extra)
    tr = json.loads((spec.HERE / "traffic" / f"{traffic}.json").read_text())
    return spec.Cell(config, 1, config, cfg, traffic, tr, [], [])


def test_inputs_keep_their_digests(tmp_path):
    """The sample, the ASV directory and the EMU databases (full and warm)
    of both configurations, byte for byte as before."""
    import gzip
    import hashlib

    got = {}
    for config, (size, traffic) in DIGEST_SIZES.items():
        r = Runner(small_cell(config, size, traffic), DIGEST_SEED, "cpu", tmp_path)
        r.prepare()
        for p in sorted(r.work.rglob("*")):
            if p.is_file():
                data = gzip.decompress(p.read_bytes()) if p.suffix == ".gz" else p.read_bytes()
                got[f"{config}/{p.relative_to(r.work)}"] = hashlib.sha256(data).hexdigest()
        r.close()
    assert got == DIGESTS


SILVA = {"n_reads": 120, "n_templates": 6, "db_refs": 400, "db_format": "silva-138.2"}


def silva_records(db: Path) -> list[tuple[str, str, bytes, list[bytes]]]:
    """(accession, path's first level, sequence, its lines) of each FASTA record."""
    import gzip

    silva = spec.load_module("databases", "silva-138.2")
    with gzip.open(db / silva.FASTA, "rb") as f:
        recs = f.read().split(b">")[1:]
    out = []
    for rec in recs:
        head, *lines = rec.rstrip(b"\n").split(b"\n")
        key, path = head.decode().split(" ", 1)
        out.append((key.split(".")[0], path.split(";")[0], b"".join(lines), lines))
    return out


def test_a_silva_configuration_is_found_and_built_from_new_files_alone(tmp_path):
    """A later PR adds a configuration that names `"db_format": "silva-138.2"`
    and a cell of it as new files and entries; the harness builds its
    databases in that format with no edit, the port's registry detects and
    loads them, and the checks' reference reads them."""
    from savont_tpu_torch.db import registry, taxonomy

    from benchmark.checks import taxa

    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench_dir / "configs" / "ont16s_emu.json").read_text())
    cfg.update(SILVA, assumed={"silva": "the writer's shares and lengths (databases/silva-138.2.py)"})
    (bench_dir / "configs" / "ont16s_silva.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ont16s_silva", "source": "x", "reduced": ["db_refs"], "why": "x",
                             "file": "benchmark/configs/ont16s_silva.json"})
    bench["workloads"].append({"name": "silva.sintax", "config": "ont16s_silva", "traffic": "sintax",
                               "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "sintax_s")["workloads"].append("silva.sintax")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("silva.sintax", tmp_path, bench_dir)
    r = Runner(cell, 2**31 + 3, "cpu", tmp_path)
    r.prepare()
    s = r.setup
    for db, n in ((s.db_dir, 400), (s.warm_db_dir, 500)):
        assert registry.read_marker(db) == "silva-138.2"
        loaded = registry.load_database(db)
        assert loaded.extract_key is taxonomy.extract_silva_accession_from_header
        assert len(loaded.taxonomy) == len({a for a, *_ in silva_records(db)})
        assert len(silva_records(db)) == n
    ref = taxa.reference(s)
    for j, (h, _) in enumerate(read_fasta(s.asv_dir / "final_asvs.fasta")):
        g = j % s.sample.n_random
        assert ref.genus_ok[h] == {f"Zymogenus_{g % 8}"}
        assert ref.species_ok[h] == {f"Zymoseed species {g}"}
    r.close()


def test_silva_shape_is_the_seeds_draws_only(tmp_path):
    """Two seeds: the same counts, domains, length floors, accessions with
    several records and shares of IUPAC bytes, other draws; one seed twice:
    the same bytes, whatever order the threads ran in; the RNA alphabet,
    lines of 60 bases, every template a record; the port's loader and the
    plain reader give each record the same genus and species."""
    from savont_tpu_torch.db import taxonomy

    silva = spec.load_module("databases", "silva-138.2")
    cfg = small_cell("ont16s_emu", SILVA, "sintax").config
    shapes, seqs = [], []
    for seed in (5, 2**31 + 9):
        sample = make_sample(cfg, seed, tmp_path / f"s{seed}")
        db = silva.build(sample, 400, np.random.default_rng(seed), tmp_path / f"db{seed}")
        recs = silva_records(db)
        domains = [d for _, d, _, _ in recs]
        floors = {"Bacteria": 1200, "Archaea": 1200, "Eukaryota": 1400}
        assert all(len(q) >= floors[d] for _, d, q, _ in recs)
        assert all(len(x) == 60 for *_, lines in recs for x in lines[:-1])
        assert all(0 < len(lines[-1]) <= 60 for *_, lines in recs)
        letters = set(b"".join(q for _, _, q, _ in recs))
        assert {ord(c) for c in "ACGU"} <= letters <= set(b"ACGUNRYKMSWBDHV")
        dna = [q.replace(b"U", b"T") for _, _, q, _ in recs]
        assert all(t in dna for t in sample.templates)
        copies = sorted(np.unique([a for a, *_ in recs], return_counts=True)[1].tolist())
        shapes.append((len(recs), {d: domains.count(d) for d in floors}, copies,
                       sum(1 for q in dna if set(q) - set(b"ACGT"))))
        seqs.append(dna)
        port = taxonomy.load_silva(db)
        plain = silva.read(db)
        keys = [taxonomy.extract_silva_accession_from_header(f"{a}.1.2") for a, *_ in recs]
        assert [port.taxonomy[k].genus for k in keys] == plain.ranks["genus"]
        assert [port.taxonomy[k].species for k in keys] == plain.ranks["species"]
        assert {"uncultured", "UNKNOWN"} <= set(plain.ranks["genus"])
    assert shapes[0] == shapes[1]
    again = silva.build(sample, 400, np.random.default_rng(seed), tmp_path / "again")
    assert all((again / f).read_bytes() == (db / f).read_bytes() for f in (silva.FASTA, silva.TAXMAP))
    n, domains, copies, iupac = shapes[0]
    assert n == 400 and min(domains.values()) >= 1 and copies[-1] > 1 and iupac == round(0.05 * 394)
    assert seqs[0] != seqs[1]


def test_silva_reader_reads_the_formats_rules(tmp_path):
    """The plain reader on a hand-written directory: the key is the header
    up to its first '.', the last TAXMAP line of an accession wins, a record
    whose accession has no line is skipped, the genus is the path's sixth
    level ("UNKNOWN" past its end), U reads as T, lines are joined."""
    import gzip

    silva = spec.load_module("databases", "silva-138.2")
    with gzip.open(tmp_path / silva.FASTA, "wb") as f:
        f.write(b">AB000001.1.8 Bacteria;P;C;O;F;Genus_a;Org a\nACGU\nUUGG\n"
                b">AB000001.20.27 Bacteria;P;C;O;F;Genus_a;Org a\nGGGGAAAA\n"
                b">CD000002.1.4 Bacteria;P;C;O;F;Genus_c;Org c\nACGU\n"
                b">EF000003.1.4 Archaea;P;C;O;Org e\nUUUU\n")
    (tmp_path / silva.TAXMAP).write_text(
        silva.TAXMAP_HEADER
        + "AB000001\t1\t8\tBacteria;P;C;O;F;Genus_a;\tOrg a\t1\n"
        + "AB000001\t20\t27\tBacteria;P;C;O;F;Genus_b;\tOrg b\t2\n"
        + "EF000003\t1\t4\tArchaea;P;C;O;\tOrg e\t3\n")
    got = silva.read(tmp_path)
    assert got.seqs == [b"ACGTTTGG", b"GGGGAAAA", b"TTTT"]
    assert got.ranks == {"species": ["Org b", "Org b", "Org e"], "genus": ["Genus_b", "Genus_b", "UNKNOWN"]}
