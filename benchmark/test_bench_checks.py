"""CPU tests of the checks that decide `correct`: on a tiny sample through
the port's plain versions (`--device cpu`), with classify and sintax against
an EMU-format and a SILVA-format database, a sound run comes out correct,
and the control and each fault the cells can have come out not correct:
a call that leaves its state unchanged (writes nothing), half of the batch
left out, an answer altered where it is produced.  (No cell is on more than
one chip, so no exchange between chips can be left out.)  About 4 minutes.

    python3 -m pytest benchmark/test_bench_checks.py -q
"""
from __future__ import annotations

import gzip
import json
from pathlib import Path

import pytest

import savont_tpu_torch.cli as port_cli
from benchmark.refio import read_fasta
from benchmark.run import Runner, _resolve
from benchmark.spec import HERE, Cell

TINY = {"n_reads": 240, "n_templates": 4, "db_refs": 120}
SEED = 2**31 + 17


def cell_of(traffic: str, db_format: str | None = None) -> Cell:
    cfg = json.loads((HERE / "configs" / "ont16s_emu.json").read_text())
    cfg.update(TINY)
    if db_format:
        cfg["db_format"] = db_format
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    e2e = [{"name": k, "unit": "x"} for k in [*tr["reports"], "setup_s"]]
    return Cell(f"tiny.{traffic}", 1, "tiny", cfg, traffic, tr, e2e, [])


@pytest.fixture(scope="module", params=[("asv", None), ("classify", None), ("sintax", None),
                                        ("classify", "silva-138.2"), ("sintax", "silva-138.2")],
                ids=["asv", "classify", "sintax", "classify-silva", "sintax-silva"])
def runner(request, tmp_path_factory):
    traffic, db_format = request.param
    r = Runner(cell_of(traffic, db_format), SEED, "cpu", tmp_path_factory.mktemp(traffic))
    r.prepare()
    yield r
    r.close()


def run(r: Runner, monkeypatch, main=None) -> dict:
    if main is not None:
        monkeypatch.setattr(port_cli, "main", main)
    res = r.run(0.001, trace=False, on_card=False)  # the warm call, then one call
    monkeypatch.undo()
    return res


def arg_after(argv: list[str], flag: str) -> str:
    return argv[argv.index(flag) + 1]


def half_input(r: Runner, argv: list[str]) -> list[str]:
    """The call's argv on half of its batch: half the reads, or half the ASVs."""
    argv = list(argv)
    if r.traffic["argv"][0] == "asv":
        src = r.setup.sample.fastq
        with gzip.open(src, "rb") as f:
            lines = f.read().split(b"\n")
        n = (len(lines) // 4) // 2
        half = r.work / "half.fq.gz"
        with gzip.open(half, "wb") as f:
            f.write(b"\n".join(lines[: 4 * n]) + b"\n")
        argv[argv.index(str(src))] = str(half)
        return argv
    src = r.setup.asv_dir
    half = r.work / "half_asvs"
    (half / "temp").mkdir(parents=True, exist_ok=True)
    asvs = read_fasta(src / "final_asvs.fasta")[: len(read_fasta(src / "final_asvs.fasta")) // 2]
    keep = {h.split()[0] for h, _ in asvs}
    (half / "final_asvs.fasta").write_text("".join(f">{h}\n{s.decode()}\n" for h, s in asvs))
    rows = (src / "feature-table.tsv").read_text().splitlines()
    (half / "feature-table.tsv").write_text(
        "\n".join([rows[0]] + [x for x in rows[1:] if x.split("\t")[0] in keep]) + "\n")
    argv[argv.index(str(src))] = str(half)
    return argv


def alter_answer(r: Runner, argv: list[str]) -> None:
    """One answer of the call's outputs changed: a base of the first ASV, or
    the taxon of the first ASV's row."""
    out = Path(arg_after(argv, "-o"))
    if r.traffic["argv"][0] == "asv":
        recs = read_fasta(out / "final_asvs.fasta")
        h, s = recs[0]
        recs[0] = (h, s[:700] + {65: b"C"}.get(s[700], b"A") + s[701:])
        (out / "final_asvs.fasta").write_text("".join(f">{h}\n{s.decode()}\n" for h, s in recs))
        return
    lines = (out / "asv_mappings.tsv").read_text().splitlines()
    cols = lines[0].split("\t")
    rank = "species" if r.traffic["argv"][0] == "classify" else "genus"
    row = lines[1].split("\t")
    row[cols.index(rank)] = "Altered taxon"
    lines[1] = "\t".join(row)
    (out / "asv_mappings.tsv").write_text("\n".join(lines) + "\n")


def test_sound_run_is_correct(runner, monkeypatch):
    res = run(runner, monkeypatch)
    assert res["correct"], res["checks"]
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_state_left_unchanged_is_not_correct(runner, monkeypatch):
    res = run(runner, monkeypatch, lambda argv: 0)
    assert not res["correct"]


def test_half_the_batch_left_out_is_not_correct(runner, monkeypatch):
    real = port_cli.main
    res = run(runner, monkeypatch, lambda argv: real(half_input(runner, argv)))
    assert not res["correct"], res["checks"]


def test_an_altered_answer_is_not_correct(runner, monkeypatch):
    real = port_cli.main

    def altered(argv):
        rc = real(argv)
        alter_answer(runner, argv)
        return rc

    res = run(runner, monkeypatch, altered)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(runner):
    out = runner.work / "control"
    runner.check.control(runner.setup, out)
    got = runner.check.judge(out, runner.setup)
    assert any(v > runner.check.LIMITS[k] for k, v in got.items()), got


def test_each_call_starts_without_the_programs_memos(runner, monkeypatch):
    """The warm call and every call of the window find the port's per-input
    memos (the traffic's `fresh`) as a new process has them, and the run
    line gives each call's CPU seconds and page faults."""
    real, seen = port_cli.main, []

    def size(v) -> int:  # a memo's entries, or a number's value; None is empty
        return v if isinstance(v, (int, float)) else len(v or ())

    def spy(argv):
        seen.append([size(getattr(*_resolve(ref))) for ref in runner.traffic["fresh"]])
        return real(argv)

    res = run(runner, monkeypatch, spy)
    assert res["correct"] and len(seen) == 2
    assert all(n == 0 for call in seen for n in call), seen
    host = runner.run_line["call_host"]
    assert all(u + k > 0 for u, k in zip(host["user_s"], host["sys_s"])) and len(host["minflt"]) == 1


def test_untimed_call_runs_against_the_traffics_warm_database(runner, monkeypatch):
    """A traffic with `warm_db_refs` (sintax) makes its untimed call against
    a database of its own; the window's calls use the cell's."""
    real, dbs = port_cli.main, []

    def spy(argv):
        dbs.append(arg_after(argv, "-d") if "-d" in argv else None)
        return real(argv)

    assert run(runner, monkeypatch, spy)["correct"]
    s = runner.setup
    if "warm_db_refs" in runner.traffic:
        assert dbs == [str(s.warm_db_dir), str(s.db_dir)] and s.warm_db_dir != s.db_dir
    else:
        assert s.warm_db_dir is None and dbs == [None if s.db_dir is None else str(s.db_dir)] * 2
