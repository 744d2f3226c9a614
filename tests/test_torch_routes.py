"""The port's device selection, its isolation from jax and savont_tpu, the
no-fallback rule for the CUDA kernels, and the CLI surface."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from savont_tpu_torch.device import resolve_device
from savont_tpu_torch.ops import align_torch, build, traceback_torch

from _torch_jobs import mixed_jobs
from test_stage4_mesh import _workload

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_port_imports_no_jax(tmp_path):
    """A process that imports every module of the port and runs a small
    `asv --device cpu` loads neither jax nor savont_tpu."""
    fq = _workload(tmp_path, n_reads=12)
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import savont_tpu_torch\n"
        "for m in pkgutil.walk_packages(savont_tpu_torch.__path__, 'savont_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from savont_tpu_torch.cli import main\n"
        f"rc = main(['--log-level', 'error', 'asv', {str(fq)!r}, '-o', {str(tmp_path / 'out')!r},"
        " '--device', 'cpu', '-t', '2', '--min-cluster-size', '5'])\n"
        "print(json.dumps([rc, sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'savont_tpu'))]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    rc, loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert rc == 0 and loaded == []
    assert (tmp_path / "out" / "final_asvs.fasta").read_bytes().startswith(b">")


def test_kernels_raise_without_fallback(no_card, monkeypatch, tmp_path):
    """Asking for the kernels where they cannot run raises: building them
    without nvcc, and calling the wrappers for the card without one.  The
    plain versions are not taken instead."""
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_kernels()

    jobs = mixed_jobs(seed=61, band=48, n=2)
    q, t, lo, tl = align_torch.jobs_to_tensors(jobs, "cpu")
    calls = dict(align_torch.REFERENCE_CALLS)
    with pytest.raises(RuntimeError, match="cuda"):
        align_torch.sw_forward(q, t, lo, tl, 48, device="cuda")
    pay, score, ri, bj = align_torch.sw_forward(q, t, lo, tl, 48, emit_payload=True)
    calls["sw_forward_payload"] += 1
    with pytest.raises(RuntimeError, match="cuda"):
        traceback_torch.walk_rle(pay, lo, score, ri, bj, 48, 1024, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        traceback_torch.sw_traceback_jobs(jobs, 48, device="cuda")
    assert align_torch.REFERENCE_CALLS == calls


def test_cli_help_and_unported_subcommands():
    """Every subcommand is ported: each subcommand and flag of the JAX
    package's parser stands in the port's, with the same defaults, plus
    --device on asv, classify and sintax; `--help` of each exits 0."""
    import argparse

    from savont_tpu.cli import build_parser as jax_parser
    from savont_tpu_torch.cli import build_parser

    def surface(p):
        out = {"": {a.dest: a.default for a in p._actions if a.option_strings}}
        sub = next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))
        for name, sp in sub.choices.items():
            out[name] = {(a.dest, tuple(a.option_strings)): a.default for a in sp._actions}
        return out

    want, got = surface(jax_parser()), surface(build_parser())
    assert set(got) == set(want)
    for name, flags in want.items():
        assert flags.items() <= got[name].items(), name
    for name in ("asv", "classify", "sintax"):
        assert got[name][("device", ("--device",))] == "cuda"
    run = [sys.executable, "-m", "savont_tpu_torch"]
    for name in ("asv", "classify", "sintax", "download", "export"):
        r = subprocess.run([*run, name, "--help"], cwd=ROOT, capture_output=True, text=True)
        assert r.returncode == 0 and "not yet ported" not in r.stdout + r.stderr, r.stderr


def test_cli_markdown_help(capsys):
    """--markdown-help (the JAX package's hidden flag) returns 0 and prints
    a markdown section for every subcommand, as the JAX package's does."""
    from savont_tpu.cli import main as jax_main
    from savont_tpu_torch.cli import main

    assert main(["--markdown-help"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# savont-tpu-torch")
    for name in ("asv", "classify", "sintax", "download", "export"):
        assert f"## `savont-tpu-torch {name}`" in out
    assert "--device" in out and "--stage1-backend" in out and "--stage4-backend" not in out
    assert jax_main(["--markdown-help"]) in (0, None)
    want = capsys.readouterr().out
    assert [ln.split()[-1] for ln in out.splitlines() if ln.startswith("## ")] == \
        [ln.split()[-1] for ln in want.splitlines() if ln.startswith("## ")]


def test_cli_profile_not_ported(tmp_path):
    """--profile DIR writes cProfile's profile.pstats and a torch.profiler
    trace around a subcommand (here sintax on the CPU)."""
    import pstats

    from savont_tpu_torch.cli import main

    from _torch_jobs import graded_refs, write_asv_dir, write_emu_db

    refs = graded_refs(seed=95, n_bases=2)
    write_emu_db(tmp_path / "db", refs)
    run = write_asv_dir(tmp_path / "run", [refs[0][4]])
    prof = tmp_path / "prof"
    assert main(["--log-level", "warn", "--profile", str(prof), "sintax", "-i", str(run),
                 "-d", str(tmp_path / "db"), "--n-iter", "5", "--device", "cpu"]) == 0
    stats = pstats.Stats(str(prof / "profile.pstats"))
    assert any(fn[2] == "sintax" for fn in stats.stats)
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (run / "asv_mappings.tsv").read_text().count("\n") == 2


def test_cli_cuda_without_card_raises(no_card, tmp_path):
    from savont_tpu_torch.cli import main

    fq = tmp_path / "r.fq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["asv", str(fq), "-o", str(tmp_path / "out"), "--device", "cuda"])


def test_classify_and_sintax_cuda_without_card_raise(no_card, tmp_path):
    """classify and sintax run on the card by default, and without one they
    raise: the plain versions are not taken instead."""
    from savont_tpu_torch.cli import main

    from _torch_jobs import graded_refs, write_asv_dir, write_emu_db

    refs = graded_refs(seed=96, n_bases=1)
    write_emu_db(tmp_path / "db", refs)
    run = write_asv_dir(tmp_path / "run", [refs[0][4]])
    for argv in (["classify", "-i", str(run), "-d", str(tmp_path / "db")],
                 ["sintax", "-i", str(run), "-d", str(tmp_path / "db"), "--n-iter", "2"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--log-level", "error", *argv])
