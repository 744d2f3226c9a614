"""The port's routing seam, device selection, jax-free imports, the no-
fallback rule for the CUDA kernels, and the CLI surface."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import savont_tpu.ops.align_batch as host_ab
from savont_tpu_torch.device import resolve_device
from savont_tpu_torch.ops import align_batch as port_ab
from savont_tpu_torch.ops import align_torch, build, traceback_torch

from _torch_jobs import mixed_jobs, rand_seq, substitute

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("env", [None, "jax"])
def test_device_routes_binds_and_restores(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("SAVONT_ALIGN_BACKEND", raising=False)
    else:
        monkeypatch.setenv("SAVONT_ALIGN_BACKEND", env)
    orig = (host_ab.run_jobs, host_ab.run_jobs_nm)
    with port_ab.device_routes("cpu") as dev:
        assert dev == torch.device("cpu")
        assert os.environ["SAVONT_ALIGN_BACKEND"] == "torch"
        for bound, port in ((host_ab.run_jobs, port_ab.run_jobs),
                            (host_ab.run_jobs_nm, port_ab.run_jobs_nm)):
            assert bound.func is port and bound.keywords == {"device": dev}
    assert (host_ab.run_jobs, host_ab.run_jobs_nm) == orig
    assert os.environ.get("SAVONT_ALIGN_BACKEND") == env

    with pytest.raises(KeyError):
        with port_ab.device_routes("cpu"):
            raise KeyError("boom")
    assert (host_ab.run_jobs, host_ab.run_jobs_nm) == orig
    assert os.environ.get("SAVONT_ALIGN_BACKEND") == env


def test_bound_routes_run_the_port():
    """Inside the seam, savont_tpu's align_pairs_nm (host fast path
    stepped aside) reaches the port's NM route and keeps its winners."""
    rng = np.random.default_rng(63)
    pairs = []
    for _ in range(3):
        t = rand_seq(rng, 400)
        pairs.append((bytes(substitute(rng, t, 0.03)), t))
    host = host_ab.align_pairs_nm(pairs, band=48)
    calls = align_torch.REFERENCE_CALLS["sw_forward_nm"]
    with port_ab.device_routes("cpu"):
        port = host_ab.align_pairs_nm(pairs, band=48)
    assert align_torch.REFERENCE_CALLS["sw_forward_nm"] == calls + 1
    assert [(m.score, m.nm, m.target_end) for m in host] == [
        (m.score, m.nm, m.target_end) for m in port
    ]


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    env = os.environ.get("SAVONT_ALIGN_BACKEND")
    with pytest.raises(RuntimeError):
        with port_ab.device_routes("cuda"):
            pass
    assert os.environ.get("SAVONT_ALIGN_BACKEND") == env
    assert not hasattr(host_ab.run_jobs, "func")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import savont_tpu_torch, savont_tpu_torch.cli, savont_tpu_torch.pipeline.asv, "
        "savont_tpu_torch.ops.align_batch\n"
        "print('jax' in sys.modules)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


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
    run = [sys.executable, "-m", "savont_tpu_torch"]
    r = subprocess.run([*run, "asv", "--help"], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout
    r = subprocess.run([*run, "classify", "-i", "x", "-d", "y"], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 2
    assert "not yet ported" in r.stderr


def test_cli_profile_not_ported(tmp_path):
    from savont_tpu_torch.cli import main

    assert main(["--profile", str(tmp_path / "p"), "asv", "x.fq", "--device", "cpu"]) == 2


def test_cli_cuda_without_card_raises(no_card, tmp_path):
    from savont_tpu_torch.cli import main

    fq = tmp_path / "r.fq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["asv", str(fq), "-o", str(tmp_path / "out"), "--device", "cuda"])
    assert not hasattr(host_ab.run_jobs, "func")
