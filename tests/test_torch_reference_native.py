"""steady_reference_native (tests/_torch_jobs.py): the port's comparisons run
against savont_tpu's native host paths, never quietly against its NumPy
fallback, even where another test process is writing a library of
savont_tpu's in native/ at the same moment.

The race is simulated in a temporary directory with a copy of a real
library: a file cut short, then the whole file from another writer."""
import re
import threading
import time
from pathlib import Path

import pytest

import savont_tpu.ops.native_build as nb
import savont_tpu.pipeline.pileup as ref_pileup

import _torch_jobs
from _torch_jobs import ROOT, steady_reference_native, whole_library


@pytest.fixture(scope="module")
def real_library() -> bytes:
    steady_reference_native(["swalign"])
    return (ROOT / "native" / "swalign.so").read_bytes()


def _cut_short(tmp_path: Path, data: bytes) -> tuple[Path, Path]:
    src, so = tmp_path / "lib.cpp", tmp_path / "lib.so"
    src.write_text("// source\n")
    so.write_bytes(data[: len(data) // 3])
    return src, so


def test_waits_for_the_writer_of_a_library_cut_short(tmp_path, real_library):
    """A library cut short, which another process then writes whole: the
    helper waits for it, loads it and builds nothing."""
    src, so = _cut_short(tmp_path, real_library)

    def writer():
        time.sleep(0.6)
        tmp = so.with_suffix(".tmp")
        tmp.write_bytes(real_library)
        tmp.replace(so)

    def build(_out):
        raise AssertionError("built though another process was writing the library")

    t = threading.Thread(target=writer)
    t.start()
    try:
        whole_library(src, so, build, settle=0.1, patience=5.0, deadline=30.0)
    finally:
        t.join()
    assert so.read_bytes() == real_library
    assert _torch_jobs._loads(so)


def test_builds_a_library_left_cut_short(tmp_path, real_library):
    """A library cut short that nobody finishes: after its patience the
    helper builds it anew, and then it loads."""
    src, so = _cut_short(tmp_path, real_library)
    built = []

    def build(out):
        built.append(out)
        out.write_bytes(real_library)

    whole_library(src, so, build, settle=0.1, patience=0.3, deadline=30.0)
    assert built == [so] and _torch_jobs._loads(so)


def test_clears_a_failed_load_in_the_reference(monkeypatch):
    """A process in which savont_tpu once failed to load its libraries (its
    _TRIED set with no library, build_extra's None cached) loads them again
    through its own loaders."""
    monkeypatch.setattr(nb, "_LIB", None)
    monkeypatch.setattr(nb, "_TRIED", True)
    monkeypatch.setattr(nb, "_EXTRA_CACHE", {"pileup": None})
    monkeypatch.setattr(ref_pileup, "_PILEUP_LIB", None)
    monkeypatch.setattr(ref_pileup, "_PILEUP_TRIED", True)
    assert nb.get_lib() is None and ref_pileup._get_pileup_lib() is None
    steady_reference_native()
    assert nb.get_lib() is not None and ref_pileup._get_pileup_lib() is not None
    assert nb._EXTRA_CACHE["pileup"] == ROOT / "native" / "pileup.so"


def test_raises_where_the_reference_would_fall_back(monkeypatch):
    monkeypatch.setenv("SAVONT_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="NumPy fallback"):
        steady_reference_native()


def test_flags_cover_every_library_of_the_reference():
    """Every library savont_tpu builds in native/ is in the helper's table,
    with the flags its caller passes."""
    names = {"swalign"}
    calls = {}
    for path in (ROOT / "savont_tpu").rglob("*.py"):
        for m in re.finditer(r'build_extra\(\s*"(\w+)"(.*?)\)\n', path.read_text(), re.S):
            names.add(m.group(1))
            calls[m.group(1)] = m.group(2)
    flags = _torch_jobs.reference_native_flags()
    assert set(flags) == names
    for name, rest in calls.items():
        link = re.search(r"extra_link=\[([^\]]*)\]", rest)
        want = [s.strip().strip('"') for s in link.group(1).split(",")] if link else []
        assert flags[name][1] == want, name
    assert (ROOT / "native" / "swalign.cpp").is_file()
