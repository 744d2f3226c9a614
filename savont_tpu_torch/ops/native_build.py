"""Build + load the port's host C++ libraries (native/*.cpp) via g++ and ctypes.

Each source is compiled at first use with g++ -O3 -march=native into
build/savont_tpu_torch/native/ at the repo root, named by a hash of the
source, the flags and the host CPU, so a tree builds each library once and
later runs and processes reuse it.  A build writes a temporary file and
renames it into place, under a per-library file lock: concurrent processes
(test workers) never load a half-written library and never build one twice.
If no compiler is available the NumPy paths are used instead.

The libraries are the host side of the pipeline (fastq parsing, k-mer
scans, sorting, pileups) and the banded-SW oracle (swalign) that the tests
and chip_smoke.py hold the CUDA kernels against; a run with a card never
takes the oracle for its DP.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

log = logging.getLogger("savont")

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "savont_tpu_torch" / "native"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _vector_width_flags() -> list[str]:
    """-mprefer-vector-width=512 where the CPU has AVX-512BW: the int16
    lane-block kernels (PBLK=32) measure ~7% faster with full-width
    vectors there, while gcc's default prefers 256-bit."""
    return ["-mprefer-vector-width=512"] if "avx512bw" in _cpu_flags() else []


def _cpu_flags() -> str:
    """The host CPU's feature line: -march=native code is only valid on a
    CPU with the same features, so it is part of a library's name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine()


_EXTRA_CACHE: dict[str, Path | None] = {}


def _build(name: str, cflags: list[str], ldflags: list[str]) -> Path | None:
    """Compile native/<name>.cpp unless a library of the same source, flags
    and CPU exists; returns its path, or None when the build failed."""
    src = NATIVE_SRC / f"{name}.cpp"
    if not src.exists():
        return None
    h = hashlib.sha256(" ".join([*cflags, "|", *ldflags]).encode())
    h.update(_cpu_flags().encode())
    h.update(src.read_bytes())
    so = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *cflags, str(src), "-o", str(tmp), *ldflags]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (FileNotFoundError, subprocess.TimeoutExpired):
            return None
        if r.returncode != 0:
            log.warning("native build of %s failed: %s", name, r.stderr[-500:])
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, so)
    return so


def build_extra(
    name: str, extra_link: list[str] | None = None,
    extra_cflags: list[str] | None = None,
) -> Path | None:
    """Build native/<name>.cpp (once per process); returns the path or None."""
    with _LOCK:
        if name not in _EXTRA_CACHE:
            cflags = [
                "-O3", "-march=native", *_vector_width_flags(),
                *(extra_cflags or []), "-shared", "-fPIC",
            ]
            _EXTRA_CACHE[name] = _build(name, cflags, list(extra_link or []))
        return _EXTRA_CACHE[name]


def get_lib():
    """Return the loaded banded-SW oracle (native/swalign.cpp) or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    so = build_extra("swalign", extra_link=["-fopenmp"])
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.warning("failed to load native kernel: %s", e)
            return None
        lib.sw_banded_batch.restype = None
        lib.sw_banded_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.sw_tb_batch.restype = None
        lib.sw_tb_batch.argtypes = lib.sw_banded_batch.argtypes
        lib.sw_nm_batch.restype = None
        lib.sw_nm_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        _LIB = lib
        log.info("native banded-SW kernel loaded (%s)", so.name)
        return _LIB
