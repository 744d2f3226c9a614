"""Build + load the port's CUDA kernels (ops/csrc/*.cu) via nvcc and ctypes.

Compiled at first use into build/savont_tpu_torch/ at the repo root: one
nvcc per source, all started together, then one link into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
cached by a hash of the sources and flags.  The build takes a file lock a
library, so processes started together (the ranks of a process group, test
workers) compile it once.  A missing nvcc or a failed
build raises with nvcc's stderr: there is no fallback to the plain PyTorch
versions on the card.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "savont_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# nvcc's stderr (ptxas register / spill report) and wall seconds of the
# last build in this process; 0.0 when the library came from the cache
BUILD_INFO = {"log": "", "seconds": 0.0, "path": ""}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sw_forward_launch.restype = i
    lib.sw_forward_launch.argtypes = [
        p, p, p, p,            # q, t, lo, tlens
        i, i, i, i,            # B, Lq, Lt, band
        i, i, i, i,            # match, mismatch, gap_open, gap_ext
        i, p, p, p,            # emit_payload, out, payload, stream
    ]
    lib.sw_walk_launch.restype = i
    lib.sw_walk_launch.argtypes = [
        p, p, p, p, p,         # payload, lo, score, ri, bj
        i, i, i, i, i,         # B, Lq, band, ops_max, maxrun
        p, p, p,               # cigar, meta, stream
    ]
    lib.sw_walk_warp_bytes.restype = i
    lib.sw_walk_warp_bytes.argtypes = [i, i, i]  # band, ops_max, maxrun
    lib.roofline_launch.restype = i
    lib.roofline_launch.argtypes = [
        i, p, p, p,            # kind, x0, y0, out
        i, i, i, p,            # n, iters, threads, stream
    ]
    lib.probe_bitcast_launch.restype = i
    lib.probe_bitcast_launch.argtypes = [p, p, i, p]  # x, out, tiles, stream
    lib.probe_i16ops_launch.restype = i
    lib.probe_i16ops_launch.argtypes = [
        i, p, p, p, p,         # op, x, y, z, out
        i, i, i, p,            # n, iters, threads, stream
    ]
    lib.probe_roll_launch.restype = i
    lib.probe_roll_launch.argtypes = [i, i, p, p, i, i, p]  # mode, k, x, out, tiles, steps, stream
    lib.sintax_scores_launch.restype = i
    lib.sintax_scores_launch.argtypes = [
        p, i, p, p, i,         # keys, D, off, pairs, P
        p, p, p, i,            # kmers, row_off, ridx, R
        p, p,                  # acc, stream
    ]
    lib.sintax_ref_kmers_launch.restype = i
    lib.sintax_ref_kmers_launch.argtypes = [
        p, ctypes.c_longlong,  # seqs, B
        p, p, i, i,            # off, row_off, R, max_n
        p, p,                  # kmers, stream
    ]
    lib.sintax_ref_kmers_smem_cap.restype = i
    lib.sintax_ref_kmers_smem_cap.argtypes = []
    lib.split_kmers_launch.restype = i
    lib.split_kmers_launch.argtypes = [
        p, p, p, p,            # codes, phred, off, out_off
        i, i, i,               # N, k, min_bq
        p, p, p,               # keys, valid, stream
    ]
    lib.syncmers_launch.restype = i
    lib.syncmers_launch.argtypes = [
        p, p, p,               # codes, off, out_off
        i, i, i,               # N, k, s
        p, p, p,               # flags, kmers, stream
    ]


def _compile(srcs: list[Path], so: Path) -> str:
    """nvcc -c for every source at once, then link `so` through a temporary
    name.  Returns nvcc's stderr (ptxas reports); raises on a failure."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, o in zip(srcs, objs)
    ]
    logs = [pr.communicate()[1] for pr in procs]  # wait for every one
    for s, pr, err in zip(srcs, procs, logs):
        if pr.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name} (exit {pr.returncode}):\n{err}")
    tmp = so.with_name(f"{tag}.tmp")
    r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                       capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    return "".join(logs)


def build_kernels() -> ctypes.CDLL:
    """Return the loaded kernel library, compiling it first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sorted(_CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        so = BUILD_DIR / f"libsavont_kernels_{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / f"{so.stem}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
                if not so.exists():  # else another process built it meanwhile
                    t0 = time.perf_counter()
                    log = _compile(srcs, so)
                    BUILD_INFO.update(log=log, seconds=time.perf_counter() - t0)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        BUILD_INFO["path"] = str(so)
        _LIB = lib
        return lib
