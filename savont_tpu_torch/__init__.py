"""savont-tpu-torch: the PyTorch + CUDA port of savont-tpu for NVIDIA Hopper.

A package of its own beside the JAX package `savont_tpu`, which stays the
reference: it imports torch, never jax, and nothing of `savont_tpu`.

- `pipeline/`, `core.py`, `io/`, `config.py`, `validate.py` and the host
  `ops/` modules are the `asv` pipeline (fastq -> ASVs), the port's own
  copies of the reference's host layer; `native/*.cpp` are its host C++
  libraries, built with g++ at first use (`ops/native_build.py`);
- `ops/csrc/*.cu`       hand-written CUDA kernels for sm_90a (built with nvcc
                        at first use, loaded with ctypes: `ops/build.py`);
- `ops/align_torch.py`  banded Smith-Waterman forward (kernel 1) beside its
                        plain PyTorch version;
- `ops/traceback_torch.py` traceback walk + CIGAR run-length encoding
                        (kernel 2) beside its plain PyTorch version;
- `ops/align_batch.py`  the planner, the DP routes on the chosen device and
                        their consumers; `ops/host_dp.py` is the host oracle
                        they are held against;
- `probes/roofline.py`  the integer max/add roofline probe of the card;
- `cli.py`              `python -m savont_tpu_torch asv ... --device cuda`.
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Stop glibc from mmap/munmap-ing every large numpy temporary.

    The pipeline allocates and frees many >128 KB arrays (k-mer streams,
    DP planes, pileup matrices); with glibc defaults each one is a fresh
    mmap, so the kernel spends significant time zeroing pages (measured:
    16.3s sys -> 3.7s sys, -24% wall on a 20k-read run).  Raising the
    mmap/trim thresholds keeps freed blocks on the heap for reuse, at the
    cost of a higher steady-state RSS.

    M_ARENA_MAX=1 matters just as much on VMs where minor faults are
    expensive (nested-EPT: ~10-40 us each, measured): glibc returns freed
    per-THREAD-arena heaps to the OS unconditionally (heap_trim is not
    gated by M_TRIM_THRESHOLD), so every numpy temporary allocated inside
    a worker thread refaults its pages on the next use.  One arena makes
    the trim threshold govern all frees.  Measured interleaved A/B at
    100k reads: minor faults 1.8M -> 1.0M, sys 25.6s -> 11.7s, wall
    40.9s -> 31.7s (min of 3).  SAVONT_NO_MALLOC_TUNE=1 opts out."""
    import ctypes
    import os
    import sys

    if os.environ.get("SAVONT_NO_MALLOC_TUNE") or not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_ARENA_MAX = -1, -3, -8
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
        libc.mallopt(M_ARENA_MAX, 1)
    except OSError:  # non-glibc libc
        pass


def _disable_numpy_hugepage_madvise() -> None:
    """Keep numpy from madvise(MADV_HUGEPAGE)-ing large buffers.

    With THP in madvise mode, every >4 MB numpy allocation invites
    synchronous hugepage compaction on first touch; the pipeline's large
    transient buffers (k-mer streams, DP planes) then burn kernel time
    assembling 2 MB pages that are freed moments later.  Measured on a
    20k-read run: 9-20s sys -> 1.2s, wall 24s -> 18.5s.  numpy reads the
    NUMPY_MADVISE_HUGEPAGE env var only at import (a sitecustomize may
    import numpy before us), so use the runtime hook.
    SAVONT_NO_MALLOC_TUNE=1 opts out."""
    import os

    if os.environ.get("SAVONT_NO_MALLOC_TUNE"):
        return
    try:
        from numpy._core import multiarray

        multiarray._set_madvise_hugepage(False)
    except (ImportError, AttributeError):
        pass


def _tune_omp_wait_policy() -> None:
    """Default OMP_WAIT_POLICY=passive for the native kernels.

    GOMP's default active spin keeps worker threads burning cycles after
    every parallel region; this pipeline interleaves many short native
    regions (scans, chaining, DP) with numpy glue and a plan/DP pipeline
    thread, so the spinners contend with real work on small core counts.
    Measured interleaved A/B at 100k reads: wall 22.2/23.9 -> 21.8/23.0,
    cpu 51.4/54.2 -> 47.7/50.7.  Must run before libgomp's first parallel
    region (we set it at package import, before any native .so loads).
    Respects an explicit user OMP_WAIT_POLICY; SAVONT_NO_OMP_TUNE=1 opts
    out."""
    import os

    if os.environ.get("SAVONT_NO_OMP_TUNE"):
        return
    os.environ.setdefault("OMP_WAIT_POLICY", "passive")


_tune_malloc()
_disable_numpy_hugepage_madvise()
_tune_omp_wait_policy()
