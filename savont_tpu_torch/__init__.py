"""savont-tpu-torch: the PyTorch + CUDA port of savont-tpu for NVIDIA Hopper.

The JAX package `savont_tpu` stays the reference.  This package shares its
host layer by import (stages 1-3, the seeding and chaining planner,
`AlignJob`, the native C++ kernels, I/O, validation) and owns only what
touches the device:

- `ops/csrc/*.cu`      hand-written CUDA kernels for sm_90a (built with nvcc
                       at first use, loaded with ctypes: `ops/build.py`);
- `ops/align_torch.py` banded Smith-Waterman forward (kernel 1) beside its
                       plain PyTorch version;
- `ops/traceback_torch.py` traceback walk + CIGAR run-length encoding
                       (kernel 2) beside its plain PyTorch version;
- `ops/align_batch.py` the port's `run_jobs` / `run_jobs_nm` and the routing
                       seam (`device_routes`) that points `savont_tpu` at them;
- `pipeline/asv.py`, `cli.py` the `asv` entry point.

This package imports torch and never jax.
"""
import savont_tpu  # noqa: F401  host-side process tuning (malloc, OMP wait policy)

__version__ = savont_tpu.__version__
