"""The port's alignment routes and the seam that points savont_tpu at them.

`run_jobs` and `run_jobs_nm` keep the signatures and result contracts of
savont_tpu.ops.align_batch.run_jobs / run_jobs_nm, and run every job on the
port's device: kernel 1 (payload mode) + kernel 2 for CIGARs, kernel 1 (NM
mode) for NM-only scoring.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from functools import partial

from savont_tpu.ops import align_batch as _host
from savont_tpu.ops.align import resolve_band

from ..device import resolve_device
from .align_torch import sw_forward_jobs
from .traceback_torch import sw_traceback_jobs


def run_jobs(jobs, band: int | None = None, *, device) -> list[tuple | None]:
    """Per job (score, q0, q1, t0, t1, cigar_u32, nm) or None, as host
    run_jobs returns them (stage 4-6 CIGAR consumers)."""
    band = resolve_band(band)
    if not jobs:
        return []
    return sw_traceback_jobs(jobs, band, device=device)


def run_jobs_nm(jobs, band: int | None = None, *, device) -> list[tuple | None]:
    """Per job (score, 0, q_end, 0, t_end, [], nm) or None: the starts are 0,
    as in the Pallas NM route this replaces (stage 7 reads only nm)."""
    band = resolve_band(band)
    if not jobs:
        return []
    return sw_forward_jobs(jobs, band, device)


@contextmanager
def device_routes(device):
    """Route savont_tpu's DP through the port for the length of one run.

    This is the only place the port reaches into savont_tpu, and it changes
    no file of it.  Every DP call on the asv main path ends in
    savont_tpu.ops.align_batch.run_jobs or run_jobs_nm, looked up as module
    globals at call time, and the host struct-of-arrays fast paths step
    aside whenever SAVONT_ALIGN_BACKEND is non-empty.  So the seam does
    three things, and undoes all three on exit, even on an exception:

    1. sets SAVONT_ALIGN_BACKEND=torch (savont_tpu recognises neither
       "jax" nor "pallas" in it, so no jax path is taken);
    2. binds savont_tpu.ops.align_batch.run_jobs and run_jobs_nm to this
       module's versions;
    3. sets the port's device on them (`device` is resolved first:
       "cuda" raises when no card is visible).
    """
    dev = resolve_device(device)
    saved = (os.environ.get("SAVONT_ALIGN_BACKEND"), _host.run_jobs, _host.run_jobs_nm)
    os.environ["SAVONT_ALIGN_BACKEND"] = "torch"
    _host.run_jobs = partial(run_jobs, device=dev)
    _host.run_jobs_nm = partial(run_jobs_nm, device=dev)
    try:
        yield dev
    finally:
        env, _host.run_jobs, _host.run_jobs_nm = saved
        if env is None:
            os.environ.pop("SAVONT_ALIGN_BACKEND", None)
        else:
            os.environ["SAVONT_ALIGN_BACKEND"] = env
