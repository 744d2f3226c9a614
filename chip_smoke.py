#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (savont_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure; nothing catches it, so the exit code is
non-zero):
  1. device   - require a CUDA card; print its name, the torch / CUDA
                versions, nvidia-smi's name and power limit, and whether the
                host C++ oracle (native/swalign.cpp) loaded;
  2. build    - compile savont_tpu_torch/ops/csrc/*.cu with nvcc;
  3. kernels  - seed-pinned planner jobs on random ~1,450 bp templates
                (substitutions, 1-6 bp and 40-60 bp deletions, both
                strands): >= 2,048 pairs at band 48 and a band-128 batch.
                Kernel 1 (NM and payload modes) and kernel 2 must equal their
                plain PyTorch versions on the card exactly (tolerance 0, all
                outputs are integers), and the port's job routes must equal
                the host oracle (savont_tpu's run_jobs / run_jobs_nm on the
                host path), CIGARs included;
  4. main path - a seed-pinned 5,000-read fastq through
                `savont_tpu_torch.cli.main(["asv", ..., "--device", "cuda"])`
                (what `python -m savont_tpu_torch` runs) and through
                savont_tpu's host run_cluster: outputs byte-identical, every
                ASV at NM=0 against the templates, every kernel launched and
                no plain version called during the card run.
The last three lines of stdout are nvidia-smi's name / power limit, the
kernels JSON, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BAND = 48
OPERON_BAND = 128
N_PAIRS_MIN = 2048
N_READS = 5000
TEMPLATE_LEN = 1450
SEED = 2026


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls (after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mutate(rng, seq: bytes, kind: int) -> bytes:
    """1.5% substitutions plus, by kind: 0 none, 1 one 1-6 bp deletion,
    2 one 40-60 bp deletion, 3 three 1-6 bp deletions."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    b = np.frombuffer(seq, dtype=np.uint8).copy()
    nsub = rng.binomial(len(b), 0.015)
    pos = rng.choice(len(b), nsub, replace=False)
    b[pos] = bases[(np.searchsorted(bases, b[pos]) + rng.integers(1, 4, nsub)) % 4]
    s = b.tobytes()
    cuts = {0: [], 1: [(1, 6)], 2: [(40, 60)], 3: [(1, 6)] * 3}[kind]
    for lo_len, hi_len in cuts:
        p = int(rng.integers(100, len(s) - 160))
        s = s[:p] + s[p + int(rng.integers(lo_len, hi_len + 1)):]
    return s


def make_jobs(rng, n_templates: int, reads_per: int, band: int):
    import numpy as np

    from savont_tpu.ops.align import TargetIndex
    from savont_tpu.ops.align_batch import plan_jobs
    from savont_tpu.ops.encode import revcomp_bytes

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    jobs = []
    for _ in range(n_templates):
        t = rng.choice(bases, TEMPLATE_LEN).tobytes()
        idx = TargetIndex([t])
        for k in range(reads_per):
            q = mutate(rng, t, k % 4)
            if (k // 4) % 2:
                q = revcomp_bytes(q)
            jobs.extend(plan_jobs(idx, q, band=band, min_anchors=2))
    return jobs


def max_jump(job) -> int:
    import numpy as np

    return int(np.diff(job.lo).max()) if len(job.lo) > 1 else 0


def max_abs_diff(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in pairs)


def check_kernels(jobs, band: int, timed: bool) -> dict:
    """Kernels against their plain versions on the card, and the port's job
    routes against the host oracle.  Returns per-kernel error and times."""
    import numpy as np
    import torch

    from savont_tpu.ops.align_batch import run_jobs, run_jobs_nm
    from savont_tpu_torch.ops.align_torch import (
        jobs_to_tensors, sw_forward, sw_forward_jobs, sw_forward_reference,
    )
    from savont_tpu_torch.ops.traceback_torch import (
        sw_traceback_jobs, walk_rle, walk_rle_reference,
    )

    order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
    sjobs = [jobs[i] for i in order]
    q, t, lo, tl = jobs_to_tensors(sjobs, "cuda")
    B = q.shape[0]
    ops_max = q.shape[1] + t.shape[1]
    res = {}

    nm_k = sw_forward(q, t, lo, tl, band)
    nm_r = sw_forward_reference(q, t, lo, tl, band)
    torch.cuda.synchronize()
    res["sw_forward_nm"] = {"max_abs_err": max_abs_diff([(nm_k, nm_r)])}

    pay_k = sw_forward(q, t, lo, tl, band, emit_payload=True)
    pay_r = sw_forward_reference(q, t, lo, tl, band, emit_payload=True)
    torch.cuda.synchronize()
    res["sw_forward_payload"] = {"max_abs_err": max_abs_diff(zip(pay_k, pay_r))}

    payload, score, ri, bj = pay_k
    walk_k = walk_rle(payload, lo, score, ri, bj, band, ops_max)
    walk_r = walk_rle_reference(payload, lo, score, ri, bj, band, ops_max)
    torch.cuda.synchronize()
    res["sw_walk"] = {"max_abs_err": max_abs_diff(zip(walk_k, walk_r))}
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} differs from its plain version at band {band}: {r}")

    if timed:
        per = {
            "sw_forward_nm": (lambda: sw_forward(q, t, lo, tl, band),
                              lambda: sw_forward_reference(q, t, lo, tl, band)),
            "sw_forward_payload": (
                lambda: sw_forward(q, t, lo, tl, band, emit_payload=True),
                lambda: sw_forward_reference(q, t, lo, tl, band, emit_payload=True)),
            "sw_walk": (
                lambda: walk_rle(payload, lo, score, ri, bj, band, ops_max),
                lambda: walk_rle_reference(payload, lo, score, ri, bj, band, ops_max)),
        }
        for name, (kern, plain) in per.items():
            # plain, kernel, kernel, plain: the two orders of one pair
            p1 = cuda_ms(plain, 1)
            k1 = cuda_ms(kern, 5)
            k2 = cuda_ms(kern, 5)
            p2 = cuda_ms(plain, 1)
            res[name].update(ms=min(k1, k2), plain_ms=min(p1, p2), ms_all=[k1, k2], plain_ms_all=[p1, p2])
            log(f"  {name}: kernel {min(k1, k2):.3f} ms ({1e3 * min(k1, k2) / B:.3f} us/pair), "
                f"plain {min(p1, p2):.1f} ms ({1e3 * min(p1, p2) / B:.1f} us/pair), "
                f"{B} pairs, Lq {q.shape[1]}, band {band}")

    # the port's job routes (kernel 1 + kernel 2 on the card) against the
    # host oracle, outside any routing seam
    host_nm = run_jobs_nm(jobs, band=band)
    host_tb = run_jobs(jobs, band=band)
    port_nm = sw_forward_jobs(jobs, band, "cuda")
    port_tb = sw_traceback_jobs(jobs, band, device="cuda")
    for i, (h, p) in enumerate(zip(host_nm, port_nm)):
        hk = None if h is None else (h[0], h[2], h[4], h[6])
        pk = None if p is None else (p[0], p[2], p[4], p[6])
        if hk != pk:
            raise AssertionError(f"NM route job {i}: host {hk} port {pk}")
    for i, (h, p) in enumerate(zip(host_tb, port_tb)):
        same = (h is None and p is None) or (
            h is not None and p is not None and h[:5] == p[:5] and h[6] == p[6]
            and np.array_equal(np.asarray(h[5], np.uint32), np.asarray(p[5], np.uint32))
        )
        if not same:
            raise AssertionError(f"traceback route job {i}: host {h} port {p}")
    n_aligned = sum(h is not None for h in host_tb)
    log(f"  band {band}: {len(jobs)} pairs ({n_aligned} aligned), "
        f"{sum(max_jump(j) > 2 for j in jobs)} with band jumps > 2, "
        f"{sum(max_jump(j) == 2 for j in jobs)} with max advance 2: kernels == plain, "
        f"routes == host oracle (exact)")
    return res


def write_reads(path: Path, tpl_path: Path, rng) -> None:
    """5,000 ONT-like reads from 10 templates (5 random, 5 variants with 4-6
    SNPs): 1.5% substitutions each, 30% with a 1-2 bp deletion, 10% with a
    2-6 bp deletion, 2% with a 50 bp deletion, half reverse-complemented."""
    import numpy as np

    from savont_tpu.ops.encode import revcomp_bytes

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    templates = []
    for _ in range(5):
        templates.append(rng.choice(bases, TEMPLATE_LEN).tobytes())
    for base in list(templates):
        v = np.frombuffer(base, dtype=np.uint8).copy()
        pos = rng.choice(np.arange(60, TEMPLATE_LEN - 60), int(rng.integers(4, 7)), replace=False)
        v[pos] = bases[(np.searchsorted(bases, v[pos]) + rng.integers(1, 4, len(pos))) % 4]
        templates.append(v.tobytes())
    with open(tpl_path, "w") as f:
        for i, t in enumerate(templates):
            f.write(f">template{i}\n{t.decode()}\n")
    with gzip.open(path, "wt") as out:
        for i in range(N_READS):
            ti = i % len(templates)
            b = np.frombuffer(templates[ti], dtype=np.uint8).copy()
            nsub = rng.binomial(len(b), 0.015)
            pos = rng.choice(len(b), nsub, replace=False)
            b[pos] = bases[(np.searchsorted(bases, b[pos]) + rng.integers(1, 4, nsub)) % 4]
            s = b.tobytes()
            for frac, lo_len, hi_len in ((0.30, 1, 2), (0.10, 2, 6), (0.02, 50, 50)):
                if rng.random() < frac:
                    p = int(rng.integers(100, len(s) - 160))
                    s = s[:p] + s[p + int(rng.integers(lo_len, hi_len + 1)):]
            if rng.random() < 0.5:
                s = revcomp_bytes(s)
            out.write(f"@t{ti}_r{i}\n{s.decode()}\n+\n{'I' * len(s)}\n")


def main_path(work: Path, rng) -> dict:
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline import stage1_kmers
    from savont_tpu.pipeline.asv import run_cluster
    from savont_tpu.validate import validate_asvs
    from savont_tpu_torch import cli
    from savont_tpu_torch.ops.align_torch import LAUNCHES, REFERENCE_CALLS, reset_counters

    fq = work / "reads.fq.gz"
    tpl = work / "templates.fa"
    write_reads(fq, tpl, rng)

    # one untimed host run first: the first use of each host C++ kernel in
    # a process compiles it with g++, which would otherwise be timed
    for tag in ("host_warmup", "host"):
        stage1_kmers._READ_CACHE.clear()
        t0 = time.perf_counter()
        run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(work / tag), threads=4))
        host_s = time.perf_counter() - t0

    # wall seconds spent inside the port's DP routes (packing, kernels,
    # copies back to the host): what the card path costs of the whole run
    from savont_tpu_torch.ops import align_batch as port_ab

    routes = (port_ab.run_jobs, port_ab.run_jobs_nm)
    dp_s = [0.0]

    def timed(fn):
        def run(jobs, band=None, **kw):
            t = time.perf_counter()
            try:
                return fn(jobs, band, **kw)
            finally:
                dp_s[0] += time.perf_counter() - t
        return run

    port_ab.run_jobs, port_ab.run_jobs_nm = (timed(f) for f in routes)
    stage1_kmers._READ_CACHE.clear()
    reset_counters()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["asv", str(fq), "-o", str(work / "port"), "--device", "cuda", "-t", "4"])
    finally:
        port_s = time.perf_counter() - t0
        port_ab.run_jobs, port_ab.run_jobs_nm = routes
    launches, ref_calls = dict(LAUNCHES), dict(REFERENCE_CALLS)
    if rc != 0:
        raise AssertionError(f"savont_tpu_torch asv exited {rc}")

    for rel in ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv"):
        a = (work / "host" / rel).read_bytes()
        b = (work / "port" / rel).read_bytes()
        if a != b:
            raise AssertionError(f"{rel} differs between the host run and the card run")
    val = validate_asvs(str(work / "port" / "final_asvs.fasta"), str(tpl))
    if not val or any(v.nm != 0 for v in val):
        raise AssertionError(f"ASVs not all NM=0 against the templates: {val}")
    for k in ("sw_forward_nm", "sw_forward_payload", "sw_walk"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path: {launches}")
    if any(ref_calls.values()):
        raise AssertionError(f"plain versions ran during the card run: {ref_calls}")
    log(f"main path: {N_READS} reads, {len(val)} ASVs all NM=0, outputs byte-identical; "
        f"host run_cluster {host_s:.2f} s (after a warm-up run), savont_tpu_torch asv "
        f"--device cuda {port_s:.2f} s (wall, kernel build excluded; {dp_s[0]:.2f} s of it "
        f"inside the port's DP routes); "
        f"launches {launches}; plain calls {ref_calls}")
    return {"launches": launches, "host_s": host_s, "port_s": port_s, "n_asvs": len(val)}


def main() -> int:
    if not (ROOT / "savont_tpu_torch").is_dir() or not (ROOT / "savont_tpu").is_dir():
        print("chip_smoke.py must run from a checkout of the repo "
              "(savont_tpu_torch/ and savont_tpu/ beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    os.environ.pop("SAVONT_ALIGN_BACKEND", None)  # the oracle is the host path
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    from savont_tpu.ops.native_build import get_lib

    log(f"host C++ oracle (native/swalign.cpp) loaded: {get_lib() is not None}")

    # phase 2: build
    from savont_tpu_torch.ops.build import BUILD_INFO, build_kernels

    t0 = time.perf_counter()
    build_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s ({BUILD_INFO['path']})")
    for line in BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 3: kernels against their plain versions and the host oracle
    rng = np.random.default_rng(SEED)
    jobs = make_jobs(rng, n_templates=48, reads_per=48, band=BAND)
    if len(jobs) < N_PAIRS_MIN or not any(max_jump(j) > 2 for j in jobs):
        raise AssertionError(f"job set too small or without band jumps > 2: {len(jobs)} pairs")
    res = check_kernels(jobs, BAND, timed=True)
    check_kernels(make_jobs(rng, n_templates=8, reads_per=32, band=OPERON_BAND),
                  OPERON_BAND, timed=False)

    # phase 4: the main path
    work = Path(tempfile.mkdtemp(prefix="savont_chip_smoke_"))
    try:
        mp = main_path(work, rng)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sources = {
        "sw_forward_nm": ("savont_tpu_torch/ops/csrc/sw_forward.cu", "savont_tpu/ops/align_pallas.py:296"),
        "sw_forward_payload": ("savont_tpu_torch/ops/csrc/sw_forward.cu", "savont_tpu/ops/align_pallas.py:296"),
        "sw_walk": ("savont_tpu_torch/ops/csrc/sw_walk.cu", "savont_tpu/ops/align_jax.py:414"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": mp["launches"][name], "max_abs_err": res[name]["max_abs_err"],
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"]}
        for name, (src, rep) in sources.items()
    ]
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
