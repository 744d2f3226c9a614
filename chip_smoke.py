#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (savont_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It imports nothing of jax or of the JAX package.  Phases (each raises on
failure; nothing catches it, so the exit code is non-zero):
  1. device    - require a CUDA card; print its name, the torch / CUDA
                 versions and nvidia-smi's name and power limit; build and
                 load the port's host C++ oracle
                 (savont_tpu_torch/native/swalign.cpp);
  2. build     - compile savont_tpu_torch/ops/csrc/*.cu with nvcc, one
                 process per source, all started together;
  3. kernels   - seed-pinned jobs from the port's planner on random ~1,450 bp
                 templates (substitutions, 1-6 bp and 40-60 bp deletions,
                 both strands): >= 2,048 pairs at band 48 and a band-128
                 batch.  Kernel 1 (NM and payload modes) and kernel 2 must
                 equal their plain PyTorch versions on the card, and the
                 port's job routes the port's host oracle, CIGARs included;
                 the three roofline kernels and the eleven kernels of the
                 bitcast, i16ops and roll probes must equal their plain
                 versions (bitcast: formula A is the roll by 1, formula B is
                 not; roll: every mode at k = 2, 4 and 8 rows a thread).
                 Then the edge shapes: small raw inputs the planner
                 does not produce (edge_cases: bands 1 to 256, batches of 1,
                 31 and 65 pairs, one-row queries, targets of length 0 and 1
                 and shorter than the corridor, band jumps up to and past
                 the band, codes 4 / 5 / 6, a pair of score 0, ties across
                 rows and lanes) through both modes of kernel 1 and through
                 kernel 2; and kernel 2 alone on walk_edge_cases: start rows on the edges of its
                 shared-memory windows, payloads at every alignment and
                 flush with the end of their storage, wild payloads, the
                 stage-4 mix of score-0 rows, a walk cut by ops_max, CIGARs
                 of maxrun - 1, maxrun and maxrun + 1 runs for maxrun 4, 5
                 and 512.  Kernel 2 is timed as its launch alone (20 queued
                 launches, and one), through walk_rle with its validation,
                 and on the stage-4 mix.
                 Tolerance 0 throughout: every output is an integer;
  4. probes    - the timed runs of the integer roofline probe
                 (savont_tpu_torch.probes.roofline.measure: the card's int32
                 max/add rate, which bounds kernel 1) and of the bitcast,
                 i16ops and roll probes, each time the mean of 20 launches
                 queued back to back with the single launch's beside it; the
                 outputs of the timed launches must equal their plain
                 versions' too, at tolerance 0; every roll mode and k must
                 run one chain instruction per element a step (the SASS of
                 its step loop) and take no less than its bound;
  5. main path - a seed-pinned 5,000-read fastq through
                 `savont_tpu_torch.cli.main(["asv", ..., "--device", "cuda"])`
                 (what `python -m savont_tpu_torch` runs) with the default
                 routes, the device routes of stages 4 and 7, once untimed
                 and once timed: the outputs must equal the sha256 digests
                 pinned below (those of the JAX package's host run on the
                 same reads; tests/test_torch_chip_smoke.py holds them to
                 it), every ASV must be at NM=0 against the templates,
                 kernels 1 (both modes) and 2 launched by the device routes,
                 no plain version called, no job handed to the per-job
                 consumers, the device EM within 1e-4 of the host EM; the
                 device time of kernels 1 and 2 inside each device route
                 (kernel_ms) is printed beside the route's seconds.  Then
                 the earlier path, `--stage4-backend host --stage7-backend
                 host`, on a 1,500-read sample, held to its own digests.
The last three lines of stdout are nvidia-smi's name / power limit, the
kernels JSON, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gzip
import hashlib
import json
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
N_READS_SMALL = 1500   # the host-routes run
EM_TOLERANCE = 1e-4    # device float32 EM against the host float64 EM, absolute
TEMPLATE_LEN = 1450
SEED = 2026
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MAXRUN = 512
# a shared-memory load's round trip, in cycles, and the SM clock it is turned
# into time at, both assumed and not measured here: about 30 cycles is what
# the pointer-chasing microbenchmark of Luo et al., "Dissecting the NVIDIA
# Hopper Architecture through Microbenchmarking and Multiple Level Analysis"
# (arXiv:2402.13499, 2024, its table of memory latencies), reads for shared
# memory on an H100; 1.98 GHz is the largest SM clock nvidia-smi reports for
# the H100 SXM
LDS_ROUND_TRIP_CYCLES = 30
SM_CLOCK_HZ = 1.98e9
EDGE_BANDS = (1, 7, 32, 33, 48, 64, 100, 128, 200, 256)
EDGE_SEED = 2027
# integer instructions per DP cell of the sequential recurrence: the count
# behind kernel 1's bound, which does not move with the implementation.  It
# was taken from the SASS of the one-thread-per-pair kernel that walked the
# band in sequence (band <= 64): NM mode 61 of the 88 instructions of a
# one-cell loop trip, payload mode 121 of 146 in a two-cell trip; the rest
# were loads, stores and branches.  The warp-per-pair kernel's own row loop
# is listed by python -m savont_tpu_torch.probes.roofline --sass DIR
OPS_PER_CELL = {"sw_forward_nm": 61, "sw_forward_payload": 60.5}
# sha256 of the outputs of the JAX package's host run_cluster(threads=4) on
# write_reads' fastq, named reads.fq.gz
DIGESTS = {
    "final_asvs.fasta": "f77dec4f95ac143c7f9744bd6fca0b8757824af1f1e85d39c04208a6b2bb6f13",
    "feature-table.tsv": "5508ec928bf4106aaece7efe0c686abb5f30c8a15b0f37c7d911f85ae37a5463",
    "temp/read_to_asv_mappings.tsv": "edaf681418d63f60bc88d8e4ad7bd85924beff57901ca6380f76d987525944cd",
}
# the same for the host-routes run on write_reads' N_READS_SMALL sample
DIGESTS_SMALL = {
    "final_asvs.fasta": "87c981361e01054f4f74012e3e1c1808167b483b298564ae9379372e21d7441b",
    "feature-table.tsv": "1c1b7107daedd81a76a11857b552dd88f050805814caa756762c6e5b96114499",
    "temp/read_to_asv_mappings.tsv": "6897ce9c6e927edd0e732e75e67263db6364f216e283caabb7e2e70a9c12a2e2",
}
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "sw_forward_nm": ("savont_tpu_torch/ops/csrc/sw_forward.cu", "savont_tpu/ops/align_pallas.py:296"),
    "sw_forward_payload": ("savont_tpu_torch/ops/csrc/sw_forward.cu", "savont_tpu/ops/align_pallas.py:296"),
    "sw_walk": ("savont_tpu_torch/ops/csrc/sw_walk.cu", "savont_tpu/ops/align_jax.py:414"),
    "roofline_peak": ("savont_tpu_torch/ops/csrc/roofline.cu", "scripts/pallas_roofline.py:43"),
    "roofline_ilp": ("savont_tpu_torch/ops/csrc/roofline.cu", "scripts/pallas_roofline.py:59"),
    "roofline_swar": ("savont_tpu_torch/ops/csrc/roofline.cu", "scripts/pallas_roofline.py:87"),
    "probe_bitcast": ("savont_tpu_torch/ops/csrc/probe_bitcast.cu", "scripts/pallas_probe_bitcast.py:24"),
    **{f"probe_i16_{op}": ("savont_tpu_torch/ops/csrc/probe_i16ops.cu",
                           f"scripts/pallas_probe_i16ops.py:{line}")
       for op, line in (("max", 44), ("lt", 45), ("eq", 46), ("select", 47), ("sra15", 48),
                        ("bitsel", 49), ("dpx", 22))},
    **{f"probe_roll_{mode}": ("savont_tpu_torch/ops/csrc/probe_roll.cu", "scripts/pallas_probe_roll.py:25")
       for mode in ("add", "shfl", "smem")},
}


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_done(name: str) -> None:
    log(f"[{time.perf_counter() - T0:6.1f} s] {name} done")


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean device milliseconds per call over `reps` calls, after a warm-up
    call unless the caller has made one."""
    import torch

    if warm_up:
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


def make_pairs(rng, n_templates: int, reads_per: int) -> list[tuple[bytes, list[bytes]]]:
    """n_templates random templates, each with reads_per mutated reads."""
    import numpy as np

    from savont_tpu_torch.ops.encode import revcomp_bytes

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for _ in range(n_templates):
        t = rng.choice(bases, TEMPLATE_LEN).tobytes()
        reads = []
        for k in range(reads_per):
            q = mutate(rng, t, k % 4)
            if (k // 4) % 2:
                q = revcomp_bytes(q)
            reads.append(q)
        out.append((t, reads))
    return out


def plan(pairs, band: int) -> list:
    """The port's planner over make_pairs' output: one index per template."""
    from savont_tpu_torch.ops.align import TargetIndex
    from savont_tpu_torch.ops.align_batch import plan_jobs

    jobs = []
    for t, reads in pairs:
        idx = TargetIndex([t])
        for q in reads:
            jobs.extend(plan_jobs(idx, q, band=band, min_anchors=2))
    return jobs


def edge_case(rng, name: str, band: int, B: int, Lq: int) -> dict:
    """B raw pairs at `band`: per-row advances drawn from 0, 1, 2, 3, band-1,
    band and band+5 (row 1 included; every second pair advances by 1 in 93%
    of its rows), corridors that start at column 0 to 3, target lengths by
    pair index (0, 1, below the band, inside the last corridor rows, past
    them), queries read off the target along the corridor with an offset
    that moves mid-way (so E and F gaps win), 4% substitutions, codes 4 in
    both, a padded query tail (code 5), target padding (code 6) past each
    target's end, and one all-padding query, whose score is 0."""
    import numpy as np

    steps = np.array([0, 1, 2, 3, band - 1, band, band + 5])
    wild = rng.choice(steps, (B, Lq), p=[0.2, 0.62, 0.06, 0.04, 0.03, 0.03, 0.02])
    calm = rng.choice(steps, (B, Lq), p=[0.03, 0.93, 0.015, 0.01, 0.005, 0.005, 0.005])
    dl = np.where((np.arange(B) % 2 == 1)[:, None], calm, wild)  # odd pairs align at length
    lo = np.concatenate([rng.integers(0, 4, (B, 1)), dl], axis=1).cumsum(axis=1)
    lo[0] -= lo[0, 0]  # pair 0 starts at column 0: the free left edge
    if Lq > 1:
        lo[0, 1] = 0
        lo[0] = np.maximum.accumulate(lo[0])
    end = lo[:, -1] + band
    kinds = np.arange(B) % 8
    tlens = np.where(kinds == 5, 0, np.where(kinds == 6, 1, np.where(
        kinds == 7, rng.integers(1, max(band, 2), B), np.where(
            (kinds == 3) | (kinds == 4), np.maximum(end - band // 2 - 1, 1), end + 2))))
    Lt = int(max(tlens.max(), 1)) + 3
    t = rng.integers(0, 4, (B, Lt))
    t[rng.random((B, Lt)) < 0.03] = 4
    off = np.where(np.arange(Lq) < Lq // 2, band // 2,
                   np.where(np.arange(Lq) < 3 * Lq // 4, min(band // 2 + 3, band - 1), band // 2))
    q = np.take_along_axis(t, np.minimum(lo[:, 1:] + off[None, :], Lt - 1), axis=1)
    sub = rng.random((B, Lq)) < 0.04
    q[sub] = rng.integers(0, 4, int(sub.sum()))
    q[rng.random((B, Lq)) < 0.02] = 4
    q[kinds == 2, Lq - Lq // 10:] = 5
    if B > 4:
        q[4] = 5
    t[np.arange(Lt)[None, :] >= tlens[:, None]] = 6
    i32 = np.int32
    return {"name": name, "band": band, "q": q.astype(i32), "t": t.astype(i32),
            "lo": lo.astype(i32), "tlens": tlens.astype(i32)}


def tie_case(band: int) -> dict:
    """Three pairs whose maximum is reached in two rows and in several band
    cells: the target repeats ACGT, the query is six repeats, 30 rows of
    padding (which send every score back to 0) and the six repeats again.
    Corridors: one column per row, no advance at all, two columns per row."""
    import numpy as np

    unit = np.arange(4)
    q = np.concatenate([np.tile(unit, 6), np.full(30, 5), np.tile(unit, 6)])
    Lq = len(q)
    rows = np.arange(Lq + 1)
    lo = np.stack([np.maximum(rows - 1, 0), np.zeros(Lq + 1, int), 2 * np.maximum(rows - 1, 0)])
    Lt = int(lo.max()) + band + 8
    t = np.tile(unit, Lt // 4 + 1)[:Lt]
    i32 = np.int32
    return {"name": f"ties_band{band}", "band": band, "q": np.tile(q, (3, 1)).astype(i32),
            "t": np.tile(t, (3, 1)).astype(i32), "lo": lo.astype(i32),
            "tlens": np.full(3, Lt, i32)}


def edge_cases(seed: int = EDGE_SEED) -> list[dict]:
    """The edge shapes of phase 3: every band of EDGE_BANDS with 65 or 31
    pairs and a few hundred rows, batches of one pair, one-row queries, and
    the tie cases.  Each case: name, band, and int32 q (B, Lq), t (B, Lt),
    lo (B, Lq+1), tlens (B,)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cases = []
    for k, band in enumerate(EDGE_BANDS):
        B = (65, 31)[k % 2]
        Lq = (230, 157)[k % 2] if band <= 64 else (90, 61)[k % 2]
        cases.append(edge_case(rng, f"band{band}_B{B}_Lq{Lq}", band, B, Lq))
    cases.append(edge_case(rng, "band48_B1_Lq311", 48, 1, 311))
    cases.append(edge_case(rng, "band256_B1_Lq40", 256, 1, 40))
    cases.append(edge_case(rng, "band48_B31_Lq1", 48, 31, 1))
    cases.append(edge_case(rng, "band1_B1_Lq1", 1, 1, 1))
    cases.append(edge_case(rng, "band200_B65_Lq1", 200, 65, 1))
    cases += [tie_case(48), tie_case(33), tie_case(7)]
    return cases


def walk_window_rows(band: int) -> int:
    """Payload rows per shared-memory window of kernel 2 (sw_walk.cu:
    kWindowBytes / band, between 1 and kMaxRows)."""
    return min(32, max(1, 4096 // band))


def walk_case(rng, name: str, band: int, B: int, Lq: int, wild: bool = False, **over) -> dict:
    """Raw inputs of kernel 2 that kernel 1 need not have made: the walk is
    defined on any payload bytes.  Each of the six payload bits is drawn on
    its own: calm walks are long diagonals with short E and F runs and
    cross every window (under band 16 nearly pure diagonals, which a narrow
    band needs to get that far); `wild` ones change state at every other
    cell.  Rows advance by 0 to 3, or with `drift` by 0, 1 or 2 at 15 / 70 /
    15%, so that a diagonal run leaves a narrow band midway.  The start rows
    go round the window's edges (row 1, one under, at and one over W, 2W and
    3W, the last row), the start cells lie in the band's middle half, pair 5
    has score 0 and pair 11 a negative one.  `over` sets ops_max, maxrun,
    drift, offset (the bytes between the start of the payload's storage and
    its first byte, so that no pair is 16-byte aligned) and zero_rows (score
    0 except every third pair, the stage-4 route's mix)."""
    import numpy as np

    W = walk_window_rows(band)
    # use_g, g_zero, g_f, exitE, from_h, mismatch
    narrow = band < 16 and not wild
    p_bits = ((0.6, 0.01, 0.3, 0.5, 0.5, 0.5) if wild else
              (0.999, 0.001, 0.002, 0.6, 0.6, 0.05) if narrow else
              (0.97, 0.001, 0.03, 0.6, 0.6, 0.05))
    payload = np.zeros((B, Lq, band), np.uint8)
    for k, p in enumerate(p_bits):
        payload |= (rng.random((B, Lq, band)) < p).astype(np.uint8) << k
    dl = rng.choice(4, (B, Lq), p=[0.15, 0.7, 0.15, 0] if over.get("drift") else
                    [0.002, 0.996, 0.002, 0] if narrow else [0.05, 0.9, 0.03, 0.02])
    lo = np.concatenate([rng.integers(0, 4, (B, 1)), dl], axis=1).cumsum(axis=1)
    edges = [r for r in (1, 2, W - 1, W, W + 1, 2 * W - 1, 2 * W, 2 * W + 1, 3 * W, 3 * W + 1,
                         Lq - 1, Lq) if 1 <= r <= Lq]
    ri = np.array([edges[b % len(edges)] for b in range(B)])
    bj = rng.integers(band // 4, max(3 * band // 4, band // 4 + 1), B)
    score = np.ones(B, int)
    score[5:B:12] = 0
    score[11:B:12] = -3
    if over.get("zero_rows"):
        score[np.arange(B) % 3 != 0] = 0
    i32 = np.int32
    return {"name": name, "band": band, "payload": payload, "lo": lo.astype(i32),
            "score": score.astype(i32), "ri": ri.astype(i32), "bj": bj.astype(i32),
            "ops_max": over.get("ops_max", 600), "maxrun": over.get("maxrun", MAXRUN),
            "offset": over.get("offset", 0)}


def walk_runs_case(name: str, band: int, maxrun: int) -> dict:
    """Six pairs whose payload bits are laid along a chosen path, so that the
    CIGAR has exactly maxrun - 1, maxrun and maxrun + 1 runs (the last an
    overflow), each once with the path running into row 0 and once stopped
    three rows above it by a cell of G = 0.  Forward, the runs are M, I, M, D,
    M, I, ... of one or two ops each; every advance is 1, so an insertion
    moves the band cell up by one and a deletion back.  Returns the inputs of
    walk_case, and n_runs (6,), what the walk must count."""
    import numpy as np

    M, I, D = 0, 1, 2
    targets = [maxrun - 1, maxrun, maxrun + 1] * 2
    Lq = 2 * (maxrun + 1) + 8
    B = len(targets)
    payload = np.zeros((B, Lq, band), np.uint8)
    ri = np.zeros(B, int)
    bj0 = band // 2
    for b, n in enumerate(targets):
        runs = [(M, 1 + k % 4 // 2) if k % 2 == 0 else ((I, D)[k // 2 % 2], 1 + k % 3 // 2)
                for k in range(n)]
        back = [op for op, length in reversed(runs) for _ in range(length)]
        rows = sum(op != D for op in back)
        spare = 3 * (b >= 3)  # rows left above the path: it ends on a G = 0 cell
        r, j, st = rows + spare, bj0, "H"
        ri[b] = r
        for k, op in enumerate(back):
            nxt = back[k + 1] if k + 1 < len(back) else None
            cell = payload[b, r - 1]
            if op == M:
                cell[j] |= (st == "H") * 1 | (k % 7 == 0) * 32
                r, st = r - 1, "H"
            elif op == I:
                cell[j] |= (st == "H") * 1 | (st != "F") * 4 | (nxt != I) * 16
                r, j, st = r - 1, j + 1, "F" if nxt == I else "H"
            else:
                if st == "G":
                    raise AssertionError("a deletion cannot follow the exit of a deletion")
                cell[j] |= (nxt != D) * 8
                j, st = j - 1, "E" if nxt == D else "G"
        if r > 0:
            payload[b, r - 1, j] |= 1 | 2  # the last op was a match: state H, use_g, G = 0
    i32 = np.int32
    return {"name": name, "band": band, "payload": payload,
            "lo": np.tile(np.arange(Lq + 1), (B, 1)).astype(i32), "score": np.ones(B, i32),
            "ri": ri.astype(i32), "bj": np.full(B, bj0, i32), "ops_max": max(3 * Lq, 600),
            "maxrun": maxrun, "offset": 0, "n_runs": np.array(targets, i32)}


def walk_edge_cases(seed: int = EDGE_SEED + 1) -> list[dict]:
    """The edge shapes of kernel 2 alone: every band class with start rows on
    the window edges and payloads at every alignment, wild payloads,
    diagonal runs that drift out of a narrow band, the stage-4 mix (two
    thirds of the rows at score 0), a walk cut by ops_max in the middle of a
    window (with a start row of 0, which kernel 1 never gives), and CIGARs
    of maxrun - 1, maxrun and maxrun + 1 runs for maxrun 4, 5 (rows that are
    no multiple of 16 bytes) and 512.  Each case: name,
    band, payload (B, Lq, band) uint8, int32 lo (B, Lq+1), score, ri, bj (B,),
    ops_max, maxrun, offset."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cases = []
    for k, band in enumerate((1, 7, 33, 48, 100, 128, 200, 256)):
        Lq = 3 * walk_window_rows(band) + 5
        cases.append(walk_case(rng, f"walk_band{band}", band, 24, Lq,
                               offset=(0, 1, 5, 8, 15, 3, 0, 7)[k]))
    cases.append(walk_case(rng, "walk_wild_band48", 48, 65, 101, wild=True, offset=13))
    cases.append(walk_case(rng, "walk_wild_band7_maxrun5", 7, 31, 131, wild=True, maxrun=5,
                           offset=2))
    cases.append(walk_case(rng, "walk_drift_band7", 7, 65, 101, drift=True, offset=11))
    cases.append(walk_case(rng, "walk_mix_band48", 48, 96, 101, zero_rows=True))
    cut = walk_case(rng, "walk_opsmax40_band48", 48, 24, 101, ops_max=40, offset=9)
    cut["ri"][:2] = 0  # reads row 0 for one op
    cases.append(cut)
    cases += [walk_runs_case(f"walk_runs_maxrun{m}", 48, m) for m in (4, 5, 512)]
    return cases


def check_edge_shapes() -> int:
    """Kernel 1 in both modes and kernel 2 on its payload against their plain
    versions on the card, exact, over edge_cases; then kernel 2 alone over
    walk_edge_cases.  Returns the case count."""
    import torch

    from savont_tpu_torch.ops.align_torch import sw_forward, sw_forward_reference
    from savont_tpu_torch.ops.traceback_torch import (
        walk_rle, walk_rle_launch, walk_rle_reference,
    )

    walk_cases = walk_edge_cases()
    for case in walk_cases:
        band, off = case["band"], case["offset"]
        # the payload as a view that ends with its storage
        storage = torch.empty(off + case["payload"].size, dtype=torch.uint8, device="cuda")
        payload = storage[off:].view(case["payload"].shape)
        payload.copy_(torch.from_numpy(case["payload"]))
        args = (payload, *(torch.from_numpy(case[k]).cuda() for k in ("lo", "score", "ri", "bj")),
                band, case["ops_max"], case["maxrun"])
        got = walk_rle(*args)
        torch.cuda.synchronize()
        want = walk_rle_reference(*args)
        err = max_abs_diff(zip(got, want))
        if err:
            raise AssertionError(f"edge case {case['name']}: kernel 2 differs from its plain "
                                 f"version by {err}")
        n_runs = want[1][:, 0]
        log(f"  edge {case['name']}: {payload.shape[0]} pairs, Lq {payload.shape[1]}, band {band}, "
            f"payload {payload.data_ptr() % 16} bytes past a 16-byte line, ops_max "
            f"{case['ops_max']}, maxrun {case['maxrun']}, {int((args[2] <= 0).sum())} of score "
            f"<= 0, {int((n_runs > case['maxrun']).sum())} overflowed, longest path "
            f"{int((want[1][:, 2] - want[1][:, 1]).max())} rows: walk == plain (exact)")
    # a warp keeps ops_max op bytes in shared memory: at 150,000 one warp is a
    # block and the walk is still exact; at 300,000 no block holds them, and
    # the wrapper says so instead of launching
    big = (*args[:6], 150_000, case["maxrun"])
    if max_abs_diff(zip(walk_rle(*big), walk_rle_reference(*big))):
        raise AssertionError("kernel 2 differs from its plain version at ops_max 150,000")
    try:
        walk_rle_launch(*args[:6], 300_000, case["maxrun"])
    except ValueError as e:
        log(f"  edge ops_max 150,000: walk == plain (exact); ops_max 300,000 refused: {e}")
    else:
        raise AssertionError("kernel 2 took an ops_max that no block's shared memory holds")

    cases = edge_cases()
    for case in cases:
        band = case["band"]
        q, t, lo, tl = (torch.from_numpy(case[k]).cuda() for k in ("q", "t", "lo", "tlens"))
        ops_max = q.shape[1] + t.shape[1]
        nm_k = sw_forward(q, t, lo, tl, band)
        pay_k = sw_forward(q, t, lo, tl, band, emit_payload=True)
        payload, score, ri, bj = pay_k
        walk_k = walk_rle(payload, lo, score, ri, bj, band, ops_max)
        torch.cuda.synchronize()
        nm_r = sw_forward_reference(q, t, lo, tl, band)
        pay_r = sw_forward_reference(q, t, lo, tl, band, emit_payload=True)
        walk_r = walk_rle_reference(payload, lo, score, ri, bj, band, ops_max)
        err = {"sw_forward_nm": max_abs_diff([(nm_k, nm_r)]),
               "sw_forward_payload": max_abs_diff(zip(pay_k, pay_r)),
               "sw_walk": max_abs_diff(zip(walk_k, walk_r))}
        if any(err.values()):
            raise AssertionError(f"edge case {case['name']}: kernels differ from their plain "
                                 f"versions: {err}")
        log(f"  edge {case['name']}: {q.shape[0]} pairs, Lq {q.shape[1]}, band {band}, "
            f"{int((nm_r[:, 0] == 0).sum())} of score 0: NM, payload, walk == plain (exact)")
    return len(cases) + len(walk_cases)


def max_jump(job) -> int:
    import numpy as np

    return int(np.diff(job.lo).max()) if len(job.lo) > 1 else 0


def max_abs_diff(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in pairs)


def check_kernels(jobs, band: int, time_plain: bool) -> dict:
    """Kernels 1 and 2 against their plain versions on the card, and the
    port's job routes against the port's host oracle.  Returns per kernel
    the error and its time, with `time_plain` the plain version's time too,
    and the shapes the bounds need."""
    import numpy as np
    import torch

    from savont_tpu_torch.ops.align_torch import (
        jobs_to_tensors, sw_forward, sw_forward_jobs, sw_forward_reference,
    )
    from savont_tpu_torch.ops.host_dp import run_jobs_host, run_jobs_nm_host
    from savont_tpu_torch.ops.traceback_torch import (
        sw_traceback_jobs, walk_rle, walk_rle_launch, walk_rle_reference,
    )
    from savont_tpu_torch.probes.roofline import QUEUED_RUNS, launch_ms

    order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
    sjobs = [jobs[i] for i in order]
    q, t, lo, tl = jobs_to_tensors(sjobs, "cuda")
    B, Lq = q.shape
    Lt = t.shape[1]
    ops_max = Lq + Lt
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

    # kernel 2 is timed as its launch alone: the public wrapper's validation
    # reads the start cells back and waits for the device
    walk_args = (payload, lo, score, ri, bj, band, ops_max)
    per = {
        "sw_forward_nm": (lambda: sw_forward(q, t, lo, tl, band),
                          lambda: sw_forward_reference(q, t, lo, tl, band)),
        "sw_forward_payload": (
            lambda: sw_forward(q, t, lo, tl, band, emit_payload=True),
            lambda: sw_forward_reference(q, t, lo, tl, band, emit_payload=True)),
        "sw_walk": (lambda: walk_rle_launch(*walk_args), lambda: walk_rle_reference(*walk_args)),
    }
    for name, (kern, plain) in per.items():
        # plain, kernel, kernel, plain: the two orders of one pair (the
        # comparison above was the plain version's warm-up); kernel 2, a
        # tenth of kernel 1's time, as the mean of QUEUED_RUNS launches
        # queued back to back
        p1 = cuda_ms(plain, 1, warm_up=False) if time_plain else None
        if name == "sw_walk":
            k1, k2 = (launch_ms(kern, reps=2, runs=QUEUED_RUNS) for _ in range(2))
        else:
            k1, k2 = cuda_ms(kern, 5), cuda_ms(kern, 5)
        p2 = cuda_ms(plain, 1, warm_up=False) if time_plain else None
        res[name].update(ms=min(k1, k2))
        line = f"  {name}: kernel {min(k1, k2):.3f} ms ({1e3 * min(k1, k2) / B:.3f} us/pair)"
        if time_plain:
            res[name].update(plain_ms=min(p1, p2))
            line += f", plain {min(p1, p2):.1f} ms ({1e3 * min(p1, p2) / B:.1f} us/pair)"
        log(f"{line}, {B} pairs, Lq {Lq}, band {band}")
    # beside kernel 2's queued time: one launch between its events (which
    # holds the wrapper's host time), the public wrapper with its validation,
    # and the stage-4 route's mix (a seeded third of the rows walk; the others
    # have score 0), its output compared as well
    walks = torch.from_numpy(np.random.default_rng(EDGE_SEED).random(B) < 1 / 3).to(score.device)
    mix_args = (payload, lo, torch.where(walks, score, 0), *walk_args[3:])
    res["sw_walk"].update(
        single_ms=launch_ms(per["sw_walk"][0]),
        checked_ms=launch_ms(lambda: walk_rle(*walk_args)),
        mix_ms=launch_ms(lambda: walk_rle_launch(*mix_args), runs=QUEUED_RUNS))
    err = max_abs_diff(zip(walk_rle_launch(*mix_args), walk_rle_reference(*mix_args)))
    if err:
        raise AssertionError(f"sw_walk on the stage-4 mix differs from its plain version at "
                             f"band {band} by {err}")
    w = res["sw_walk"]
    log(f"  sw_walk, launch alone: {w['ms']:.4f} ms queued ({QUEUED_RUNS} launches), "
        f"{w['single_ms']:.4f} ms single, {w['checked_ms']:.4f} ms through walk_rle with its "
        f"validation; stage-4 mix ({B - int(walks.sum())} of {B} rows at score 0) "
        f"{w['mix_ms']:.4f} ms queued")
    # what the bounds need: the shapes, the walked path lengths (the op
    # counts of the CIGAR runs kernel 2 wrote) and the rows under the start
    # cells, which are the rows kernel 2 streams
    steps = (walk_k[0].cpu().numpy().view(np.uint32) >> 4).sum(axis=1)
    res["shape"] = {"B": B, "Lq": Lq, "Lt": Lt, "band": band, "walk_steps": int(steps.sum()),
                    "walk_max_steps": int(steps.max()),
                    "walk_rows": int(ri[score > 0].sum())}

    # the port's job routes (kernel 1 + kernel 2 on the card) against the
    # port's host oracle (native/swalign.cpp)
    host_nm = run_jobs_nm_host(jobs, band)
    host_tb = run_jobs_host(jobs, band)
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


def sw_bounds(shape: dict, int32_ops_per_s: float) -> dict:
    """Least time for kernels 1 and 2 at these shapes: the larger of the
    integer operations over the measured int32 rate and the bytes (each
    input read once, each output written once) over the card's memory
    rate.  Kernel 2's bound is its bytes: one payload byte and one lo word
    per walked step, the start cells, and the CIGAR rows and meta it writes.
    Beside the bound, and not part of it, two times that say what the
    warp-per-pair design can reach: `whole_rows_ms`, the bytes it streams
    (every payload row under a start cell, whole, and its lo word) over the
    memory rate, and `chain_floor_ms`, the longest walk's steps, each waiting
    for one shared-memory load (LDS_ROUND_TRIP_CYCLES at SM_CLOCK_HZ), which
    no number of warps shortens."""
    B, Lq, Lt, band = shape["B"], shape["Lq"], shape["Lt"], shape["band"]
    cells = B * Lq * band
    inputs = 4 * (B * Lq + B * Lt + B * (Lq + 1) + B)
    out = {}
    for name, out_bytes in (("sw_forward_nm", 16 * B), ("sw_forward_payload", cells + 12 * B)):
        t_ops = cells * OPS_PER_CELL[name] / int32_ops_per_s * 1e3
        t_bytes = (inputs + out_bytes) / HBM_BYTES_PER_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "cells": cells}
    walk_bytes = shape["walk_steps"] * 5 + 12 * B + 4 * B * MAXRUN + 24 * B
    out["sw_walk"] = {
        "bound_ms": walk_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "whole_rows_ms": shape["walk_rows"] * (band + 4) / HBM_BYTES_PER_S * 1e3,
        "chain_floor_ms": shape["walk_max_steps"] * LDS_ROUND_TRIP_CYCLES / SM_CLOCK_HZ * 1e3}
    return out


def write_reads(path: Path, tpl_path: Path, rng, n_reads: int = N_READS) -> None:
    """n_reads ONT-like reads from 10 templates (5 random, 5 variants with 4-6
    SNPs): 1.5% substitutions each, 30% with a 1-2 bp deletion, 10% with a
    2-6 bp deletion, 2% with a 50 bp deletion, half reverse-complemented."""
    import numpy as np

    from savont_tpu_torch.ops.encode import revcomp_bytes

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
        for i in range(n_reads):
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


def main_path_rng():
    """The generator in the state write_reads starts from: after the draws
    of phase 3's two job sets."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    make_pairs(rng, 48, 48)
    make_pairs(rng, 8, 32)
    return rng


def output_digests(out_dir: Path) -> dict[str, str]:
    return {rel: hashlib.sha256((out_dir / rel).read_bytes()).hexdigest() for rel in DIGESTS}


def small_sample_rng():
    """The generator in the state the host-routes sample starts from: after
    the main sample's draws."""
    rng = main_path_rng()
    with tempfile.TemporaryDirectory() as d:
        write_reads(Path(d) / "reads.fq.gz", Path(d) / "templates.fa", rng)
    return rng


def main_path(work: Path, rng) -> dict:
    from savont_tpu_torch import cli
    from savont_tpu_torch.ops import align_batch
    from savont_tpu_torch.ops.align_torch import LAUNCHES, REFERENCE_CALLS, reset_counters
    from savont_tpu_torch.parallel.mesh import ROUTE_STATS, reset_route_stats
    from savont_tpu_torch.pipeline.asv import STAGE_SECONDS
    from savont_tpu_torch.validate import validate_asvs

    def run(fq: Path, tag: str, *routes: str) -> dict:
        """One CLI run with every count set to 0 just before it; what it
        counted, read just after."""
        reset_counters()
        reset_route_stats()
        for k in align_batch.ROUTE_SECONDS:
            align_batch.ROUTE_SECONDS[k] = 0.0
        t0 = time.perf_counter()
        rc = cli.main(["--log-level", "warn", "asv", str(fq), "-o", str(work / tag),
                       "--device", "cuda", "-t", "4", *routes])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"savont_tpu_torch asv exited {rc}")
        return {"wall_s": wall, "launches": dict(LAUNCHES), "plain_calls": dict(REFERENCE_CALLS),
                "routes": {k: dict(v) for k, v in ROUTE_STATS.items()},
                "per_job_route_s": dict(align_batch.ROUTE_SECONDS),
                "stage_s": {k: round(v, 3) for k, v in STAGE_SECONDS.items()}}

    def held(tag: str, tpl: Path, digests: dict, r: dict) -> int:
        got = output_digests(work / tag)
        if got != digests:
            raise AssertionError(f"{tag}: outputs differ from the pinned digests of the host run: {got}")
        val = validate_asvs(str(work / tag / "final_asvs.fasta"), str(tpl))
        if not val or any(v.nm != 0 for v in val):
            raise AssertionError(f"{tag}: ASVs not all NM=0 against the templates: {val}")
        for k in ("sw_forward_nm", "sw_forward_payload", "sw_walk"):
            if r["launches"][k] <= 0:
                raise AssertionError(f"{tag}: kernel {k} was not launched: {r['launches']}")
        if any(r["plain_calls"].values()):
            raise AssertionError(f"{tag}: plain versions ran during the card run: {r['plain_calls']}")
        return len(val)

    # the default routes: the device routes of stages 4 and 7, at full width
    fq, tpl = work / "reads.fq.gz", work / "templates.fa"
    write_reads(fq, tpl, rng)
    warm = run(fq, "warmup")  # first run in the process: untimed
    mesh = run(fq, "mesh")
    n_asvs = held("mesh", tpl, DIGESTS, mesh)
    s4, s7 = mesh["routes"]["stage4"], mesh["routes"]["stage7"]
    # stage 4 piles up at most 250 reads per consensus, stage 7 aligns every
    # read to its candidate ASVs
    if s4["calls"] < 1 or s7["calls"] < 1 or s4["jobs"] < N_READS // 2 or s7["jobs"] < N_READS // 2:
        raise AssertionError(f"the device routes did not carry the sample: {mesh['routes']}")
    if s4["fallbacks"] or s7["fallbacks"]:
        raise AssertionError(f"the flat planner declined work on the sample: {mesh['routes']}")
    if not (s4["kernel_ms"] > 0 and s7["kernel_ms"] > 0):
        raise AssertionError(f"no kernel time was read inside the device routes: {mesh['routes']}")
    if not s7["em_max_abs_diff"] <= EM_TOLERANCE:
        raise AssertionError(f"device EM differs from the host EM by {s7['em_max_abs_diff']}")
    log(f"main path (device routes): {N_READS} reads, {n_asvs} ASVs all NM=0, outputs equal the "
        f"host run's pinned digests; savont_tpu_torch asv --device cuda {mesh['wall_s']:.2f} s warm "
        f"(first run {warm['wall_s']:.2f} s; wall, kernel build excluded); launches "
        f"{mesh['launches']}; plain calls {mesh['plain_calls']}")
    log(f"  stage seconds {mesh['stage_s']}; device routes, with the device milliseconds of "
        f"kernels 1 and 2 inside each (kernel_ms: {s4['kernel_ms']:.3f} of "
        f"{1e3 * s4['seconds']:.1f} ms in stage 4, {s7['kernel_ms']:.3f} of "
        f"{1e3 * s7['seconds']:.1f} ms in stage 7), {json.dumps(mesh['routes'])}; "
        f"per-job routes {mesh['per_job_route_s']}; {s4['overflow']} pairs overflowed kernel 2 "
        f"and were counted on the host; EM {s7['em_iters']} iterations, max |host - device| "
        f"{s7['em_max_abs_diff']:.3e} (tolerance {EM_TOLERANCE})")

    # the earlier path: the per-job routes, on a smaller sample
    fq_s, tpl_s = work / "small" / "reads.fq.gz", work / "small" / "templates.fa"
    fq_s.parent.mkdir()
    write_reads(fq_s, tpl_s, rng, N_READS_SMALL)
    host = run(fq_s, "host", "--stage4-backend", "host", "--stage7-backend", "host")
    n_small = held("host", tpl_s, DIGESTS_SMALL, host)
    if any(v["calls"] for v in host["routes"].values()):
        raise AssertionError(f"the host-routes run entered the device routes: {host['routes']}")
    log(f"earlier path (per-job routes): {N_READS_SMALL} reads, {n_small} ASVs all NM=0, outputs "
        f"equal their pinned digests; {host['wall_s']:.2f} s; launches {host['launches']}")
    log(f"  stage seconds {host['stage_s']}; per-job routes {host['per_job_route_s']}")
    return {"launches": mesh["launches"], "port_s": mesh["wall_s"], "n_asvs": n_asvs}


def main() -> int:
    if not (ROOT / "savont_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repo "
              "(savont_tpu_torch/ beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    from savont_tpu_torch.ops.native_build import get_lib

    oracle = get_lib()
    if oracle is None:
        raise AssertionError("the host C++ oracle (savont_tpu_torch/native/swalign.cpp) did not build")
    log(f"host C++ oracle loaded: {oracle._name}")
    phase_done("phase 1")

    # phase 2: build
    from savont_tpu_torch.ops.build import BUILD_INFO, build_kernels

    t0 = time.perf_counter()
    build_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s ({BUILD_INFO['path']})")
    for line in BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 3: kernels against their plain versions and the host oracle
    import numpy as np

    from savont_tpu_torch.probes import roofline

    rng = np.random.default_rng(SEED)
    jobs = plan(make_pairs(rng, 48, 48), BAND)
    if len(jobs) < N_PAIRS_MIN or not any(max_jump(j) > 2 for j in jobs):
        raise AssertionError(f"job set too small or without band jumps > 2: {len(jobs)} pairs")
    res = check_kernels(jobs, BAND, time_plain=True)
    res_op = check_kernels(plan(make_pairs(rng, 8, 32), OPERON_BAND), OPERON_BAND,
                           time_plain=False)
    phase_done("phase 3, kernels 1 and 2 at the planner's shapes")
    n_edge = check_edge_shapes()
    log(f"  edge shapes: {n_edge} cases, bands {EDGE_BANDS}: kernels 1 (both modes) and 2 == "
        f"plain, and kernel 2 alone on the window, alignment and maxrun edges")
    phase_done("phase 3, edge shapes")
    roof_err = roofline.check()
    if any(roof_err.values()):
        raise AssertionError(f"roofline kernels differ from their plain versions: {roof_err}")
    log(f"  roofline kernels == plain (exact, {roofline.CHECK_ITERS} iterations): {roof_err}")
    from savont_tpu_torch.probes import bitcast, i16ops, roll

    bc = bitcast.check()
    if bc["max_abs_err"] or not (bc["even_ok"] and bc["formula_a_ok"]) or bc["formula_b_ok"]:
        raise AssertionError(f"bitcast probe: expected exact, formula A right, B wrong: {bc}")
    probe_err = {"probe_bitcast": bc["max_abs_err"],
                 **{f"probe_i16_{k}": v for k, v in i16ops.check().items()},
                 **{f"probe_roll_{k}": v for k, v in roll.check().items()}}
    if any(probe_err.values()):
        raise AssertionError(f"probe kernels differ from their plain versions: {probe_err}")
    log(f"  probe kernels == plain (exact): {probe_err}; bitcast word roll is the roll by 2 "
        f"{bc['even_ok']}, formula A is the roll by 1 {bc['formula_a_ok']}, formula B "
        f"{bc['formula_b_ok']}; roll: every mode at k {roll.KS}, N {roll.CHECK_STEPS}, 1 and 3 tiles")

    phase_done("phase 3")
    # phase 4: the probes' timed runs
    roofline.reset_counters()
    roof = roofline.measure()
    roof_launches = dict(roofline.LAUNCHES)
    # the outputs of the timed launches, held to the plain version's too
    roof_err = {k: max(v, roof[k]["max_abs_err"]) for k, v in roof_err.items()}
    if any(roof_err.values()):
        raise AssertionError(f"roofline kernels differ from their plain versions at "
                             f"{roofline.PLAIN_ITERS} iterations: {roof_err}")
    for name, n in roof_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the probe: {roof_launches}")
    for k in roofline.KINDS:
        r = roof[k]
        log(f"  roofline {k}: card {r['card']['tops']:.3f} T ops/s "
            f"({r['card']['tvalues']:.3f} T values/s), one SM {r['one_sm']['tops']:.4f} T ops/s; "
            f"{roofline.PLAIN_ITERS} iterations: kernel {r['ms']:.4f} ms queued "
            f"({roofline.QUEUED_RUNS} launches), {r['single_ms']:.4f} ms single, plain "
            f"{r['plain_ms']:.1f} ms")
    log(f"roofline: int32 max/add {roof['int32_tops']:.3f} T ops/s measured, "
        f"{roof['published_dispatch_tops']:.3f} T instructions/s published dispatch rate "
        f"({roof['sms']} SMs x {roofline.DISPATCH_LANES_PER_SM} x max SM clock); "
        f"launches {roof_launches}")

    for mod in (bitcast, i16ops, roll):
        mod.reset_counters()
    bitcast_m = bitcast.measure()
    probe = {"probe_bitcast": bitcast_m["card"]}
    i16 = i16ops.measure()
    rl = roll.measure()
    probe.update({f"probe_i16_{k}": i16[k]["card"] for k in i16ops.OPS})
    # the roll modes at their best k, card-sized
    roll_k = {m: roll.best(rl, m)[0] for m in roll.MODES}
    probe.update({f"probe_roll_{m}": rl["card"][m][k] for m, k in roll_k.items()})
    probe_launches = {**bitcast.LAUNCHES, **i16ops.LAUNCHES, **roll.LAUNCHES}
    # the outputs of the timed launches (2,048 tiles; 66 tiles x 2,000 steps)
    # and of the one-tile ones, held to the plain version's too
    timed_err = {"probe_bitcast": max(r["max_abs_err"] for r in bitcast_m.values()),
                 **{f"probe_i16_{k}": max(i16[k][w]["max_abs_err"] for w in ("tile", "card"))
                    for k in i16ops.OPS},
                 **{f"probe_roll_{m}": max(rl[w][m][k]["max_abs_err"] for w in ("tile", "card")
                                           for k in roll.KS) for m in roll.MODES}}
    probe_err = {k: max(v, timed_err[k]) for k, v in probe_err.items()}
    if any(probe_err.values()):
        raise AssertionError(f"probe kernels differ from their plain versions at the timed "
                             f"shapes: {probe_err}")
    for name, n in probe_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by its probe: {probe_launches}")
    log(f"  bitcast: {json.dumps(probe['probe_bitcast'])}")
    for k in i16ops.OPS:
        log(f"  i16 {k}: chain {i16[k]['chain']['tops']:.3f} T ops/s "
            f"({i16[k]['chain']['tvalues']:.3f} T values/s); elementwise, {i16ops.CARD_TILES} tiles: "
            f"{json.dumps(i16[k]['card'])}; one tile {i16[k]['tile']['ms']:.4f} ms")
    # every step runs its instruction per element (the compiler merged none),
    # so no time stands under the bound
    for m in roll.MODES:
        for k in roll.KS:
            loop, r = rl["step_loops"][f"{m}_k{k}"], rl["card"][m][k]
            if loop["chain"] < roll.TRIP_STEPS * k or r["ms"] < r["bound_ms"]:
                raise AssertionError(
                    f"roll {m}, k={k}: {loop['chain']} chain instructions a trip of "
                    f"{roll.TRIP_STEPS} steps of {k} elements, {r['ms']:.4f} ms queued against a "
                    f"{r['bound_ms']:.4f} ms bound")
    for where in ("tile", "card"):
        for k in roll.KS:
            log(f"  roll, {roll.STEPS} steps, {where}, k={k}: " + "; ".join(
                f"{m} {r['us_per_step']:.5f} us/step ({r['ms']:.4f} ms queued, {r['single_ms']:.4f} "
                f"ms single; floors: shuffle {r['shfl_floor_ms']:.4f}, shared memory "
                f"{r['smem_floor_ms']:.4f}, issue {r['issue_floor_ms']:.4f} ms at "
                f"{r['trip_instructions']} instructions a trip, {r['trip_chain']} of the chain)"
                for m, r in ((m, rl[where][m][k]) for m in roll.MODES))
                + "; roll over add: " + ", ".join(
                f"{m} {rl[where][m][k]['roll_cost_us']:.5f} us" for m in roll.MODES[1:]))
        add = rl[where]["add"][roll.KS[-1]]
        log(f"  roll, {where}: bound {add['bound_ms']:.4f} ms ({add['bound_by']}); best k "
            f"{roll_k}; torch.add(x, N), the closed form of add (it skips the steps), "
            f"{add['library_ms']:.4f} ms queued, {add['single_library_ms']:.4f} ms single; "
            f"torch.roll alone (no single call computes roll + N) {rl[where]['torch_roll_ms']:.4f} ms")
    log(f"  roll step loops (SASS): {json.dumps(rl['step_loops'])}")

    phase_done("phase 4")
    # phase 5: the main path
    work = Path(tempfile.mkdtemp(prefix="savont_chip_smoke_"))
    try:
        mp = main_path(work, rng)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase_done("phase 5")
    bounds = sw_bounds(res["shape"], roof["int32_tops"] * 1e12)
    kernels = []
    for name, (src, rep) in KERNELS.items():
        if name.startswith("roofline_"):
            r = roof[name.removeprefix("roofline_")]
            entry = {"launches": roof_launches[name], "max_abs_err": roof_err[name.removeprefix("roofline_")],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"]}
        elif name.startswith("probe_"):
            r = probe[name]
            entry = {"launches": probe_launches[name], "max_abs_err": probe_err[name],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            if name.startswith("probe_roll_"):
                mode = name.removeprefix("probe_roll_")
                entry.update(k=roll_k[mode], ms_by_k={k: rl["card"][mode][k]["ms"] for k in roll.KS})
        else:
            entry = {"launches": mp["launches"][name], "max_abs_err": res[name]["max_abs_err"],
                     "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
                     "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"]}
        # no single PyTorch call computes a banded Smith-Waterman, its
        # traceback walk, or a dependent max/add chain; the probes time the
        # one call that computes their function where there is one
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "library_ms": None, **entry})
    log("sw_walk: " + json.dumps({k: v for k, v in res["sw_walk"].items() if k != "max_abs_err"}))
    log(f"bounds: {json.dumps(bounds)} (ops per cell {OPS_PER_CELL}, int32 rate "
        f"{roof['int32_tops']:.3f} T ops/s, {HBM_BYTES_PER_S / 1e12} TB/s)")
    bounds_op = sw_bounds(res_op["shape"], roof["int32_tops"] * 1e12)
    log("operon band: " + json.dumps({
        name: {**{k: v for k, v in res_op[name].items() if k.endswith("_ms") or k == "ms"}, **b}
        for name, b in bounds_op.items()}) + f" at {json.dumps(res_op['shape'])}")
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
