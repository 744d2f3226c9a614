"""Kernel 2's plain PyTorch version on the edge shapes that chip_smoke.py runs
through the CUDA kernel (chip_smoke.walk_edge_cases: start rows on the edges
of the kernel's shared-memory windows, payloads at every alignment, wild
payloads, the stage-4 mix of score-0 rows, a walk cut by ops_max, CIGARs of
maxrun - 1, maxrun and maxrun + 1 runs), held on the CPU to

  - a direct numpy walk, pair by pair and step by step, with its run-length
    encoding (every case, every pair), and
  - the JAX package's sw_traceback_from_payload under jax.jit, on the cases
    whose ops_max is at least 512 (its run-length encoding needs ops_max >=
    maxrun) and that start no walk in row 0, which it never leaves.

Tolerance: 0.  Every output is an integer."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from savont_tpu.ops import align_jax
from savont_tpu_torch.ops.traceback_torch import walk_rle, walk_rle_launch, walk_rle_reference

CASES = chip_smoke.walk_edge_cases()
JAX_CASES = [c for c in CASES if c["ops_max"] >= 512]


def walk_loop(case):
    """The traceback of one pair after the other: the state machine of the
    host traceback, a list of runs grown backward, reversed at the end.
    Returns cigar (B, maxrun) uint32 and meta (B, 6)."""
    payload, lo, band = case["payload"], case["lo"], case["band"]
    ops_max, maxrun = case["ops_max"], case["maxrun"]
    B, Lq, _ = payload.shape
    cigar = np.zeros((B, maxrun), np.uint32)
    meta = np.zeros((B, 6), np.int64)
    for b in range(B):
        r, j = int(case["ri"][b]), int(case["bj"][b])
        q_end, t_end = r, int(lo[b, r]) + j + 1
        runs, nm, n_q, n_t = [], 0, 0, 0  # runs: [op, length], last op of the path first
        state = "H"
        while case["score"][b] > 0:
            row = max(r - 1, 0)
            p = int(payload[b, row, j])
            advance = int(lo[b, row + 1] - lo[b, row])
            if state == "H":
                state = "G" if p & 1 else "E"
            if state == "G" and p & 2:
                break
            if state == "G" and p & 4:
                state = "F"
            op = {"G": 0, "F": 1, "E": 2}[state]
            if runs and runs[-1][0] == op:
                runs[-1][1] += 1
            else:
                runs.append([op, 1])
            nm += (p >> 5) & 1 if op == 0 else 1
            n_q += op != 2
            n_t += op != 1
            if op == 0:
                r, j, state = r - 1, j + advance - 1, "H"
            elif op == 1:
                r, j = r - 1, j + advance
                state = "H" if p & 16 and j < band else "F"
            else:
                state = "G" if p & 8 and j >= 1 else "E"
                j -= 1
            if r <= 0 or j < 0 or j >= band or sum(n for _, n in runs) >= ops_max:
                break
        if len(runs) <= maxrun:
            cigar[b, :len(runs)] = [(n << 4) | op for op, n in reversed(runs)]
        meta[b] = (len(runs), q_end - n_q, q_end, t_end - n_t, t_end, nm)
    return cigar, meta


def tensors(case):
    return (*(torch.from_numpy(case[k]) for k in ("payload", "lo", "score", "ri", "bj")),
            case["band"], case["ops_max"], case["maxrun"])


def test_generator_covers_the_edges():
    """The properties the cases exist for."""
    assert {c["band"] for c in CASES} >= {1, 7, 33, 48, 100, 128, 200, 256}
    assert {c["maxrun"] for c in CASES} >= {4, 5, 512}
    assert {c["offset"] % 16 for c in CASES} >= {0, 1, 5, 8, 15}
    for c in CASES[:8]:
        W = chip_smoke.walk_window_rows(c["band"])
        assert set(c["ri"].tolist()) >= {1, W - 1, W, W + 1, 2 * W, 2 * W + 1, 3 * W + 1}, c["name"]
        assert (c["score"] == 0).any() and (c["score"] < 0).any()
        # an odd row count and an odd or unaligned band: pairs start at every alignment
        assert c["payload"].shape[1] % 2 == 1
    mix = next(c for c in CASES if c["name"] == "walk_mix_band48")
    assert 3 * (mix["score"] > 0).sum() <= len(mix["score"])
    cut = next(c for c in CASES if c["ops_max"] < 512)
    assert (cut["ri"] == 0).any() and (cut["score"][cut["ri"] == 0] > 0).all()
    assert np.array_equal(chip_smoke.walk_edge_cases()[3]["payload"], CASES[3]["payload"]), \
        "not seed-pinned"


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_plain_version_equals_walk_loop(case):
    cigar, meta = walk_rle(*tensors(case))  # a CPU tensor: the plain version
    want_cigar, want_meta = walk_loop(case)
    np.testing.assert_array_equal(meta.numpy(), want_meta)
    np.testing.assert_array_equal(cigar.numpy().view(np.uint32), want_cigar)
    n_runs, maxrun = want_meta[:, 0], case["maxrun"]
    if "n_runs" in case:  # the laid paths: at, one under and one over maxrun
        np.testing.assert_array_equal(n_runs, case["n_runs"])
        assert not cigar.numpy()[n_runs > maxrun].any() and cigar.numpy()[n_runs == maxrun].all()
    elif case["ops_max"] < 512:
        steps = (want_cigar >> 4).sum(axis=1)
        assert steps.max() == case["ops_max"] and (steps[case["ri"] == 0] <= 1).all()
    else:
        # walks that cross every window of the kernel
        W = chip_smoke.walk_window_rows(case["band"])
        assert ((want_meta[:, 2] - want_meta[:, 1]) > 2 * W).any() or "wild" in case["name"]
    if maxrun == 5:
        assert (n_runs > maxrun).any() and ((n_runs > 0) & (n_runs <= maxrun)).any()


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: c["name"])
def test_plain_version_equals_xla_walk(case):
    assert (case["ri"] >= 1).all()
    cigar, meta = walk_rle_reference(*tensors(case))
    B = len(case["ri"])
    walk = jax.jit(partial(align_jax.sw_traceback_from_payload, band=case["band"],
                           ops_max=case["ops_max"], maxrun=case["maxrun"]))
    ref = walk(jnp.asarray(case["payload"].reshape(B, -1)),
               *(jnp.asarray(case[k]) for k in ("lo", "score", "ri", "bj")))
    meta = meta.numpy()
    for k, key in enumerate(("n_runs", "q_start", "q_end", "t_start", "t_end", "nm")):
        np.testing.assert_array_equal(meta[:, k], np.asarray(ref[key]), err_msg=key)
    fits = meta[:, 0] <= case["maxrun"]
    np.testing.assert_array_equal(cigar.numpy().view(np.uint32)[fits],
                                  np.asarray(ref["cigar"])[fits])
    assert not cigar.numpy()[~fits].any()


def test_launch_alone_refuses_cpu_tensors():
    """walk_rle sends CPU tensors to the plain version; the launch alone has
    no plain version behind it and says so."""
    args = tensors(CASES[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        walk_rle_launch(*args)
    cigar, meta = walk_rle(*args)
    assert cigar.shape == (len(CASES[0]["ri"]), CASES[0]["maxrun"]) and meta.shape[1] == 6
