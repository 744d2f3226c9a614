"""Kernel 1's plain PyTorch version on the edge shapes that chip_smoke.py runs
through the CUDA kernel (chip_smoke.edge_cases: bands 1 to 256, batches of
1, 31 and 65 pairs, one-row queries, targets of length 0 and 1 and shorter
than the corridor, band jumps up to and past the band, codes 4 / 5 / 6, a
pair of score 0, ties across rows and lanes), held on the CPU to

  - a direct numpy loop of the recurrence, cell by cell in row-major order
    (every case, every pair), and
  - the JAX package's sw_forward_meta(smooth=False) and _forward_payload, on
    the pairs those accept: a target of length 0 makes them gather column
    -1; at a band of 2^k - 1 their clamp of a row advance (_dl_clamp, to
    the band) leaves the diagonal source inside the band for any advance
    above the band, where the recurrence reads past its end; and
    _forward_payload starts its running best below 0, so start cells are
    compared where a score exists.

Tolerance: 0.  Every output is an integer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from savont_tpu.ops import align_jax
from savont_tpu_torch.ops.align import GAP_EXT, GAP_OPEN, MATCH, MISMATCH
from savont_tpu_torch.ops.align_torch import sw_forward_reference
from savont_tpu_torch.ops.host_dp import NEG

CASES = chip_smoke.edge_cases()
# the JAX forwards compile once per shape: a band of every cells-per-lane
# class, a batch of one pair, a one-row query and a tie case
JAX_CASES = ("band7_B31_Lq157", "band33_B31_Lq157", "band100_B65_Lq90", "band256_B31_Lq61",
             "band48_B1_Lq311", "band48_B31_Lq1", "ties_band48")


def recurrence_loop(q, t, lo, tlens, band):
    """The recurrence cell by cell, rows then band cells in order, all pairs
    at once: the previous row's planes read by index, the E prefix a
    running max that takes the current cell on >=, the best cell
    updated on strict > in row-major order.  Returns out (B, 4) = score,
    q_end, t_end, nm; payload (B, Lq, band) uint8; and the best cell's band
    index (B,)."""
    B, Lq = q.shape
    rows_b = np.arange(B)
    H = np.zeros((B, band), np.int64)
    F = np.full((B, band), NEG, np.int64)
    NMH = np.zeros((B, band), np.int64)
    NMF = np.zeros((B, band), np.int64)
    best = np.zeros((B, 5), np.int64)  # value, row, cell, t_end, nm
    payload = np.zeros((B, Lq, band), np.uint8)
    tlast = np.maximum(tlens - 1, 0)

    def at(P, idx, ok, fill):
        return np.where(ok, P[rows_b, np.clip(idx, 0, band - 1)], fill)

    for r in range(1, Lq + 1):
        l = lo[:, r].astype(np.int64)
        dl = l - lo[:, r - 1]
        qc = q[:, r - 1]
        prev = [P.copy() for P in (H, F, NMH, NMF)]
        run_v = np.full(B, NEG, np.int64)
        run_m = np.zeros(B, np.int64)
        g_left = np.full(B, NEG, np.int64)
        for j in range(band):
            col = l + j
            tc = t[rows_b, np.minimum(col, tlast)]
            is_match = (tc == qc) & (qc < 4) & (tc < 4)
            s = np.where(is_match, MATCH, MISMATCH)
            u = j + dl
            up_in, d_in = u < band, (u >= 1) & (u - 1 < band)
            h_up, f_up = at(prev[0], u, up_in, NEG), at(prev[1], u, up_in, NEG)
            h_diag, nm_diag = at(prev[0], u - 1, d_in, NEG), at(prev[2], u - 1, d_in, 0)
            if j == 0:
                h_diag = np.where(col == 0, 0, h_diag)
                nm_diag = np.where(col == 0, 0, nm_diag)
            from_h = h_up - GAP_OPEN >= f_up
            f = np.maximum(np.maximum(h_up - GAP_OPEN, f_up) - GAP_EXT, NEG)
            g = np.maximum(np.maximum(0, h_diag + s), f)
            g_zero = g == 0
            g_f = ~g_zero & (g == f)
            e = np.maximum(run_v - GAP_OPEN - GAP_EXT * j, NEG)
            use_g = g >= e
            h = np.where(col >= tlens, NEG, np.where(use_g, g, e))
            nmf_n = np.where(from_h, at(prev[2], u, up_in, 0), at(prev[3], u, up_in, 0)) + 1
            nmg = np.where(g_zero, 0, np.where(g_f, nmf_n, nm_diag + ~is_match))
            nmh_n = np.where(use_g, nmg, run_m + j)
            exit_e = e == g_left - GAP_OPEN - GAP_EXT
            payload[:, r - 1, j] = (use_g * 1 + g_zero * 2 + g_f * 4 + exit_e * 8 + from_h * 16
                                    + ~is_match * 32)
            take = g + GAP_EXT * j >= run_v
            run_m = np.where(take, nmg - j, run_m)
            run_v = np.maximum(run_v, g + GAP_EXT * j)
            g_left = g
            H[:, j], F[:, j], NMH[:, j], NMF[:, j] = h, f, nmh_n, nmf_n
            better = h > best[:, 0]
            best[better] = np.stack([h, np.full(B, r), np.full(B, j), col + 1, nmh_n], 1)[better]
    return best[:, [0, 1, 3, 4]], payload, best[:, 2]


@pytest.fixture(scope="module")
def plain():
    """The plain PyTorch version's outputs per case, both modes."""
    out = {}
    for c in CASES:
        x = [torch.from_numpy(c[k]) for k in ("q", "t", "lo", "tlens")]
        pay = sw_forward_reference(*x, c["band"], emit_payload=True)
        out[c["name"]] = (sw_forward_reference(*x, c["band"]).numpy(),
                          tuple(a.numpy() for a in pay))
    return out


def test_generator_covers_the_edges():
    """The properties the cases exist for: bands, batch sizes, one-row
    queries, target lengths, advances, codes, a score of 0."""
    assert {c["band"] for c in CASES} >= set(chip_smoke.EDGE_BANDS)
    assert {c["q"].shape[0] for c in CASES} >= {1, 31, 65}
    lqs = {c["q"].shape[1] for c in CASES}
    assert 1 in lqs and max(lqs) >= 200
    for c in CASES[: len(chip_smoke.EDGE_BANDS)]:
        band, lo, tl = c["band"], c["lo"], c["tlens"]
        steps = set(np.diff(lo, axis=1).ravel().tolist())
        assert steps >= {0, 1, 2, 3, band - 1, band, band + 5}, c["name"]
        assert {0, 1} <= set(tl.tolist()) and ((tl > 1) & (tl < max(band, 2))).any() | (band <= 2)
        assert ((tl > lo[:, -1]) & (tl < lo[:, -1] + band)).any() or band == 1, c["name"]
        assert (lo[:, 1] == 0).any(), "no corridor at column 0"
        for codes, name in ((c["q"], "q"), (c["t"], "t")):
            assert 4 in codes, name
        assert 5 in c["q"] and 6 in c["t"]
    assert np.array_equal(chip_smoke.edge_cases()[3]["q"], CASES[3]["q"]), "not seed-pinned"


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_plain_version_equals_recurrence_loop(case, plain):
    nm, (payload, score, ri, bj) = plain[case["name"]]
    want, want_payload, want_bj = recurrence_loop(*(case[k] for k in ("q", "t", "lo", "tlens")),
                                                  case["band"])
    np.testing.assert_array_equal(nm, want)
    np.testing.assert_array_equal(payload, want_payload)
    np.testing.assert_array_equal(np.stack([score, ri, bj]), np.stack([want[:, 0], want[:, 1], want_bj]))
    if case["name"].startswith("ties"):
        # the one-column-per-row pair reaches 48 at the end of both repeats
        # (rows 24 and 78) and in every fourth cell: the earliest row wins
        assert (score[0], ri[0]) == (48, 24) and bj[0] < 4


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_version_equals_jax_forwards(name, plain):
    case = next(c for c in CASES if c["name"] == name)
    band = case["band"]
    ok = case["tlens"] >= 1  # the JAX forwards gather column tlen - 1
    if band & (band + 1) == 0:  # 2^k - 1: their advance clamp stops at the band
        ok &= np.diff(case["lo"], axis=1).max(axis=1) <= band
    assert ok.sum() >= min(3, len(ok))
    q, t, lo, tl = (jnp.asarray(case[k][ok]) for k in ("q", "t", "lo", "tlens"))
    nm, (payload, score, ri, bj) = plain[name]

    xla = align_jax.sw_forward_meta(q, t, lo, tl, band=band, smooth=False)
    for k, key in enumerate(("score", "q_end", "t_end", "nm")):
        np.testing.assert_array_equal(nm[ok, k], np.asarray(xla[key]), err_msg=key)

    fwd = jax.jit(align_jax._forward_payload, static_argnames=("band",))
    x_pay, x_score, x_ri, x_bj = fwd(q, t, lo, tl, band=band)
    B, Lq = q.shape
    np.testing.assert_array_equal(payload[ok].reshape(B, Lq * band), np.asarray(x_pay))
    pos = score[ok] > 0
    for ours, theirs in ((score, x_score), (ri, x_ri), (bj, x_bj)):
        np.testing.assert_array_equal(ours[ok][pos], np.asarray(theirs)[pos])
