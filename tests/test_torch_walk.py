"""Kernel 2's plain PyTorch version (savont_tpu_torch.ops.traceback_torch)
held against the JAX package's walk + RLE and the host oracle, on the CPU.

Tolerance: 0.  Every output is an integer (coordinates, NM, packed CIGAR
runs), so every comparison is exact."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from savont_tpu.ops import align_jax
from savont_tpu.ops.align_batch import run_jobs
from savont_tpu_torch.ops import align_torch
from savont_tpu_torch.ops.align_torch import jobs_to_tensors, sw_forward_reference
from savont_tpu_torch.ops.traceback_torch import (
    sw_traceback_jobs,
    walk_rle,
    walk_rle_reference,
)

from _torch_jobs import reference_native  # noqa: F401  (autouse: savont_tpu's native libraries whole)
from _torch_jobs import max_advance, mixed_jobs, rand_seq, substitute

BAND = 48


def _same(h, p) -> bool:
    if h is None or p is None:
        return h is None and p is None
    return (
        h[:5] == p[:5] and h[6] == p[6]
        and np.array_equal(np.asarray(h[5], np.uint32), np.asarray(p[5], np.uint32))
    )


@pytest.fixture(scope="module")
def forward():
    js = mixed_jobs(seed=51, band=BAND)
    assert any(max_advance(j) == 2 for j in js) and any(max_advance(j) > 2 for j in js)
    q, t, lo, tl = jobs_to_tensors(js, "cpu")
    payload, score, ri, bj = sw_forward_reference(q, t, lo, tl, BAND, emit_payload=True)
    return js, lo, payload, score, ri, bj, q.shape[1] + t.shape[1]


@pytest.mark.parametrize("maxrun", [512, 4])
def test_walk_matches_xla_walk(forward, maxrun):
    """Same payload into both walks.  maxrun=4 forces overflow: n_runs still
    agrees, and overflowed rows are all zero in the port."""
    _, lo, payload, score, ri, bj, ops_max = forward
    assert ops_max >= 512  # the XLA RLE needs ops_max >= maxrun
    cigar, meta = walk_rle_reference(payload, lo, score, ri, bj, BAND, ops_max, maxrun)
    B = payload.shape[0]
    walk = jax.jit(
        partial(align_jax.sw_traceback_from_payload, band=BAND, ops_max=ops_max, maxrun=maxrun)
    )
    ref = walk(
        jnp.asarray(payload.numpy().reshape(B, -1)), jnp.asarray(lo.numpy()),
        jnp.asarray(score.numpy()), jnp.asarray(ri.numpy()), jnp.asarray(bj.numpy()),
    )
    meta = meta.numpy()
    for k, key in enumerate(("n_runs", "q_start", "q_end", "t_start", "t_end", "nm")):
        np.testing.assert_array_equal(meta[:, k], np.asarray(ref[key]), err_msg=key)
    fits = meta[:, 0] <= maxrun
    np.testing.assert_array_equal(
        cigar.numpy().view(np.uint32)[fits], np.asarray(ref["cigar"])[fits]
    )
    assert not cigar.numpy()[~fits].any()
    if maxrun == 4:
        assert (~fits).any()


def test_walk_wrapper_counts_plain_calls_on_cpu(forward):
    _, lo, payload, score, ri, bj, ops_max = forward
    before = align_torch.REFERENCE_CALLS["sw_walk"]
    got = walk_rle(payload, lo, score, ri, bj, BAND, ops_max)
    want = walk_rle_reference(payload, lo, score, ri, bj, BAND, ops_max)
    assert align_torch.REFERENCE_CALLS["sw_walk"] == before + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        walk_rle(payload.int(), lo, score, ri, bj, BAND, ops_max)
    with pytest.raises(ValueError, match="start cells"):
        walk_rle(payload, lo, score, ri, bj + BAND, BAND, ops_max)


@pytest.mark.parametrize("band", [48, 128])
def test_traceback_jobs_match_host(band):
    js = mixed_jobs(seed=53 + band, band=band)
    host = run_jobs(js, band=band)
    port = sw_traceback_jobs(js, band, device="cpu")
    assert any(h is not None for h in host)
    for i, (h, p) in enumerate(zip(host, port)):
        assert _same(h, p), f"job {i}: host {h} port {p}"


def test_traceback_overflow_reruns_on_host():
    js = mixed_jobs(seed=57, band=BAND, n=4)
    host = run_jobs(js, band=BAND)
    before = align_torch.LAUNCHES["walk_overflow"]
    port = sw_traceback_jobs(js, BAND, maxrun=4, device="cpu")
    assert align_torch.LAUNCHES["walk_overflow"] > before
    for h, p in zip(host, port):
        assert _same(h, p)


def test_traceback_matches_pallas_interpret():
    """The Pallas payload kernel + XLA walk, in interpret mode as the JAX
    package's tests run it.  Jobs of >= 260 bp keep its padded
    Lq_pad + Lt_pad >= maxrun (512), below which its RLE step fails with a
    shape error (align_jax.py:556)."""
    from savont_tpu.ops.align_batch import plan_jobs
    from savont_tpu.ops.align import TargetIndex
    from savont_tpu.ops.align_pallas import sw_traceback_pallas_jobs

    rng = np.random.default_rng(59)
    js = []
    while len(js) < 4:
        t = rand_seq(rng, 280)
        q = substitute(rng, t, 0.04)
        del q[140:142]
        js.extend(plan_jobs(TargetIndex([t]), bytes(q), band=16, min_anchors=2))
    js = js[:4]
    pallas = sw_traceback_pallas_jobs(js, band=16, interpret=True)
    port = sw_traceback_jobs(js, 16, device="cpu")
    assert all(p is not None for p in port)
    for h, p in zip(pallas, port):
        assert _same(h, p)
