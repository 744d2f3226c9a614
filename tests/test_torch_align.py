"""Kernel 1's plain PyTorch version (savont_tpu_torch.ops.align_torch) held
against the host oracle and the JAX package's forwards, on the CPU.

Tolerance: 0.  Every output is an integer (scores, coordinates, NM,
payload bytes), so every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from savont_tpu.ops import align_jax
from savont_tpu.ops.align_batch import run_jobs, run_jobs_nm
from savont_tpu_torch.ops import align_torch
from savont_tpu_torch.ops.align_torch import (
    jobs_to_tensors,
    sw_forward,
    sw_forward_jobs,
    sw_forward_reference,
)

from _torch_jobs import reference_native  # noqa: F401  (autouse: savont_tpu's native libraries whole)
from _torch_jobs import max_advance, mixed_jobs, substitution_jobs

BAND = 48


@pytest.fixture(scope="module")
def jobs():
    js = mixed_jobs(seed=41, band=BAND)
    adv = [max_advance(j) for j in js]
    assert any(a <= 1 for a in adv), "no corridor with advances of 0/1 only"
    assert any(a == 2 for a in adv), "no corridor with an advance of 2"
    assert any(a > 2 for a in adv), "no corridor with a jump above 2"
    return js


def test_jobs_to_tensors_matches_jax_packing(jobs):
    ours = [x.numpy() for x in jobs_to_tensors(jobs, "cpu")]
    ref = align_jax._pack_jobs(jobs, BAND)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_forward_nm_matches_host_and_xla(jobs):
    q, t, lo, tl = jobs_to_tensors(jobs, "cpu")
    out = sw_forward_reference(q, t, lo, tl, BAND).numpy()

    host = run_jobs_nm(jobs, band=BAND)
    for i, h in enumerate(host):
        want = None if h is None else (h[0], h[2], h[4], h[6])
        got = tuple(int(v) for v in out[i]) if out[i, 0] > 0 else None
        assert want == got, f"job {i}: host {want} port {got}"

    xla = align_jax.sw_forward_meta(
        jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), jnp.asarray(lo.numpy()),
        jnp.asarray(tl.numpy()), band=BAND, smooth=False,
    )
    for k, key in enumerate(("score", "q_end", "t_end", "nm")):
        np.testing.assert_array_equal(out[:, k], np.asarray(xla[key]), err_msg=key)


def test_forward_payload_matches_xla(jobs):
    q, t, lo, tl = jobs_to_tensors(jobs, "cpu")
    payload, score, ri, bj = sw_forward_reference(q, t, lo, tl, BAND, emit_payload=True)
    fwd = jax.jit(align_jax._forward_payload, static_argnames=("band",))
    x_pay, x_score, x_ri, x_bj = fwd(
        jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), jnp.asarray(lo.numpy()),
        jnp.asarray(tl.numpy()), band=BAND,
    )
    B, Lq = q.shape
    np.testing.assert_array_equal(payload.numpy().reshape(B, Lq * BAND), np.asarray(x_pay))
    # the XLA forward starts its running best at NEG and the Pallas kernel
    # (and the port) at 0, so the start cell agrees wherever a score exists
    pos = score.numpy() > 0
    assert pos.any()
    for ours, theirs in ((score, x_score), (ri, x_ri), (bj, x_bj)):
        np.testing.assert_array_equal(ours.numpy()[pos], np.asarray(theirs)[pos])


@pytest.mark.parametrize("band", [48, 128])
def test_nm_and_payload_routes_match_host(band):
    """run_jobs_nm route (NM mode) and the payload forward against the host
    oracle at the pipeline band and the operon band."""
    js = mixed_jobs(seed=43 + band, band=band, n=8)
    host_nm = run_jobs_nm(js, band=band)
    port_nm = sw_forward_jobs(js, band, "cpu")
    for h, p in zip(host_nm, port_nm):
        assert (h is None) == (p is None)
        if h is not None:
            # starts are 0 by contract: the Pallas NM route reports spans only
            assert (p[0], p[1], p[2], p[3], p[4], p[6]) == (h[0], 0, h[2], 0, h[4], h[6])
            assert p[5] == []

    host_tb = run_jobs(js, band=band)
    q, t, lo, tl = jobs_to_tensors(js, "cpu")
    before = align_torch.REFERENCE_CALLS["sw_forward_payload"]
    _, score, ri, bj = sw_forward(q, t, lo, tl, band, emit_payload=True)
    assert align_torch.REFERENCE_CALLS["sw_forward_payload"] == before + 1
    lo_ri = lo.gather(1, ri.long()[:, None])[:, 0]
    for i, h in enumerate(host_tb):
        if h is None:
            assert score[i] <= 0
        else:
            assert (int(score[i]), int(ri[i]), int(lo_ri[i] + bj[i] + 1)) == (h[0], h[2], h[4])


def test_forward_matches_pallas_interpret():
    """The Pallas kernel itself, run in interpret mode as the JAX package's
    tests run it.  sw_forward_pallas smooths lo and has no lag gate, so the
    jobs carry substitutions only and every corridor already advances by at
    most 1: its input is then the raw corridor the port sees."""
    from savont_tpu.ops.align_pallas import sw_forward_pallas

    js = substitution_jobs(seed=45, band=16, n=6, length=260)
    assert all(max_advance(j) <= 1 for j in js)
    q, t, lo, tl = jobs_to_tensors(js, "cpu")
    ours = sw_forward_reference(q, t, lo, tl, 16).numpy()
    pallas = sw_forward_pallas(q.numpy(), t.numpy(), lo.numpy(), tl.numpy(), band=16, interpret=True)
    np.testing.assert_array_equal(ours, np.asarray(pallas))
    assert (ours[:, 0] > 0).all()


def test_wrapper_counts_plain_calls_on_cpu():
    js = mixed_jobs(seed=47, band=BAND, n=2)
    q, t, lo, tl = jobs_to_tensors(js, "cpu")
    before = dict(align_torch.REFERENCE_CALLS)
    launches = dict(align_torch.LAUNCHES)
    out = sw_forward(q, t, lo, tl, BAND)
    assert torch.equal(out, sw_forward_reference(q, t, lo, tl, BAND))
    assert align_torch.REFERENCE_CALLS["sw_forward_nm"] == before["sw_forward_nm"] + 1
    assert align_torch.LAUNCHES == launches
    with pytest.raises(ValueError):
        sw_forward(q.long(), t, lo, tl, BAND)
    with pytest.raises(ValueError):
        sw_forward(q, t, lo[:, 1:].contiguous(), tl, BAND)
    with pytest.raises(ValueError, match="non-decreasing"):
        sw_forward(q, t, lo.flip(1).contiguous(), tl, BAND)
