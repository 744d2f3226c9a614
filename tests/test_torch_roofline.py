"""The integer roofline probe (savont_tpu_torch.probes.roofline) on the CPU:
the plain version of each body against a Pallas copy of the TPU probe's
body (scripts/pallas_roofline.py, whose kernels are closures of its main)
run with interpret=True at a small iteration count, the wrapper's
counting and checks, and the SASS loop reader.

Tolerance: 0.  Every value is an int32 of wrapping arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from savont_tpu_torch.probes import roofline

BAND, P = 64, 128   # the TPU probe's tile
INNER, NCHAIN = 16, 4
ITERS = 3


def _peak_kernel(x_ref, y_ref, o_ref):
    x = x_ref[:, :]
    y = y_ref[:, :]

    def body(i, c):
        x, y = c
        for _ in range(INNER // 2):
            x = jnp.maximum(x, y)
            y = y + x
        return x, y

    x, y = lax.fori_loop(0, ITERS, body, (x, y))
    o_ref[:, :] = x + y


def _peak_ilp_kernel(x_ref, y_ref, o_ref):
    x = x_ref[:, :]
    y = y_ref[:, :]
    xs = [x + jnp.int32(i) for i in range(NCHAIN)]
    ys = [y ^ jnp.int32(i) for i in range(NCHAIN)]

    def body(i, c):
        xs, ys = c
        xs, ys = list(xs), list(ys)
        for _ in range(INNER // 2):
            for j in range(NCHAIN):
                xs[j] = jnp.maximum(xs[j], ys[j])
            for j in range(NCHAIN):
                ys[j] = ys[j] + xs[j]
        return tuple(xs), tuple(ys)

    xs, ys = lax.fori_loop(0, ITERS, body, (tuple(xs), tuple(ys)))
    acc = xs[0] + ys[0]
    for j in range(1, NCHAIN):
        acc = acc + xs[j] + ys[j]
    o_ref[:, :] = acc


def _swar_kernel(x_ref, y_ref, o_ref):
    x = x_ref[:, :]
    y = y_ref[:, :]
    M_LO = jnp.int32(0x0000FFFF)

    def max16x2(a, b):
        alo = a & M_LO
        blo = b & M_LO
        ahi = jax.lax.shift_right_logical(a, 16)
        bhi = jax.lax.shift_right_logical(b, 16)
        lo = jnp.maximum(alo, blo)
        hi = jnp.maximum(ahi, bhi)
        return jax.lax.shift_left(hi, 16) | lo

    def add16x2(a, b):
        lo = (a & M_LO) + (b & M_LO)
        hi = jax.lax.shift_right_logical(a, 16) + jax.lax.shift_right_logical(b, 16)
        return jax.lax.shift_left(hi, 16) | (lo & M_LO)

    def body(i, c):
        x, y = c
        for _ in range(INNER // 2):
            x = max16x2(x, y)
            y = add16x2(y, x)
        return x, y

    x, y = lax.fori_loop(0, ITERS, body, (x, y))
    o_ref[:, :] = x + y


BODIES = {"peak": _peak_kernel, "ilp": _peak_ilp_kernel, "swar": _swar_kernel}


def _pallas(kernel, x, y):
    """scripts/pallas_roofline.py `build`, run in interpret mode."""
    call = pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=[
            pl.BlockSpec((BAND, P), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((BAND, P), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((BAND, P), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((BAND, P), jnp.int32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("kind", roofline.KINDS)
@pytest.mark.parametrize("values", ["probe", "wide"])
def test_plain_version_matches_pallas_interpret(kind, values):
    """`probe` is the TPU probe's input range ([0, 1000), as the port's
    probe uses); `wide` spans all of int32, so every add wraps and every
    16-bit half is exercised."""
    rng = np.random.default_rng(5)
    if values == "probe":
        x, y = (rng.integers(0, 1000, (BAND, P)).astype(np.int32) for _ in range(2))
    else:
        x, y = (rng.integers(-2**31, 2**31, (BAND, P), dtype=np.int64).astype(np.int32)
                for _ in range(2))
    want = _pallas(BODIES[kind], x, y)
    got = roofline.roofline(kind, torch.from_numpy(x.ravel()), torch.from_numpy(y.ravel()), ITERS)
    np.testing.assert_array_equal(got.numpy().reshape(BAND, P), want)


def test_wrapper_counts_and_checks():
    x, y = roofline.inputs(256, "cpu")
    roofline.reset_counters()
    out = roofline.roofline("peak", x, y, 2)
    assert torch.equal(out, roofline.roofline_reference("peak", x, y, 2))
    assert roofline.REFERENCE_CALLS["roofline_peak"] == 1
    assert not any(roofline.LAUNCHES.values())
    with pytest.raises(ValueError):
        roofline.roofline("peak", x.long(), y, 2)
    with pytest.raises(ValueError):
        roofline.roofline("peak", x, y[:-1], 2)
    with pytest.raises(ValueError):
        roofline.roofline("max3", x, y, 2)
    with pytest.raises(ValueError):
        roofline.roofline("peak", x, y, 2, threads=2048)


LISTINGS = {
    # nvdisasm style: branches to labels
    "label": """
        Function : roofline_peak
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   IMNMX R2, R2, R3, !PT ;
        /*0020*/                   IADD3 R3, R3, R2, RZ ;
.L_x_1:
        /*0030*/                   IMNMX R2, R2, R3, !PT ;
        /*0040*/                   IADD3 R3, R3, R2, RZ ;
        /*0050*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;
        /*0060*/              @P0 BRA `(.L_x_1) ;
        /*0070*/              @!P1 BRA `(.L_x_0) ;
        /*0080*/                   EXIT ;
.L_x_2:
        /*0090*/                   BRA `(.L_x_2) ;
""",
    # cuobjdump -sass style: branches to addresses, encodings beside
    "address": """
\t\tFunction : roofline_peak
        /*0000*/                   MOV R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
        /*0010*/                   IMNMX R2, R2, R3, !PT ;      /* 0x0000000302027248 */
        /*0020*/                   IADD3 R3, R3, R2, RZ ;       /* 0x0000000203037210 */
        /*0030*/                   IMNMX R2, R2, R3, !PT ;      /* 0x0000000302027248 */
        /*0040*/                   IADD3 R3, R3, R2, RZ ;       /* 0x0000000203037210 */
        /*0050*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ; /* 0x000000ff0400720c */
        /*0060*/               @P0 BRA 0x30 ;                   /* 0xfffffffc00f00947 */
        /*0070*/              @!P1 BRA 0x10 ;                   /* 0xfffffffc00e09947 */
        /*0080*/                   EXIT ;                       /* 0x000000000000794d */
        /*0090*/                   BRA 0x90 ;                   /* 0xfffffffc00fc7947 */
""",
}


@pytest.mark.parametrize("style", sorted(LISTINGS))
def test_sass_loops_finds_innermost_loops(style):
    """Two nested loops and a self-branch: the inner loop and the
    self-branch are innermost, the outer loop is not."""
    loops = roofline.sass_loops(LISTINGS[style])
    inner = {"instructions": 4, "opcodes": {"IMNMX": 1, "IADD3": 1, "ISETP.NE.AND": 1, "BRA": 1}}
    assert loops == {"roofline_peak": [inner, {"instructions": 1, "opcodes": {"BRA": 1}}]}


@pytest.mark.parametrize("style", sorted(LISTINGS))
def test_sass_bodies_counts_the_whole_kernel(style):
    """Every instruction up to EXIT; the self-branch behind it (and NOP
    padding) is not part of the body."""
    listing = LISTINGS[style] + "        /*00a0*/                   NOP ;\n"
    assert roofline.sass_bodies(listing) == {"roofline_peak": {
        "instructions": 9,
        "opcodes": {"IMNMX": 2, "IADD3": 2, "BRA": 2, "MOV": 1, "ISETP.NE.AND": 1, "EXIT": 1},
    }}
    assert roofline.loops_of(roofline.sass_bodies(listing), "bitcast") == {}


def test_max_abs_err_of_the_timed_outputs():
    """What in_turns reports beside its times: 0 for equal outputs whatever
    their integer types, the largest difference otherwise, and no silent
    broadcast of unequal shapes."""
    a = torch.tensor([[1, -5, 7]], dtype=torch.int32)
    assert roofline.max_abs_err(a, a.clone()) == 0
    assert roofline.max_abs_err(a, a.to(torch.int16)) == 0
    assert roofline.max_abs_err(a, torch.tensor([[1, -5, 4]], dtype=torch.int16)) == 3
    assert roofline.max_abs_err(torch.tensor([70000]), torch.tensor([4464], dtype=torch.int16)) == 65536
    assert roofline.max_abs_err(torch.tensor([True, False]), torch.tensor([1, 1], dtype=torch.int32)) == 1
    with pytest.raises(AssertionError):
        roofline.max_abs_err(a, a[0])


def test_launch_ms_divides_a_queued_run_by_its_count(monkeypatch):
    """launch_ms times `runs` calls between one pair of events and reports
    their mean: one warm-up call, then reps x runs calls; in_turns hands its
    `runs` to every timing and still compares the outputs."""
    calls = []

    class FakeEvent:
        def __init__(self, enable_timing):
            self.at = None

        def record(self):
            self.at = len(calls)

        def elapsed_time(self, end):
            return 3.0 * (end.at - self.at)  # 3 ms per call between the events

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert roofline.launch_ms(lambda: calls.append(1), reps=2, runs=5) == 3.0
    assert len(calls) == 1 + 2 * 5
    calls.clear()
    assert roofline.launch_ms(lambda: calls.append(1)) == 3.0
    assert len(calls) == 1 + 3

    out = torch.tensor([1, 2, 3], dtype=torch.int32)
    made = {"kernel": 0, "plain": 0, "library": 0}

    def fn(name, value):
        def f():
            made[name] += 1
            return value
        return f

    r = roofline.in_turns(fn("kernel", out), fn("plain", out.clone()), fn("library", out.clone()), runs=4)
    assert r == {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0}
    # warm-up + reps x runs per timing, and one more call each for the comparison
    assert made == {"kernel": 2 * (1 + 3 * 4) + 1, "plain": 2 * (1 + 4) + 1, "library": (1 + 3 * 4) + 1}
    with pytest.raises(AssertionError, match="library call differs"):
        roofline.in_turns(fn("kernel", out), fn("plain", out), fn("library", out + 1))
