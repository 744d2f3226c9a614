"""The three small probes (savont_tpu_torch.probes.bitcast / i16ops / roll)
on the CPU: the plain version of each against a Pallas copy of the TPU
probe's body (scripts/pallas_probe_bitcast.py, pallas_probe_i16ops.py,
pallas_probe_roll.py, whose kernels are closures of their mains) run with
interpret=True, on the probe's inputs and on full-range values; and the
wrappers' counting and checks.

Tolerance: 0.  Every value is an integer of wrapping arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from savont_tpu_torch.probes import bitcast, i16ops, roll

R, C = 64, 128


def _spec(rows):
    return pl.BlockSpec((rows, C), lambda: (0, 0), memory_space=pltpu.VMEM)


# ── bitcast ─────────────────────────────────────────────────────────────────


def _bitcast_kernel(x_ref, out_ref):
    x = x_ref[:, :]
    w = pltpu.bitcast(x, jnp.int32)
    even = pltpu.bitcast(pltpu.roll(w, 1, axis=0), jnp.int16)
    wr = pltpu.roll(w, 1, axis=0)
    ya = (w << 16) | lax.shift_right_logical(wr, 16)
    yb = lax.shift_right_logical(w, 16) | (wr << 16)
    out_ref[0:64, :] = even
    out_ref[64:128, :] = pltpu.bitcast(ya, jnp.int16)
    out_ref[128:192, :] = pltpu.bitcast(yb, jnp.int16)


def _pallas_bitcast(x):
    call = pl.pallas_call(
        _bitcast_kernel, in_specs=[_spec(R)], out_specs=_spec(3 * R),
        out_shape=jax.ShapeDtypeStruct((3 * R, C), jnp.int16), interpret=True,
    )
    return np.asarray(call(jnp.asarray(x)))


@pytest.mark.parametrize("values", ["probe", "wide"])
def test_bitcast_plain_version_matches_pallas_interpret(values):
    x = bitcast.inputs(1, "cpu", values)[0]
    want = _pallas_bitcast(x.numpy())
    got = bitcast.bitcast_rolls(x).numpy()
    np.testing.assert_array_equal(got, want)
    # what the TPU probe printed: the word roll is the roll by 2, formula A
    # the roll by 1, formula B is not
    xr = x.numpy()
    assert np.array_equal(got[0:64], np.roll(xr, 2, axis=0))
    assert np.array_equal(got[64:128], np.roll(xr, 1, axis=0))
    assert not np.array_equal(got[128:192], np.roll(xr, 1, axis=0))


def test_bitcast_tiles_and_check():
    x = bitcast.inputs(3, "cpu", "wide")
    out = bitcast.bitcast_rolls(x)
    assert out.shape == (3, 192, 128)
    for k in range(3):
        assert torch.equal(out[k], bitcast.bitcast_rolls(x[k].contiguous()))
    assert bitcast.check("cpu") == {"max_abs_err": 0, "even_ok": True,
                                    "formula_a_ok": True, "formula_b_ok": False}


@pytest.mark.parametrize("tiles", [1, 3, 5])
def test_bitcast_plain_version_is_three_row_permutations(tiles):
    """What the three blocks are, row by row: the roll by 2, the roll by 1,
    and formula B's out[2m] = x[2m + 1], out[2m + 1] = x[2m - 2]."""
    x = bitcast.inputs(tiles, "cpu", "wide")
    out = bitcast.bitcast_rolls(x).numpy().reshape(tiles, 3, R, C)
    xr = x.numpy()
    np.testing.assert_array_equal(out[:, 0], np.roll(xr, 2, axis=1))
    np.testing.assert_array_equal(out[:, 1], np.roll(xr, 1, axis=1))
    rows = np.arange(R)
    src = np.where(rows % 2 == 0, rows + 1, (rows - 3) % R)
    np.testing.assert_array_equal(out[:, 2], xr[:, src])


# ── i16ops ──────────────────────────────────────────────────────────────────

I16_BODIES = {
    "max": lambda x, y: jnp.maximum(x, y),
    "lt": lambda x, y: (x < y).astype(jnp.int16),
    "eq": lambda x, y: (x == y).astype(jnp.int16),
    "select": lambda x, y: jnp.where(x < y, x, y),
    "sra15": lambda x, y: lax.shift_right_arithmetic(x - y, jnp.int16(15)),
    "bitsel": lambda x, y: (
        (lax.shift_right_arithmetic(y - x - 1, jnp.int16(15)) & x)
        | (~lax.shift_right_arithmetic(y - x - 1, jnp.int16(15)) & y)
    ),
}


def _pallas_i16(body, x, y):
    def kernel(x_ref, y_ref, out_ref):
        out_ref[:, :] = body(x_ref[:, :], y_ref[:, :]).astype(jnp.int32)

    call = pl.pallas_call(
        kernel, in_specs=[_spec(R), _spec(R)], out_specs=_spec(R),
        out_shape=jax.ShapeDtypeStruct((R, C), jnp.int32), interpret=True,
    )
    return np.asarray(call(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("op", sorted(I16_BODIES))
@pytest.mark.parametrize("values", ["probe", "wide"])
def test_i16op_plain_version_matches_pallas_interpret(op, values):
    """`probe` is the TPU probe's x = i % 97, y = 7i % 89; `wide` spans all
    of int16, so the differences wrap and the equal pairs are rare, and a
    few are planted."""
    x, y, z = i16ops.inputs(1, "cpu", values)
    if values == "wide":
        y = y.clone()
        y[::5, ::3] = x[::5, ::3]
    want = _pallas_i16(I16_BODIES[op], x.numpy(), y.numpy())
    got = i16ops.i16op(op, x, y)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_i16op_probe_inputs_are_the_tpu_probe_s():
    x, y, _ = i16ops.inputs(1, "cpu", "probe")
    want_x = np.arange(R * C, dtype=np.int16).reshape(R, C) % 97
    want_y = (np.arange(R * C, dtype=np.int16).reshape(R, C) * 7) % 89
    np.testing.assert_array_equal(x.numpy(), want_x)
    np.testing.assert_array_equal(y.numpy(), want_y)


def _numpy_i16(op, x, y, z, iters):
    """numpy's int16 arithmetic, step by step: the op, then the chain."""
    def ap(a, b):
        with np.errstate(over="ignore"):
            return {
                "max": lambda: np.maximum(a, b),
                "lt": lambda: (a < b).astype(np.int16),
                "eq": lambda: (a == b).astype(np.int16),
                "select": lambda: np.where(a < b, a, b),
                "sra15": lambda: (a - b) >> 15,
                "bitsel": lambda: (((b - a - np.int16(1)) >> 15) & a) | (~((b - a - np.int16(1)) >> 15) & b),
                "dpx": lambda: np.maximum(a + b, z),
            }[op]().astype(np.int16)

    r, yy = ap(x, y), y
    for _ in range(iters):
        yy = (yy + r).astype(np.int16)
        r = ap(r, yy)
    return r.astype(np.int32)


@pytest.mark.parametrize("op", i16ops.OPS)
def test_i16op_chain_and_dpx_against_numpy(op):
    """The chain (iters > 0) and the dpx body have no TPU counterpart: hold
    them to numpy's int16 arithmetic, step by step."""
    x, y, z = (t.numpy() for t in i16ops.inputs(1, "cpu", "sum" if op == "dpx" else "wide"))
    iters = 0 if op == "dpx" else 3
    got = i16ops.i16op(op, *i16ops.inputs(1, "cpu", "sum" if op == "dpx" else "wide"), iters)
    np.testing.assert_array_equal(got.numpy(), _numpy_i16(op, x, y, z, iters))


@pytest.mark.parametrize("op", i16ops.OPS)
def test_i16op_takes_tails_and_offset_views(op):
    """The inputs the element pass cannot take whole: a word count that is no
    multiple of four (words past the last 16-byte vector) and a view offset
    by 4 bytes (no 16-byte access at all).  The wrapper accepts both and, on
    the CPU, equals numpy; check() runs the same inputs on the card."""
    sets = i16ops.check_inputs(op, "cpu")
    whole = sets[1][0]
    tail, view = sets[2][0], sets[3][0]
    assert tail.dim() == 1 and (tail.numel() // 2) % 4 != 0 and tail.numel() % 2 == 0
    assert tail.data_ptr() == whole.data_ptr()
    assert view.data_ptr() - whole.data_ptr() == 4 and view.is_contiguous()
    assert (view.numel() // 2) % 4 != 0
    for x, y, z in sets[2:]:
        got = i16ops.i16op(op, x, y, z)
        assert got.shape == x.shape and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _numpy_i16(op, x.numpy(), y.numpy(), z.numpy(), 0))
    # 2 bytes off a word, or an odd count: the kernel reads 32-bit words
    flat = whole.reshape(-1)
    with pytest.raises(ValueError, match="4 bytes"):
        i16ops.i16op(op, flat[1:9], flat[1:9], flat[1:9])
    with pytest.raises(ValueError, match="even"):
        i16ops.i16op(op, flat[:7], flat[:7], flat[:7])


def test_i16ops_check_on_cpu_is_exact():
    assert i16ops.check("cpu") == {op: 0 for op in i16ops.OPS}


# ── roll ────────────────────────────────────────────────────────────────────


def _pallas_roll(mode, x, steps):
    def kernel(x_ref, out_ref):
        def step(i, x):
            if mode == "roll":
                y = pltpu.roll(x, 1, axis=0)
            elif mode == "concat":
                y = jnp.concatenate([x[-1:], x[:-1]], axis=0)
            else:
                y = x
            return y + 1

        out_ref[:, :] = lax.fori_loop(0, steps, step, x_ref[:, :])

    call = pl.pallas_call(
        kernel, in_specs=[_spec(R)], out_specs=_spec(R),
        out_shape=jax.ShapeDtypeStruct((R, C), jnp.int32), interpret=True,
    )
    return np.asarray(call(jnp.asarray(x)))


# the port's mode beside the TPU body's
ROLL_MODES = {"add": "add", "shfl": "roll", "smem": "concat"}


@pytest.mark.parametrize("mode", roll.MODES)
@pytest.mark.parametrize("values", ["probe", "wide"])
@pytest.mark.parametrize("steps", [roll.STEPS, 37])
def test_roll_plain_version_matches_pallas_interpret(mode, values, steps):
    x = roll.inputs(1, "cpu", values)[0].contiguous()
    want = _pallas_roll(ROLL_MODES[mode], x.numpy(), steps)
    got = roll.roll_steps(mode, x, steps)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", roll.MODES)
def test_roll_closed_form_matches_the_loop(mode):
    x = roll.inputs(2, "cpu", "wide")
    for steps in (0, 1, 63, 64, 70):
        assert torch.equal(roll.roll_steps_reference(mode, x, steps),
                           roll.roll_steps_loop(mode, x, steps))
    assert roll.check("cpu") == {m: 0 for m in roll.MODES}


# ── the wrappers ────────────────────────────────────────────────────────────


def test_wrappers_count_and_check_their_inputs():
    for mod in (bitcast, i16ops, roll):
        mod.reset_counters()
    xb = bitcast.inputs(1, "cpu")
    bitcast.bitcast_rolls(xb)
    x, y, z = i16ops.inputs(1, "cpu")
    i16ops.i16op("dpx", x, y, z)
    xr = roll.inputs(1, "cpu")
    roll.roll_steps("smem", xr, 5)
    assert bitcast.REFERENCE_CALLS == {"probe_bitcast": 1}
    assert i16ops.REFERENCE_CALLS["probe_i16_dpx"] == 1
    assert roll.REFERENCE_CALLS["probe_roll_smem"] == 1
    for mod in (bitcast, i16ops, roll):
        assert not any(mod.LAUNCHES.values())

    with pytest.raises(ValueError):
        bitcast.bitcast_rolls(xb.int())
    with pytest.raises(ValueError):
        bitcast.bitcast_rolls(xb[:, :32].contiguous())
    with pytest.raises(ValueError):
        i16ops.i16op("min", x, y)
    with pytest.raises(ValueError):
        i16ops.i16op("max", x, y[:-1].contiguous())
    with pytest.raises(ValueError):
        i16ops.i16op("max", x.int(), y.int())
    with pytest.raises(ValueError):
        roll.roll_steps("concat", xr, 5)
    with pytest.raises(ValueError):
        roll.roll_steps("add", xr.long(), 5)
    with pytest.raises(ValueError):
        roll.roll_steps("add", xr, -1)


def test_probes_need_the_card(monkeypatch):
    """The entry points run on the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (bitcast, i16ops, roll):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])
