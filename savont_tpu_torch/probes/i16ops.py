"""16-bit SIMD-in-a-word probe of the card: `python -m savont_tpu_torch.probes.i16ops`.

The port of the JAX package's TPU probe scripts/pallas_probe_i16ops.py: six
int16 operations on (64, 128) tiles x, y, widened to int32, and a seventh
for the DPX three-input form (ops/csrc/probe_i16ops.cu):

  max     maximum(x, y)                    lt      (x < y) as 0 / 1
  eq      (x == y) as 0 / 1                select  where(x < y, x, y)
  sra15   (x - y) >> 15, arithmetic, on the wrapping int16 difference
  bitsel  m = (y - x - 1) >> 15;  (m & x) | (~m & y)
  dpx     maximum(x + y, z), wrapping int16 sum

With iters > 0 the same function is a dependent chain, which the timed runs
use:  r = op(x, y, z);  iters times:  y = y + r;  r = op(r, y, z).

`i16op` is the wrapper (plain version for CPU tensors, kernel or raise for
CUDA tensors); `i16op_reference` is the plain PyTorch version on int16
tensors, whose + and - wrap as the kernel's do.  The TPU probe asked whether
the compiler takes each operation; on this card all compile, so the probe
checks every kernel against its plain version (exact), times it, and with
`--sass DIR` counts the instructions of each timed loop: whether an
operation is one instruction or a sequence.  It prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.build import build_kernels
from .roofline import (
    QUEUED_RUNS, bound, dump_sass, in_turns, launch_ms, loops_of, published_dispatch_rate,
    sass_loops,
)

OPS = ("max", "lt", "eq", "select", "sra15", "bitsel", "dpx")
ROWS, COLS = 64, 128
CARD_TILES = 2048                # tiles of the elementwise timed run
CHAIN_ITERS = (4096, 65536)      # the difference method's two counts
CHECK_ITERS = (0, 3)
SEED = 13

LAUNCHES = {f"probe_i16_{k}": 0 for k in OPS}
REFERENCE_CALLS = {f"probe_i16_{k}": 0 for k in OPS}
# the one PyTorch call that computes an op's function (where(x < y, x, y) is
# minimum(x, y)), writing into an int32 `out` so that the widening is part of
# the call; none for the others
LIBRARY = {"max": torch.maximum, "lt": torch.lt, "eq": torch.eq, "select": torch.minimum}


def reset_counters() -> None:
    for d in (LAUNCHES, REFERENCE_CALLS):
        for k in d:
            d[k] = 0


def i16op(op: str, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor | None = None,
          iters: int = 0, threads: int = 256) -> torch.Tensor:
    """Operation `op` over int16 tensors x, y (and z for dpx) of one shape
    with an even count, storage aligned to 4 bytes: int32, same shape.  CPU
    tensors take the plain PyTorch version; CUDA tensors launch the kernel
    or raise.  At iters 0 the kernel reads 16-byte vectors where the
    storage of all three is aligned to 16 bytes, and single words past the
    last whole vector or on any other alignment."""
    if op not in OPS:
        raise ValueError(f"op {op!r} not in {OPS}")
    if z is None:
        z = y
    for name, t in (("x", x), ("y", y), ("z", z)):
        if t.dtype != torch.int16 or not t.is_contiguous() or t.shape != x.shape \
                or t.device != x.device:
            raise ValueError(f"{name}: expected a contiguous int16 tensor of shape "
                             f"{tuple(x.shape)} on {x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: the kernel reads 32-bit words; storage not aligned to 4 bytes")
    if x.numel() % 2 or iters < 0 or not 32 <= threads <= 1024:
        raise ValueError(f"element count {x.numel()} must be even, iters {iters} >= 0, "
                         f"threads {threads} in 32..1024")
    key = f"probe_i16_{op}"
    if x.device.type == "cpu":
        REFERENCE_CALLS[key] += 1
        return i16op_reference(op, x, y, z, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = build_kernels()
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.probe_i16ops_launch(
            OPS.index(op), x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(),
            x.numel(), iters, threads, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe_i16ops kernel launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return out


def _apply(op: str, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One operation on int16 tensors (int16 +, - wrap modulo 2^16)."""
    if op == "max":
        return torch.maximum(a, b)
    if op == "lt":
        return (a < b).to(torch.int16)
    if op == "eq":
        return (a == b).to(torch.int16)
    if op == "select":
        return torch.where(a < b, a, b)
    if op == "sra15":
        return (a - b) >> 15
    if op == "bitsel":
        m = (b - a - 1) >> 15
        return (m & a) | (~m & b)
    return torch.maximum(a + b, c)


def i16op_reference(op: str, x, y, z, iters: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the operation, then the chain of `iters` steps."""
    r = _apply(op, x, y, z)
    for _ in range(iters):
        y = y + r
        r = _apply(op, r, y, z)
    return r.to(torch.int32)


def inputs(tiles: int, device, values: str = "probe") -> tuple[torch.Tensor, ...]:
    """x, y, z int16 (tiles * 64, 128).  `probe`: the TPU probe's x = i % 97,
    y = 7i % 89 (its int16 arithmetic, over the tile) and z = 3i % 83;
    `wide`: every int16 value from a fixed seed; `sum`: values below 2^14 in
    size, whose sums do not leave int16."""
    n = tiles * ROWS * COLS
    if values == "probe":
        i = np.arange(ROWS * COLS, dtype=np.int16)
        x, y, z = (np.tile(v, tiles) for v in (i % 97, (i * np.int16(7)) % 89, (i * np.int16(3)) % 83))
    else:
        lim = 2**15 if values == "wide" else 2**14
        rng = np.random.default_rng(SEED)
        x, y, z = (rng.integers(-lim, lim, n).astype(np.int16) for _ in range(3))
    dev = resolve_device(device)
    return tuple(torch.from_numpy(v.astype(np.int16).reshape(tiles * ROWS, COLS)).to(dev)
                 for v in (x, y, z))


def check_inputs(op: str, device) -> list[tuple[torch.Tensor, ...]]:
    """The (x, y, z) sets check() runs: the probe's inputs on its one
    (64, 128) tile; wide ones on two tiles; a flat slice of those whose
    word count is no multiple of four (the element pass takes the whole
    16-byte vectors, the word-wise kernel the rest); and a view of them
    offset by 4 bytes, which no 16-byte access may touch.  dpx takes the
    `sum` inputs instead of the wide ones."""
    wide = inputs(2, device, "sum" if op == "dpx" else "wide")
    flat = [v.reshape(-1) for v in wide]
    return [inputs(1, device, "probe"), wide,
            tuple(v[: 8 * 1021 + 6] for v in flat),
            tuple(v[2 : 2 + 8 * 515 + 2] for v in flat)]


def check(device="cuda") -> dict[str, int]:
    """max |kernel - plain version| per op over check_inputs (measure()
    compares the card-sized run), at iters 0 (the TPU body) and 3 (the
    chain).  dpx takes no chain: what __viaddmax_s16x2 does with a sum that
    leaves int16 is not part of the function."""
    err = {}
    for op in OPS:
        e = 0
        for x, y, z in check_inputs(op, device):
            for iters in ((0,) if op == "dpx" else CHECK_ITERS):
                got = i16op(op, x, y, z, iters)
                e = max(e, int((got.long() - i16op_reference(op, x, y, z, iters).long()).abs().max()))
        err[op] = e
    return err


def measure(device="cuda") -> dict:
    """Per op: the elementwise function (iters 0) on one tile and on
    CARD_TILES tiles, kernel and plain version in turns and the library call
    where there is one, their outputs compared (max_abs_err; the library
    call's must equal the plain version's), with the bound by bytes: "ms",
    "plain_ms" and "library_ms" are means over QUEUED_RUNS launches queued
    back to back, "single_ms" and "single_library_ms" one launch between its
    two events, which holds the wrapper's host time too, "wordwise_ms" the
    queued mean on a view offset by 4 bytes, which the word-wise kernel
    takes whole; and
    the rate of the timed chain on a full card (difference method), in
    operations per second counting the op and the add of each step."""
    dev = resolve_device(device)
    props = torch.cuda.get_device_properties(dev)
    n_chain = props.multi_processor_count * props.max_threads_per_multi_processor * 2
    peak = published_dispatch_rate(dev)
    res: dict = {"chain_iters": list(CHAIN_ITERS), "card_tiles": CARD_TILES}
    for op in OPS:
        r = {}
        for where, tiles in (("tile", 1), ("card", CARD_TILES)):
            x, y, z = inputs(tiles, dev, "sum")
            lib = LIBRARY.get(op)
            lib_out = torch.empty(x.shape, dtype=torch.int32, device=dev)
            fns = (lambda: i16op(op, x, y, z), lambda: i16op_reference(op, x, y, z),
                   (lambda: lib(x, y, out=lib_out)) if lib is not None else None)
            t = in_turns(*fns, runs=QUEUED_RUNS)
            single = in_turns(*fns)
            n = x.numel()
            nbytes = n * ((3 if op == "dpx" else 2) * 2 + 4)
            # the word-wise kernel on the same values: a view offset by 4 bytes
            xs, ys, zs = (v.reshape(-1)[2:] for v in (x, y, z))
            words = in_turns(lambda: i16op(op, xs, ys, zs), lambda: i16op_reference(op, xs, ys, zs),
                             runs=QUEUED_RUNS)
            r[where] = {**t, "max_abs_err": max(t["max_abs_err"], single["max_abs_err"],
                                                words["max_abs_err"]),
                        "single_ms": single["ms"], "single_library_ms": single["library_ms"],
                        "wordwise_ms": words["ms"], "elements": n, **bound(n, nbytes, peak)}
        # the chain: a full card of words, one per thread
        cx = torch.from_numpy(np.random.default_rng(SEED).integers(
            -2**14, 2**14, (3, n_chain)).astype(np.int16)).to(dev)
        it1, it2 = CHAIN_ITERS
        t1 = launch_ms(lambda: i16op(op, cx[0], cx[1], cx[2], it1))
        t2 = launch_ms(lambda: i16op(op, cx[0], cx[1], cx[2], it2))
        ops_per_s = 2 * (n_chain // 2) * (it2 - it1) / ((t2 - t1) * 1e-3)  # op + add per step
        r["chain"] = {"words": n_chain // 2, "ms": [t1, t2],
                      "tops": ops_per_s / 1e12, "tvalues": 2 * ops_per_s / 1e12}
        res[op] = r
    res["published_dispatch_tops"] = peak / 1e12
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m savont_tpu_torch.probes.i16ops",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", metavar="DIR", type=Path, default=None,
                    help="also write the kernels' SASS and innermost-loop opcode counts to DIR")
    ns = ap.parse_args(argv)
    dev = resolve_device("cuda")
    err = check(dev)
    if any(err.values()):
        raise AssertionError(f"i16ops kernels differ from their plain versions: {err}")
    rec = {"device": torch.cuda.get_device_name(dev), "max_abs_err": err, **measure(dev)}
    timed_err = {op: max(rec[op][w]["max_abs_err"] for w in ("tile", "card")) for op in OPS}
    if any(timed_err.values()):
        raise AssertionError(f"i16ops kernels differ from their plain versions in the timed runs: {timed_err}")
    if ns.sass is not None:
        rec["sass_inner_loops"] = loops_of(sass_loops(dump_sass(ns.sass)), "probe_i16")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
