"""int16x2 packing probe of the card: `python -m savont_tpu_torch.probes.bitcast`.

The port of the JAX package's TPU probe scripts/pallas_probe_bitcast.py.  An
int16 (64, 128) tile is read as (32, 128) 32-bit words, the low half of word
m being row 2m and the high half row 2m+1, and rolled along the rows three
ways (ops/csrc/probe_bitcast.cu):

  rows   0..63   by 2 rows, as a roll by 1 of the word column;
  rows  64..127  by 1 row, formula A: (w << 16) | (roll(w, 1) >>> 16);
  rows 128..191  formula B, the opposite pairing: (w >>> 16) | (roll(w, 1) << 16).

The pairing is part of the function: with it, formula A is the roll by 1 and
formula B is not.  `check()` reports both, as the TPU probe printed them.
`bitcast_rolls` is the wrapper (plain version for CPU tensors, kernel or
raise for CUDA tensors); `bitcast_rolls_reference` is the plain PyTorch
version.  The probe prints one JSON line; with `--sass DIR` it also writes the
kernels' SASS there and reports the opcode counts of this kernel's whole body
(its loop over four word rows is unrolled): what the two formulas compile to
(one SHF per formula-A word, one PRMT per formula-B word, beside the PRMTs
that zip two rows into words and back), and how wide its loads and stores
are.
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
    HBM_BYTES_PER_S, QUEUED_RUNS, dump_sass, in_turns, launch_ms, loops_of, sass_bodies,
)

ROWS, COLS = 64, 128
CARD_TILES = 2048   # tiles of the timed run: 32 MB in, 96 MB out
SEED = 11

LAUNCHES = {"probe_bitcast": 0}
REFERENCE_CALLS = {"probe_bitcast": 0}


def reset_counters() -> None:
    LAUNCHES["probe_bitcast"] = 0
    REFERENCE_CALLS["probe_bitcast"] = 0


def bitcast_rolls(x: torch.Tensor) -> torch.Tensor:
    """x int16 (64, 128) or (tiles, 64, 128) -> int16 (192, 128) or
    (tiles, 192, 128): the three rolls above.  CPU tensors take the plain
    PyTorch version; CUDA tensors launch the kernel or raise.  The kernel
    reads 16-byte vectors, so a CUDA view whose storage is not 16-byte
    aligned is refused."""
    if x.dtype != torch.int16 or x.dim() not in (2, 3) or tuple(x.shape[-2:]) != (ROWS, COLS) \
            or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous int16 tensor of shape ([tiles,] {ROWS}, "
                         f"{COLS}), got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        REFERENCE_CALLS["probe_bitcast"] += 1
        return bitcast_rolls_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x: the kernel needs 16-byte aligned storage "
                         f"(data_ptr() % 16 == {x.data_ptr() % 16})")
    lib = build_kernels()
    tiles = x.shape[0] if x.dim() == 3 else 1
    out = torch.empty((*x.shape[:-2], 3 * ROWS, COLS), dtype=torch.int16, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.probe_bitcast_launch(x.data_ptr(), out.data_ptr(), tiles,
                                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_bitcast kernel launch failed: CUDA error {rc}")
    LAUNCHES["probe_bitcast"] += 1
    return out


def _halves(w: torch.Tensor) -> torch.Tensor:
    """int32 words (..., 32, 128) -> int16 rows (..., 64, 128): row 2m the
    low half of word m, row 2m+1 its high half."""
    lo = w & 0xFFFF
    hi = (w >> 16) & 0xFFFF
    rows = torch.stack([lo, hi], dim=-2)  # (..., 32, 2, 128)
    rows = (rows ^ 0x8000) - 0x8000       # the 16-bit pattern as a signed value
    return rows.reshape(*w.shape[:-2], ROWS, COLS).to(torch.int16)


def bitcast_rolls_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: pack the row pairs into int32 words, roll the
    words with torch.roll, shift and or (int32 << wraps; >>> is >> and a mask)."""
    xi = x.to(torch.int32) & 0xFFFF
    w = (xi[..., 1::2, :] << 16) | xi[..., 0::2, :]
    wr = torch.roll(w, 1, dims=-2)
    ya = (w << 16) | ((wr >> 16) & 0xFFFF)
    yb = ((w >> 16) & 0xFFFF) | (wr << 16)
    return torch.cat([_halves(wr), _halves(ya), _halves(yb)], dim=-2)


def inputs(tiles: int, device, values: str = "probe") -> torch.Tensor:
    """`probe`: the TPU probe's input, row index in every column; `wide`:
    every int16 value, from a fixed seed."""
    if values == "probe":
        x = np.broadcast_to(np.arange(ROWS, dtype=np.int16)[None, :, None], (tiles, ROWS, COLS))
    else:
        x = np.random.default_rng(SEED).integers(-2**15, 2**15, (tiles, ROWS, COLS)).astype(np.int16)
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def check(device="cuda") -> dict:
    """Kernel against plain version (max |difference|, over the probe's one
    (64, 128) tile, five wide tiles, whose last block of two is half empty,
    and their middle three as a view that starts a tile into the storage;
    measure() compares the card-sized run), and what the TPU probe printed:
    whether the word roll is the roll by 2 and whether formulas A and B are
    the roll by 1."""
    err = 0
    wide = inputs(5, device, "wide")
    for x in (inputs(1, device, "probe")[0], wide, wide[1:4]):
        got = bitcast_rolls(x)
        err = max(err, int((got.long() - bitcast_rolls_reference(x).long()).abs().max()))
    parts = got.reshape(-1, 3, ROWS, COLS)  # the wide input: every row differs
    return {
        "max_abs_err": err,
        "even_ok": bool(torch.equal(parts[:, 0], torch.roll(x, 2, dims=-2))),
        "formula_a_ok": bool(torch.equal(parts[:, 1], torch.roll(x, 1, dims=-2))),
        "formula_b_ok": bool(torch.equal(parts[:, 2], torch.roll(x, 1, dims=-2))),
    }


def measure(device="cuda") -> dict:
    """Kernel, plain version in turns on one tile and on CARD_TILES tiles,
    their outputs compared (max_abs_err): "ms" and "plain_ms" are means over
    QUEUED_RUNS launches queued back to back, "single_ms" one launch between
    its two events, which holds the wrapper's host time too; the bound is
    the run's bytes over the card's memory rate (no single PyTorch call
    computes the three rolls)."""
    res = {}
    for where, tiles in (("tile", 1), ("card", CARD_TILES)):
        x = inputs(tiles, device, "wide")
        r = in_turns(lambda: bitcast_rolls(x), lambda: bitcast_rolls_reference(x),
                     runs=QUEUED_RUNS)
        r["single_ms"] = launch_ms(lambda: bitcast_rolls(x))
        r["tiles"] = tiles
        r["bytes"] = tiles * ROWS * COLS * 2 * 4  # 1 tile in, 3 out, int16
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        res[where] = r
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m savont_tpu_torch.probes.bitcast",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", metavar="DIR", type=Path, default=None,
                    help="also write the kernels' SASS to DIR and report this kernel's opcode counts")
    ns = ap.parse_args(argv)
    dev = resolve_device("cuda")
    chk = check(dev)
    if chk["max_abs_err"] or not (chk["even_ok"] and chk["formula_a_ok"]) or chk["formula_b_ok"]:
        raise AssertionError(f"bitcast probe: expected exact, A right, B wrong: {chk}")
    rec = {"device": torch.cuda.get_device_name(dev), **chk, **measure(dev)}
    if any(r["max_abs_err"] for r in (rec["tile"], rec["card"])):
        raise AssertionError(f"bitcast kernel differs from its plain version in the timed runs: {rec}")
    if ns.sass is not None:
        rec["sass_body"] = loops_of(sass_bodies(dump_sass(ns.sass)), "probe_bitcast")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
