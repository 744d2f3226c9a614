"""Row-rotate probe of the card: `python -m savont_tpu_torch.probes.roll`.

The port of the JAX package's TPU probe scripts/pallas_probe_roll.py: an
int32 (64, 128) tile and N = 2,000 dependent steps of

  x = roll(x, 1, axis 0) + 1      (modes shfl and smem)
  x = x + 1                       (mode add, the baseline)

in one launch (ops/csrc/probe_roll.cu).  `shfl` keeps a column's 64 rows in
one warp, two registers per lane, and rolls with lane shuffles; `smem` rolls
through shared memory and a barrier.  Both return roll(x, N % 64, 0) + N.
The question is what a band-across-lanes kernel 1 pays to move its band by
one lane per DP row: the probe reports microseconds per step per mode, on
one tile (the TPU probe's shape: the latency of a step) and on CARD_TILES
independent tiles (the card full), and the cost of a roll over `add`.

`roll_steps` is the wrapper (plain version for CPU tensors, kernel or raise
for CUDA tensors); `roll_steps_reference` is the plain PyTorch version, the
closed form, and `roll_steps_loop` the step-by-step loop it is held to at
small N.  The probe prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops.build import build_kernels
from .roofline import QUEUED_RUNS, bound, in_turns, launch_ms, published_dispatch_rate

MODES = ("add", "shfl", "smem")
ROWS, COLS = 64, 128
STEPS = 2000        # as the TPU probe
CARD_TILES = 66     # 132 SMs x 64 resident warps, one column per warp
SEED = 17

LAUNCHES = {f"probe_roll_{m}": 0 for m in MODES}
REFERENCE_CALLS = {f"probe_roll_{m}": 0 for m in MODES}


def reset_counters() -> None:
    for d in (LAUNCHES, REFERENCE_CALLS):
        for k in d:
            d[k] = 0


def roll_steps(mode: str, x: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """`steps` dependent steps of mode `mode` over x int32 (64, 128) or
    (tiles, 64, 128); int32, same shape.  CPU tensors take the plain PyTorch
    version; CUDA tensors launch the kernel or raise."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if x.dtype != torch.int32 or x.dim() not in (2, 3) or tuple(x.shape[-2:]) != (ROWS, COLS) \
            or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous int32 tensor of shape ([tiles,] {ROWS}, "
                         f"{COLS}), got {x.dtype} {tuple(x.shape)}")
    if steps < 0:
        raise ValueError(f"steps {steps} must be >= 0")
    key = f"probe_roll_{mode}"
    if x.device.type == "cpu":
        REFERENCE_CALLS[key] += 1
        return roll_steps_reference(mode, x, steps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = build_kernels()
    out = torch.empty_like(x)
    tiles = x.shape[0] if x.dim() == 3 else 1
    with torch.cuda.device(x.device):
        rc = lib.probe_roll_launch(MODES.index(mode), x.data_ptr(), out.data_ptr(), tiles,
                                   steps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_roll kernel launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return out


def roll_steps_reference(mode: str, x: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """Plain PyTorch version, the closed form of the chain (int32 + wraps)."""
    if mode == "add":
        return x + steps
    return torch.roll(x, steps % ROWS, dims=-2) + steps


def roll_steps_loop(mode: str, x: torch.Tensor, steps: int) -> torch.Tensor:
    """The chain step by step, as the TPU body runs it."""
    for _ in range(steps):
        x = (x if mode == "add" else torch.roll(x, 1, dims=-2)) + 1
    return x


def inputs(tiles: int, device, values: str = "probe") -> torch.Tensor:
    """`probe`: the TPU probe's arange tile, offset by the tile number;
    `wide`: every int32 value from a fixed seed, so the adds wrap."""
    if values == "probe":
        x = np.arange(ROWS * COLS, dtype=np.int32).reshape(1, ROWS, COLS) \
            + np.arange(tiles, dtype=np.int32)[:, None, None]
    else:
        x = np.random.default_rng(SEED).integers(
            -2**31, 2**31, (tiles, ROWS, COLS), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(x).to(resolve_device(device))


def check(device="cuda") -> dict[str, int]:
    """max |kernel - plain version| per mode: the probe's tile at N = 2,000,
    and three wide tiles at N = 2,000 and N = 37."""
    err = {}
    for mode in MODES:
        e = 0
        for values, tiles, steps in (("probe", 1, STEPS), ("wide", 3, STEPS), ("wide", 3, 37)):
            x = inputs(tiles, device, values)
            got = roll_steps(mode, x[0] if tiles == 1 else x, steps)
            want = roll_steps_reference(mode, x[0] if tiles == 1 else x, steps)
            e = max(e, int((got.long() - want.long()).abs().max()))
        err[mode] = e
    return err


def measure(device="cuda") -> dict:
    """Per mode, N = 2,000 steps on one tile and on CARD_TILES tiles: kernel
    and plain version in turns, their outputs compared (max_abs_err): "ms",
    "plain_ms" and "library_ms" are means over QUEUED_RUNS launches queued
    back to back, "single_ms" (and "single_library_ms") one launch between
    its two events, which holds the wrapper's host time too.  The library
    call of `add` is torch.add(x, N), the whole function in one call.  No
    single PyTorch call computes roll(x, N % 64, 0) + N, so shfl and smem
    have none; torch.roll(x, N % 64, 0) alone, the rotation
    without the + N, is timed beside them as `torch_roll_ms`.
    The bound counts the N adds per element at the card's dispatch rate and
    the tile's bytes once in and once out.  `us_per_step` is the kernel's
    time over N, `roll_cost_us` that of a mode minus `add`'s."""
    dev = resolve_device(device)
    peak = published_dispatch_rate(dev)
    res: dict = {"steps": STEPS, "card_tiles": CARD_TILES}
    for where, tiles in (("tile", 1), ("card", CARD_TILES)):
        x = inputs(tiles, dev, "probe")
        n = x.numel()
        res[where] = {}
        for mode in MODES:
            library = (lambda: torch.add(x, STEPS)) if mode == "add" else None
            t = in_turns(lambda: roll_steps(mode, x), lambda: roll_steps_reference(mode, x),
                         library, runs=QUEUED_RUNS)
            res[where][mode] = {
                **t, "single_ms": launch_ms(lambda: roll_steps(mode, x)),
                "single_library_ms": launch_ms(library) if library is not None else None,
                "us_per_step": t["ms"] * 1e3 / STEPS, **bound(n * STEPS, 2 * 4 * n, peak)}
            if mode != "add":
                res[where][mode]["torch_roll_ms"] = launch_ms(
                    lambda: torch.roll(x, STEPS % ROWS, dims=-2))
        base = res[where]["add"]["us_per_step"]
        for mode in MODES[1:]:
            res[where][mode]["roll_cost_us"] = res[where][mode]["us_per_step"] - base
    return res


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(prog="python -m savont_tpu_torch.probes.roll",
                            description=__doc__.split("\n\n")[0]).parse_args(argv)
    dev = resolve_device("cuda")
    err = check(dev)
    if any(err.values()):
        raise AssertionError(f"roll kernels differ from their plain versions: {err}")
    rec = {"device": torch.cuda.get_device_name(dev), "max_abs_err": err, **measure(dev)}
    timed_err = {m: max(rec[w][m]["max_abs_err"] for w in ("tile", "card")) for m in MODES}
    if any(timed_err.values()):
        raise AssertionError(f"roll kernels differ from their plain versions in the timed runs: {timed_err}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
