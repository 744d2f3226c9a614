"""Row-rotate probe of the card: `python -m savont_tpu_torch.probes.roll`.

The port of the JAX package's TPU probe scripts/pallas_probe_roll.py: an
int32 (64, 128) tile and N = 2,000 dependent steps of

  x = roll(x, 1, axis 0) + 1      (modes shfl and smem)
  x = x + 1                       (mode add, the baseline)

in one launch (ops/csrc/probe_roll.cu), in kernel 1's layout: a thread
holds k consecutive rows of a column in registers (k = 2, 4, 8; kernel 1
holds 2 band cells a lane at band 48, 4 at band 128), so a roll is a
register move folded into the add plus one edge value from the lane below:
by one lane shuffle (`shfl`) or through shared memory (`smem`).  Both
return roll(x, N % 64, 0) + N.  The question is what kernel 1 pays to move
its band by one cell per DP row: the probe reports microseconds per step
per mode and k, on one tile (the TPU probe's shape: the latency of a step)
and on CARD_TILES independent tiles (the card full), and the cost of a roll
over `add` at the same k, which at k = 2 and 4 is kernel 1's band shift at
band 48 and 128.

`roll_steps` is the wrapper (plain version for CPU tensors, kernel or raise
for CUDA tensors); `roll_steps_reference` is the plain PyTorch version, the
closed form, and `roll_steps_loop` the step-by-step loop it is held to at
small N.  The probe prints one JSON line; with `--sass DIR` it also writes
the kernels' SASS there (the step loop's counts are in the line either way).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.build import build_kernels
from .roofline import (
    DISPATCH_LANES_PER_SM, QUEUED_RUNS, bound, dump_sass, in_turns, launch_ms, max_sm_clock_hz,
    sass_listing, sass_loops,
)

MODES = ("add", "shfl", "smem")
KS = (2, 4, 8)      # rows a thread holds
ROWS, COLS = 64, 128
STEPS = 2000        # as the TPU probe
# 66 tiles: at k = 2 a tile is 4,096 threads, so 66 tiles are the 270,336
# threads the card holds at once (132 SMs x 2,048); k = 4 and 8 fill a half
# and a quarter of those slots with the same work
CARD_TILES = 66
SEED = 17
CHECK_STEPS = (0, 1, 37, 63, 64, 65, STEPS)
# The floors beside the bound, per SM and clock.  Lane shuffles: 32 results
# per clock (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, "warp shuffle", compute capability 9.0).  Shared memory: 32
# banks of 4 bytes per clock (the guide's shared-memory section, which 9.0
# takes from 8.x).  Issue: 4 warp instructions per clock
# (roofline.DISPATCH_LANES_PER_SM lanes).  The clock is the largest SM clock
# nvidia-smi reads (roofline.max_sm_clock_hz)
SHFL_LANES_PER_CLK_PER_SM = 32
SMEM_BYTES_PER_CLK_PER_SM = 128
# steps a loop trip of the kernel (probe_roll.cu kTrip)
TRIP_STEPS = 8

LAUNCHES = {f"probe_roll_{m}": 0 for m in MODES}
REFERENCE_CALLS = {f"probe_roll_{m}": 0 for m in MODES}


def reset_counters() -> None:
    for d in (LAUNCHES, REFERENCE_CALLS):
        for k in d:
            d[k] = 0


def roll_steps(mode: str, x: torch.Tensor, steps: int = STEPS, k: int = 8) -> torch.Tensor:
    """`steps` dependent steps of mode `mode` over x int32 (64, 128) or
    (tiles, 64, 128), k rows a thread; int32, same shape.  CPU tensors take
    the plain PyTorch version (whatever k); CUDA tensors launch the kernel
    or raise."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if k not in KS:
        raise ValueError(f"k {k!r} not in {KS}")
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
        rc = lib.probe_roll_launch(MODES.index(mode), k, x.data_ptr(), out.data_ptr(), tiles,
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
    """max |kernel - plain version| per mode over every k: the probe's tile
    at N = 2,000, and wide values on one tile and on three at every N of
    CHECK_STEPS."""
    cases = [("probe", 1, STEPS)] + [("wide", t, n) for t in (1, 3) for n in CHECK_STEPS]
    err = {}
    for mode in MODES:
        e = 0
        for values, tiles, steps in cases:
            x = inputs(tiles, device, values)
            x = x[0] if tiles == 1 else x
            want = roll_steps_reference(mode, x, steps)
            for k in KS:
                e = max(e, int((roll_steps(mode, x, steps, k).long() - want.long()).abs().max()))
        err[mode] = e
    return err


def floors(mode: str, k: int, tiles: int, steps: int, sms: int, clock_hz: float,
           trip_instructions: int) -> dict:
    """What the design costs beside the bound, in ms: the shuffle pipe's
    time for one lane shuffle per k element-steps (shfl), shared memory's
    for a 4-byte store and load per k (smem), 0 where the mode has none;
    and the issue of `trip_instructions` (the SASS of one loop trip,
    TRIP_STEPS steps of k elements) per TRIP_STEPS * k element-steps."""
    per_ms = sms * clock_hz / 1e3
    el_steps = tiles * ROWS * COLS * steps
    return {
        "shfl_floor_ms": el_steps / k / (SHFL_LANES_PER_CLK_PER_SM * per_ms) if mode == "shfl" else 0.0,
        "smem_floor_ms": el_steps * 8 / k / (SMEM_BYTES_PER_CLK_PER_SM * per_ms)
        if mode == "smem" else 0.0,
        "issue_floor_ms": el_steps * trip_instructions / (TRIP_STEPS * k)
        / (DISPATCH_LANES_PER_SM * per_ms),
    }


def trip_counts(listing: str) -> dict[tuple[str, int], dict]:
    """Per (mode, k), the step loop of probe_roll_kernel<k, mode> in a
    cuobjdump -sass listing: instructions per trip (TRIP_STEPS steps),
    opcode counts, and the chain's instructions among them, TRIP_STEPS * k
    when no step was merged into another."""
    out = {}
    for name, loops in sass_loops(listing).items():
        m = re.search(r"probe_roll_kernelILi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        steps = [lp for lp in loops if lp["instructions"] > 1]  # not the self-branch at the end
        if len(steps) != 1:
            raise AssertionError(f"{name}: expected one step loop, found {loops}")
        # the chain's one instruction per element-step: IMAD x * one + one
        # (not IMAD.MOV and the like) or VIADDMNMX max(x + one, lo)
        chain = sum(n for op, n in steps[0]["opcodes"].items()
                    if op == "IMAD" or op.startswith("VIADDMNMX"))
        out[(MODES[int(m.group(2))], int(m.group(1)))] = {**steps[0], "chain": chain}
    return out


def best(res: dict, mode: str, where: str = "card") -> tuple[int, dict]:
    """The k of least queued time in measure()'s result, and its record."""
    k = min(KS, key=lambda k: res[where][mode][k]["ms"])
    return k, res[where][mode][k]


def measure(device="cuda", listing: str | None = None) -> dict:
    """Per mode and k, N = 2,000 steps on one tile and on CARD_TILES tiles:
    kernel and plain version in turns, their outputs compared (max_abs_err):
    "ms", "plain_ms" and "library_ms" are means over QUEUED_RUNS launches
    queued back to back, "single_ms" (and "single_library_ms") one launch
    between its two events, which holds the wrapper's host time too.  The
    library call of `add` is torch.add(x, N), the closed form: it skips the
    N steps that the probe exists to time, so it is no yardstick for the
    mode.  No single PyTorch call computes roll(x, N % 64, 0) + N;
    torch.roll(x, N % 64, 0) alone, the rotation without the + N, is
    timed as `torch_roll_ms`.  The bound counts the N steps per element,
    one instruction each, at the card's dispatch rate, and the tile's bytes
    once in and once out; the floors (see `floors`) stand beside it, the
    issue floor from the step loop's SASS (`listing`, cuobjdump's, read
    here when not given).
    `us_per_step` is the kernel's time over N, `roll_cost_us` that of a
    mode minus `add`'s at the same k.  Records: res[where][mode][k]."""
    dev = resolve_device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_hz()
    peak = sms * DISPATCH_LANES_PER_SM * clock
    trips = trip_counts(sass_listing() if listing is None else listing)
    res: dict = {"steps": STEPS, "card_tiles": CARD_TILES, "ks": list(KS), "sms": sms,
                 "max_sm_clock_hz": clock,
                 "step_loops": {f"{m}_k{k}": v for (m, k), v in sorted(trips.items())}}
    for where, tiles in (("tile", 1), ("card", CARD_TILES)):
        x = inputs(tiles, dev, "probe")
        n = x.numel()
        rec = res[where] = {"torch_roll_ms": launch_ms(lambda: torch.roll(x, STEPS % ROWS, dims=-2))}
        for mode in MODES:
            rec[mode] = {}
            library = (lambda: torch.add(x, STEPS)) if mode == "add" else None
            for k in KS:
                t = in_turns(lambda: roll_steps(mode, x, k=k), lambda: roll_steps_reference(mode, x),
                             library, runs=QUEUED_RUNS)
                trip = trips[(mode, k)]
                rec[mode][k] = {
                    **t, "single_ms": launch_ms(lambda: roll_steps(mode, x, k=k)),
                    "single_library_ms": launch_ms(library) if library is not None else None,
                    "us_per_step": t["ms"] * 1e3 / STEPS, **bound(n * STEPS, 2 * 4 * n, peak),
                    **floors(mode, k, tiles, STEPS, sms, clock, trip["instructions"]),
                    "trip_instructions": trip["instructions"], "trip_chain": trip["chain"]}
        for mode in MODES[1:]:
            for k in KS:
                rec[mode][k]["roll_cost_us"] = rec[mode][k]["us_per_step"] - rec["add"][k]["us_per_step"]
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m savont_tpu_torch.probes.roll",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", metavar="DIR", type=Path, default=None,
                    help="also write the kernels' SASS and innermost-loop opcode counts to DIR")
    ns = ap.parse_args(argv)
    dev = resolve_device("cuda")
    err = check(dev)
    if any(err.values()):
        raise AssertionError(f"roll kernels differ from their plain versions: {err}")
    listing = dump_sass(ns.sass) if ns.sass is not None else None
    rec = {"device": torch.cuda.get_device_name(dev), "max_abs_err": err, **measure(dev, listing)}
    timed_err = {m: max(rec[w][m][k]["max_abs_err"] for w in ("tile", "card") for k in KS)
                 for m in MODES}
    if any(timed_err.values()):
        raise AssertionError(f"roll kernels differ from their plain versions in the timed runs: {timed_err}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
