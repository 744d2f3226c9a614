"""Integer roofline probe of the card: `python -m savont_tpu_torch.probes.roofline`.

The port of the JAX package's TPU probe (scripts/pallas_roofline.py).  Three
CUDA bodies (ops/csrc/roofline.cu) run int32 max/add chains in registers:

  peak  one dependent chain per element: x = max(x, y); y = y + x
  ilp   four independent chains per element (x + c, y ^ c for c = 0..3)
  swar  two 16-bit halves per int32: per-half unsigned max, per-half add
        mod 2^16 (__vmaxu2 / __vadd2)

each for `iters` iterations of 16 source operations per chain, then
out = x + y.  `roofline` is the wrapper (plain version for CPU tensors,
kernel or raise for CUDA tensors); `roofline_reference` is the plain
PyTorch version, a loop of torch.maximum and + on int32 tensors.

The probe checks every kernel against its plain version on the card at a
small count (exact, tolerance 0), then times it with CUDA events by the
difference method of the TPU probe (two iteration counts; the slope, so
launch cost drops out), on the whole card (every SM with its full
complement of resident threads) and on one SM (one block of 1,024
threads).  It prints one JSON line.  It writes no file, except with
`--sass DIR`: cuobjdump's SASS of the kernel library and the instruction
counts of every innermost loop, the count behind each rate's ops-per-
instruction reading.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.build import BUILD_INFO, build_kernels

KINDS = ("peak", "ilp", "swar")
INNER = 16   # source operations per chain per iteration, as in the TPU probe
CHAINS = 4   # independent chains of the ilp body
# source operations per element per iteration, and values per operation
OPS_PER_ITER = {"peak": INNER, "ilp": INNER * CHAINS, "swar": INNER}
VALUES_PER_OP = {"peak": 1, "ilp": 1, "swar": 2}
# thread-instructions an SM dispatches per clock: 4 warp schedulers, one
# warp instruction each (NVIDIA Hopper architecture white paper).  With the
# card's SM count and its largest SM clock, the published dispatch rate: the
# peak of a max/add mix, whose max (VIMNMX) and add (IMAD.IADD) go to two
# pipes, so the 64 INT32 lanes per SM do not bound it
DISPATCH_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

CHECK_ITERS = 5                  # exactness against the plain version
TIMED_ITERS = (4096, 65536)      # the difference method's two counts
PLAIN_ITERS = 1024               # kernel against plain version at one iteration count
QUEUED_RUNS = 20                 # launches queued back to back per timing of a short kernel
SEED = 3

LAUNCHES = {f"roofline_{k}": 0 for k in KINDS}
REFERENCE_CALLS = {f"roofline_{k}": 0 for k in KINDS}


def reset_counters() -> None:
    for d in (LAUNCHES, REFERENCE_CALLS):
        for k in d:
            d[k] = 0


def roofline(kind: str, x: torch.Tensor, y: torch.Tensor, iters: int, threads: int = 256):
    """Run roofline body `kind` over int32 vectors x, y (same shape): out
    int32, x + y after `iters` iterations.  CPU tensors take the plain
    PyTorch version; CUDA tensors launch the kernel (`threads` per block)
    or raise."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device}, y {tuple(y.shape)} on {y.device}")
    if iters < 0 or not 32 <= threads <= 1024:
        raise ValueError(f"iters {iters} must be >= 0, threads {threads} in 32..1024")
    key = f"roofline_{kind}"
    if x.device.type == "cpu":
        REFERENCE_CALLS[key] += 1
        return roofline_reference(kind, x, y, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = build_kernels()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.roofline_launch(
            KINDS.index(kind), x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
            iters, threads, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"roofline kernel launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return out


def _srl16(a: torch.Tensor) -> torch.Tensor:
    """Logical shift right by 16 of int32 values: the high half, unsigned."""
    return (a >> 16) & 0xFFFF


def roofline_reference(kind: str, x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of the three bodies, on int32 tensors of any
    shape (PyTorch's int32 + and << wrap modulo 2^32, as the kernels do)."""
    m = 0xFFFF
    if kind == "peak":
        for _ in range(iters):
            for _ in range(INNER // 2):
                x = torch.maximum(x, y)
                y = y + x
        return x + y
    if kind == "ilp":
        xs = [x + c for c in range(CHAINS)]
        ys = [y ^ c for c in range(CHAINS)]
        for _ in range(iters):
            for _ in range(INNER // 2):
                xs = [torch.maximum(a, b) for a, b in zip(xs, ys)]
                ys = [b + a for a, b in zip(xs, ys)]
        acc = xs[0] + ys[0]
        for c in range(1, CHAINS):
            acc = acc + xs[c] + ys[c]
        return acc
    if kind == "swar":
        for _ in range(iters):
            for _ in range(INNER // 2):
                lo = torch.maximum(x & m, y & m)
                x = (torch.maximum(_srl16(x), _srl16(y)) << 16) | lo
                lo = (y & m) + (x & m)
                y = ((_srl16(y) + _srl16(x)) << 16) | (lo & m)
        return x + y
    raise ValueError(f"kind {kind!r} not in {KINDS}")


def inputs(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU probe's inputs: int32 values in [0, 1000) from a fixed seed."""
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 1000, n).astype(np.int32)
    y = rng.integers(0, 1000, n).astype(np.int32)
    dev = resolve_device(device)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def card_shape(device="cuda") -> dict:
    """The launch shapes: the whole card (SMs x resident threads per SM, in
    blocks of 256) and one SM (one block of 1,024 threads)."""
    props = torch.cuda.get_device_properties(resolve_device(device))
    per_sm = props.max_threads_per_multi_processor
    return {
        "sms": props.multi_processor_count,
        "card": (props.multi_processor_count * per_sm, 256),
        "one_sm": (1024, 1024),
    }


def check(device="cuda", iters: int = CHECK_ITERS) -> dict[str, int]:
    """max |kernel - plain version| per body on the whole card's shape."""
    n, threads = card_shape(device)["card"]
    x, y = inputs(n, device)
    err = {}
    for kind in KINDS:
        got = roofline(kind, x, y, iters, threads)
        want = roofline_reference(kind, x, y, iters)
        err[kind] = int((got.long() - want.long()).abs().max())
    return err


def launch_ms(fn, reps: int = 3, runs: int = 1) -> float:
    """Best of `reps` timings, CUDA events, after one warm-up call: each the
    mean of `runs` calls queued back to back.  With runs == 1 the time
    between the two events holds the host's time inside `fn` (a wrapper's
    checks and allocation, tens of microseconds) as well as the kernel's;
    with more, the queue stays full and the mean is the kernel's own time
    as long as that exceeds the host's."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / runs)
    return best


def in_turns(kernel, plain, library=None, runs: int = 1) -> dict:
    """Times of one call each (or, with `runs`, of that many back to back)
    in the order plain, kernel, kernel, plain (the two orders of one pair),
    then the library call where there is one:
    {"ms", "plain_ms", "library_ms"}, each the better of its runs; and
    "max_abs_err", the largest |kernel - plain version| (and |library call -
    plain version|, which must be 0 for the call to count as the same
    function) over the outputs of these very inputs, so that a time never
    stands beside an output nobody compared."""
    p1 = launch_ms(plain, reps=1, runs=runs)
    k1 = launch_ms(kernel, runs=runs)
    k2 = launch_ms(kernel, runs=runs)
    p2 = launch_ms(plain, reps=1, runs=runs)
    want = plain()
    err = max_abs_err(kernel(), want)
    lib_ms = None
    if library is not None:
        lib_ms = launch_ms(library, runs=runs)
        lib_err = max_abs_err(library(), want)
        if lib_err:
            raise AssertionError(f"the library call differs from the plain version by {lib_err}")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
            "max_abs_err": err}


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """max |got - want| of two integer tensors of one shape (0 when empty)."""
    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {tuple(got.shape)} against {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def bound(ops: float, nbytes: float, ops_per_s: float) -> dict:
    """The least time for `ops` operations at `ops_per_s` and `nbytes` bytes
    at the card's memory rate: {"bound_ms", "bound_by"}."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def published_dispatch_rate(device="cuda") -> float:
    """Thread-instructions per second the card dispatches at its largest SM
    clock: SMs x DISPATCH_LANES_PER_SM x clock."""
    props = torch.cuda.get_device_properties(resolve_device(device))
    return props.multi_processor_count * DISPATCH_LANES_PER_SM * max_sm_clock_hz()


def max_sm_clock_hz() -> float:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(r.stdout.split()[0]) * 1e6


def measure(device="cuda") -> dict:
    """Rates of every body on the whole card and on one SM (difference
    method), and each kernel beside its plain version at PLAIN_ITERS, in the
    order plain, kernel, kernel, plain, one call between its two events
    each, their outputs compared (max_abs_err): "single_ms" is the kernel's
    time there, which holds the wrapper's host time too, and "ms" the mean
    of QUEUED_RUNS launches queued back to back (the plain version, a
    thousand times the kernel, is never queued)."""
    dev = resolve_device(device)
    shape = card_shape(dev)
    it1, it2 = TIMED_ITERS
    res: dict = {"sms": shape["sms"], "timed_iters": list(TIMED_ITERS),
                 "plain_iters": PLAIN_ITERS}
    for kind in KINDS:
        r = {}
        for where in ("card", "one_sm"):
            n, threads = shape[where]
            x, y = inputs(n, dev)
            t1 = launch_ms(lambda: roofline(kind, x, y, it1, threads))
            t2 = launch_ms(lambda: roofline(kind, x, y, it2, threads))
            ops_per_s = n * OPS_PER_ITER[kind] * (it2 - it1) / ((t2 - t1) * 1e-3)
            r[where] = {"threads": n, "ms": [t1, t2], "tops": ops_per_s / 1e12,
                        "tvalues": ops_per_s * VALUES_PER_OP[kind] / 1e12}
        n, threads = shape["card"]
        x, y = inputs(n, dev)
        t = in_turns(lambda: roofline(kind, x, y, PLAIN_ITERS, threads),
                     lambda: roofline_reference(kind, x, y, PLAIN_ITERS))
        r["single_ms"], r["plain_ms"], r["max_abs_err"] = t["ms"], t["plain_ms"], t["max_abs_err"]
        r["ms"] = launch_ms(lambda: roofline(kind, x, y, PLAIN_ITERS, threads), runs=QUEUED_RUNS)
        r["ops"] = n * OPS_PER_ITER[kind] * PLAIN_ITERS
        r["bytes"] = 3 * 4 * n
        res[kind] = r
    peak = published_dispatch_rate(dev)
    res["published_dispatch_tops"] = peak / 1e12
    for kind in KINDS:
        res[kind].update(bound(res[kind]["ops"], res[kind]["bytes"], peak))
    # the card's integer max/add throughput: the better of the dependent
    # chain and the independent chains (the TPU probe's rule)
    res["int32_tops"] = max(res["peak"]["card"]["tops"], res["ilp"]["card"]["tops"])
    return res


def _cuobjdump() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("cuobjdump"), os.path.join(cuda_home, "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin)")


def _sass_functions(text: str) -> tuple[dict[str, list], dict[str, int]]:
    """Per kernel of a cuobjdump -sass listing its instructions as (address,
    text without the predicate, labels seen so far), and every label's
    position in its kernel's list."""
    funcs: dict[str, list] = {}
    body: list | None = None
    labels: dict[str, int] = {}
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = funcs.setdefault(m.group(1), [])
            continue
        if body is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(body)
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m:
            ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            body.append((int(m.group(1), 16), ins, dict(labels)))
    return funcs, labels


def _opcodes(instructions) -> dict[str, int]:
    return dict(Counter(ins.split()[0] for _, ins, _ in instructions).most_common())


def sass_bodies(text: str) -> dict[str, dict]:
    """Per kernel of a cuobjdump -sass listing, the opcode counts of its whole
    body: every instruction but the NOP padding and the self-branch before
    it.  For a kernel without a loop, where sass_loops has nothing to say."""
    out = {}
    for name, body in _sass_functions(text)[0].items():
        real = [b for b in body if b[1].split()[0] != "NOP"]
        while real and real[-1][1].split()[0].startswith("BRA"):
            real.pop()
        out[name] = {"instructions": len(real), "opcodes": _opcodes(real)}
    return out


def sass_loops(text: str) -> dict[str, list[dict]]:
    """Per kernel of a cuobjdump -sass listing, the opcode counts of each
    innermost loop: a backward branch (to an address or a label) whose
    range holds no other such loop."""
    funcs, labels = _sass_functions(text)
    out = {}
    for name, body in funcs.items():
        addrs = [a for a, _, _ in body]
        loops = []
        for pos, (addr, ins, labs) in enumerate(body):
            m = re.match(r"BRA\S*\s+(?:0x([0-9a-f]+)|`\((\.L_x_\d+)\))", ins)
            if not m:
                continue
            if m.group(1) is not None:
                target = int(m.group(1), 16)
                start = addrs.index(target) if target in addrs else None
            else:
                start = labels.get(m.group(2))
            if start is not None and start <= pos:
                loops.append((start, pos))
        inner = [a for a in loops
                 if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
        out[name] = [
            {"instructions": e - s + 1, "opcodes": _opcodes(body[s : e + 1])}
            for s, e in inner
        ]
    return out


def sass_listing() -> str:
    """cuobjdump's SASS of the kernel library, built first if need be."""
    build_kernels()
    r = subprocess.run([_cuobjdump(), "-sass", BUILD_INFO["path"]],
                       capture_output=True, text=True, timeout=300, check=True)
    return r.stdout


def dump_sass(out_dir: Path) -> str:
    """Write cuobjdump's SASS of the kernel library to out_dir, with
    sass_loops and sass_bodies of it, and return the listing."""
    listing = sass_listing()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "kernels.sass").write_text(listing)
    (out_dir / "sass_loops.json").write_text(json.dumps(sass_loops(listing), indent=1))
    (out_dir / "sass_bodies.json").write_text(json.dumps(sass_bodies(listing), indent=1))
    return listing


def loops_of(counts: dict, word: str) -> dict:
    """The entries of sass_loops' or sass_bodies' result whose kernel name
    holds `word`."""
    return {k: v for k, v in counts.items() if word in k}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m savont_tpu_torch.probes.roofline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", metavar="DIR", type=Path, default=None,
                    help="also write the kernels' SASS and innermost-loop opcode counts to DIR")
    ns = ap.parse_args(argv)
    dev = resolve_device("cuda")
    err = check(dev)
    if any(err.values()):
        raise AssertionError(f"roofline kernels differ from their plain versions: {err}")
    rec = {"device": torch.cuda.get_device_name(dev), "max_abs_err": err, **measure(dev)}
    timed_err = {k: rec[k]["max_abs_err"] for k in KINDS}
    if any(timed_err.values()):
        raise AssertionError(f"roofline kernels differ from their plain versions in the timed runs: {timed_err}")
    if ns.sass is not None:
        rec["sass_inner_loops"] = loops_of(sass_loops(dump_sass(ns.sass)), "roofline")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
