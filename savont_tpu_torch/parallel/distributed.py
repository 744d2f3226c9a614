"""Process groups for the port: one process a card, joined with
torch.distributed.

The counterpart of the JAX package's parallel/distributed.py, which joins a
jax.distributed job.  The same variables start it, with the same meaning:

  SAVONT_COORDINATOR    host:port of rank 0 (e.g. "10.0.0.1:8476")
  SAVONT_NUM_PROCESSES  the number of ranks
  SAVONT_PROCESS_ID     this process's rank

All three set: init_process_group(init_method="tcp://<coordinator>") before
the first device use.  SAVONT_DISTRIBUTED=auto: init_method="env://", which
reads torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (the
counterpart of jax.distributed.initialize() with no arguments).  A partial
set exits, naming what is missing.  None: nothing happens, and every route
is the one-device route.

The backend follows the device: NCCL for "cuda", gloo for "cpu".  Under
NCCL each rank takes one card, LOCAL_RANK % the node's card count (LOCAL_RANK
defaults to the rank), made current before the first allocation; a node
with more ranks (LOCAL_WORLD_SIZE, by default the world) than cards exits,
since NCCL refuses two ranks on one card.  init(..., backend="gloo") shares
a card between ranks, the collectives then staging card tensors through
host memory.

Every rank runs the same deterministic host pipeline, as the reference
requires.  The device routes (parallel/mesh.py, pipeline/sintax.py) run
their kernels on the rank's share of the work only, and one collective makes
the result whole on every rank, so every rank's outputs equal the one-process
run's.  Every rank writes its output directory, as the reference's CLI does.

The collective helpers below are the identity without a group.  COLLECTIVES
counts their calls and the bytes each rank hands the collective, by op and
backend.
"""
from __future__ import annotations

import logging
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("savont")

ENV_VARS = ("SAVONT_COORDINATOR", "SAVONT_NUM_PROCESSES", "SAVONT_PROCESS_ID")
# a rank that dies leaves the others in a collective: they give up after
# this many seconds instead of gloo's default 30 minutes
TIMEOUT_S = 600

# "<op>/<backend>": {"calls", "bytes"}, bytes being what this rank hands the
# collective (padding included)
COLLECTIVES: dict[str, dict[str, int]] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    """True on rank 0, or without a group."""
    return rank() == 0


def init(world_size: int | None, rank_: int | None, init_method: str, device="cpu",
         backend: str | None = None, timeout_s: float = TIMEOUT_S) -> None:
    """Join a process group of `world_size` ranks as `rank_` (both None:
    read from the environment by init_method "env://").  `backend` defaults
    to NCCL for a "cuda" device and gloo for "cpu"; on "cuda" the rank's card
    is made current first."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (expected 'cuda' or 'cpu')")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if world_size is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
                   if v not in os.environ]
        if missing:
            raise SystemExit(f"SAVONT_DISTRIBUTED=auto: missing {', '.join(missing)}")
        world_size, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if dev.type == "cuda":
        _take_card(rank_, world_size, backend)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank_, timeout=timedelta(seconds=timeout_s))
    log.info("process group: rank %d of %d, backend %s, device %s", rank_, world_size,
             backend, _card_name(dev))


def _take_card(rank_: int, world_size: int, backend: str) -> None:
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("device 'cuda' requested but no CUDA card is visible")
    local_rank = int(os.environ.get("LOCAL_RANK", rank_))
    on_node = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend == "nccl" and on_node > cards:
        raise SystemExit(
            f"{on_node} ranks on this node and {cards} CUDA card(s): NCCL takes one card a rank. "
            "Start at most one rank a card (set LOCAL_RANK and LOCAL_WORLD_SIZE when the ranks "
            "span nodes), or share a card over gloo (init(..., backend='gloo'))")
    torch.cuda.set_device(local_rank % cards)


def _card_name(dev: torch.device) -> str:
    return f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu"


def maybe_init_from_env(device="cuda") -> bool:
    """Join the process group the environment asks for, on `device`'s
    backend; returns whether this process is now (or already was) a rank of
    one.  Call it before the first device use."""
    if active():
        return True
    mode = os.environ.get("SAVONT_DISTRIBUTED", "")
    coord, nproc, pid = (os.environ.get(v) for v in ENV_VARS)
    if mode == "auto":
        init(None, None, "env://", device)
    elif coord and nproc and pid:
        init(int(nproc), int(pid), f"tcp://{coord}", device)
    elif coord or nproc or pid:
        # a partial configuration run as one process would leave the other
        # ranks waiting for it, or every rank racing on one output directory
        missing = [name for name, v in zip(ENV_VARS, (coord, nproc, pid)) if not v]
        raise SystemExit(f"partial multi-process configuration: missing {', '.join(missing)} "
                         "(set all three, or SAVONT_DISTRIBUTED=auto)")
    else:
        return False
    return True


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


def shares(weights: np.ndarray, parts: int, group: np.ndarray | None = None) -> np.ndarray:
    """(parts + 1,) cut points splitting len(weights) items into `parts`
    contiguous ranges of about equal weight; part r is items
    cuts[r]:cuts[r + 1], possibly empty.  With `group` (non-decreasing ids)
    no cut falls inside a group.  Every rank computes the same cuts from the
    same inputs."""
    n = len(weights)
    cum = np.cumsum(np.asarray(weights, dtype=np.float64))
    total = cum[-1] if n else 0.0
    # the first item count whose weight reaches each share
    cuts = np.searchsorted(cum, total * np.arange(1, parts) / parts, side="left") + 1
    cuts = np.minimum(cuts, n)
    if group is not None and n:
        group = np.asarray(group)
        starts = np.append(np.flatnonzero(np.diff(group)) + 1, n)
        cuts = starts[np.searchsorted(starts, cuts, side="left")]
    return np.concatenate(([0], np.maximum.accumulate(cuts), [n])).astype(np.int64)


def my_share(weights: np.ndarray, group: np.ndarray | None = None) -> tuple[int, int, np.ndarray]:
    """This rank's range (lo, hi) of shares(weights, world(), group), and
    every rank's size (world(),)."""
    cuts = shares(weights, world(), group)
    r = rank()
    return int(cuts[r]), int(cuts[r + 1]), np.diff(cuts)


# ── collective helpers: the identity without a group ─────────────────────


def _transport() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, host memory under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _count(op: str, t: torch.Tensor) -> None:
    c = COLLECTIVES.setdefault(f"{op}/{dist.get_backend()}", {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def all_gather_rows(t: torch.Tensor, sizes) -> torch.Tensor:
    """Every rank's rows, rank order: rank r holds t of sizes[r] rows (the
    sizes known on every rank); each is padded to the largest, gathered and
    cut back.  Returns (sum(sizes), ...) on t's device."""
    if not active():
        return t
    sizes = [int(s) for s in sizes]
    r = rank()
    if len(sizes) != world() or t.shape[0] != sizes[r]:
        raise ValueError(f"rank {r}: {t.shape[0]} rows, sizes {sizes}")
    width = max(sizes)
    if width == 0:
        return t
    dev = _transport()
    buf = torch.zeros((width, *t.shape[1:]), dtype=t.dtype, device=dev)
    buf[: sizes[r]] = t
    out = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(out, buf)
    _count("all_gather", buf)
    return torch.cat([o[:s] for o, s in zip(out, sizes)]).to(t.device)


def all_reduce_(t: torch.Tensor, op: str) -> torch.Tensor:
    """t reduced in place over the ranks, op "sum" or "max"; returns t."""
    if not active():
        return t
    x = t.to(_transport()).contiguous()
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    _count("all_reduce", x)
    if x is not t:
        t.copy_(x)
    return t


def all_to_all_rows(t: torch.Tensor, send_sizes) -> tuple[torch.Tensor, list[int]]:
    """Send rows send_sizes[0] of t to rank 0, the next send_sizes[1] to rank
    1, and so on; returns (the rows received, rank order, on t's device;
    how many came from each rank).  The sizes are exchanged first."""
    send_sizes = [int(s) for s in send_sizes]
    if not active():
        return t, send_sizes
    if len(send_sizes) != world() or sum(send_sizes) != t.shape[0]:
        raise ValueError(f"rank {rank()}: {t.shape[0]} rows, send sizes {send_sizes}")
    dev = _transport()
    sent = torch.tensor(send_sizes, dtype=torch.int64, device=dev)
    got = torch.empty_like(sent)
    dist.all_to_all_single(got, sent)
    _count("all_to_all", sent)
    recv_sizes = got.tolist()
    x = t.to(dev).contiguous()
    out = torch.empty((sum(recv_sizes), *t.shape[1:]), dtype=t.dtype, device=dev)
    dist.all_to_all_single(out, x, output_split_sizes=recv_sizes, input_split_sizes=send_sizes)
    _count("all_to_all", x)
    return out.to(t.device), recv_sizes
