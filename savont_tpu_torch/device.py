"""Device selection for the port: explicit, with no automatic fallback."""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """Map "cuda" / "cpu" (or a torch.device) to a torch.device.

    "cuda" raises RuntimeError when no CUDA device is visible: a run that
    asked for the card never silently runs on the CPU.  Inside a process
    group (parallel/distributed.py) "cuda" is the rank's card, the current
    one.  "cpu" is taken only when the caller names it (tests, and the
    plain-PyTorch versions of the kernels)."""
    from .parallel import distributed

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False"
            )
        if dev.index is None and distributed.active():
            return torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r} (expected 'cuda' or 'cpu')")
