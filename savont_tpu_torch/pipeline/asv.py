"""The `asv` driver on the port's device: savont_tpu's run_cluster, with
every DP alignment of stages 4-7 routed through the port's kernels."""
from __future__ import annotations

from pathlib import Path

from savont_tpu.config import ClusterArgs
from savont_tpu.pipeline import asv as _host_asv

from ..ops.align_batch import device_routes


def run_cluster(args: ClusterArgs, device="cuda") -> Path:
    with device_routes(device):
        return _host_asv.run_cluster(args)
