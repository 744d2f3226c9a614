"""Command-line interface of the port: `python -m savont_tpu_torch asv ...`.

Reuses savont_tpu's parser and the asv branch of its dispatcher, run inside
the port's routing seam.  Only `asv` is ported; the other subcommands and
`--profile` (whose JAX trace the port cannot take) exit 2.
"""
from __future__ import annotations

import argparse
import sys

from savont_tpu import cli as _host_cli

from .ops.align_batch import device_routes

NOT_PORTED = "not yet ported to savont_tpu_torch (use python -m savont_tpu)"


def build_parser() -> argparse.ArgumentParser:
    p = _host_cli.build_parser()
    p.prog = "savont-tpu-torch"
    sub = next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))
    sub.choices["asv"].add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the DP kernels run (default cuda; cuda fails when no card "
        "is visible, cpu runs their plain PyTorch versions)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    ns = build_parser().parse_args(argv)
    if ns.command != "asv":
        print(f"ERROR [savont-tpu-torch] subcommand {ns.command!r} is {NOT_PORTED}", file=sys.stderr)
        return 2
    if ns.profile:
        print(f"ERROR [savont-tpu-torch] --profile is {NOT_PORTED}", file=sys.stderr)
        return 2
    level = {"warn": "warning"}.get(ns.log_level, ns.log_level)
    with device_routes(ns.device):
        return _host_cli._dispatch(ns, level)


if __name__ == "__main__":
    sys.exit(main())
