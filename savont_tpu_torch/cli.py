"""Command-line interface of the port: `python -m savont_tpu_torch asv ...`.

The `asv` flags mirror the reference CLI (cli.rs), plus `--device` and the
route flags `--stage4-backend` / `--stage7-backend`.  Only
`asv` is ported: `classify`, `sintax`, `download`, `export` and `--profile`
exit 2.
"""
from __future__ import annotations

import argparse
import logging
import platform
import sys
from pathlib import Path

from . import __version__
from .config import ClusterArgs

TRACE = 5  # finer than DEBUG: per-read SNPmers, pileups, pairwise dumps
logging.addLevelName(TRACE, "TRACE")

NOT_PORTED = "not yet ported to savont_tpu_torch (use python -m savont_tpu)"


def _setup_logging(level: str, log_file: Path) -> None:
    lvl = TRACE if level == "trace" else getattr(logging, level.upper(), logging.INFO)
    log_file.parent.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=lvl,
        format="(%(asctime)s) %(levelname)s [%(name)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=[logging.StreamHandler(sys.stderr), logging.FileHandler(log_file)],
        force=True,
    )
    # startup banner (main.rs:444-448)
    log = logging.getLogger("savont")
    log.info("COMMAND: %s", " ".join(sys.argv))
    log.info("VERSION: %s", __version__)
    log.info("SYSTEM NAME: %s", platform.system())
    log.info("SYSTEM HOST NAME: %s", platform.node())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="savont-tpu-torch",
        description=(
            "savont-tpu-torch - high-resolution ASV generation for ONT R10.4/HiFi "
            "long-read amplicon sequencing, with the alignments on an NVIDIA card"
        ),
    )
    p.add_argument("--log-level", default="info", choices=["error", "warn", "info", "debug", "trace"])
    p.add_argument("--profile", metavar="DIR", default=None, help=f"profiling is {NOT_PORTED}")
    sub = p.add_subparsers(dest="command", required=True)

    a = sub.add_parser("asv", help="Turn >~98%% accuracy long reads into ASVs")
    a.add_argument("input_files", nargs="+", metavar="FASTQ/FASTA")
    a.add_argument("-o", "--output-dir", default="savont-out")
    a.add_argument("-t", "--threads", type=int, default=20)
    a.add_argument("--fl-16s", action="store_true", help="16S full-length preset (default; no-op)")
    a.add_argument("--hifi", action="store_true", help="PacBio HiFi preset (--min-cluster-size 4)")
    a.add_argument("--rrna-operon", action="store_true", help="rRNA operon preset (len 3500-5000)")
    a.add_argument("--pooled-samples", action="store_true")
    a.add_argument("-c", type=int, default=11, dest="c")
    a.add_argument("-m", "--min-read-length", type=int, default=1100)
    a.add_argument("-M", "--max-read-length", type=int, default=2000)
    a.add_argument("--quality-value-cutoff", type=float, default=98.0)
    a.add_argument("--minimum-base-quality", type=int, default=25)
    a.add_argument("-s", "--single-strand", action="store_true")
    a.add_argument("--min-cluster-size", type=int, default=12)
    a.add_argument("-b", "--bloom-filter-size", type=float, default=0.0)
    a.add_argument("-n", "--n-depth-cutoff", type=int, default=250)
    a.add_argument("-u", "--use-hpc", action="store_true")
    a.add_argument("--mask-low-quality", action="store_true")
    a.add_argument("-p", "--posterior-threshold-ln", type=float, default=30.0)
    a.add_argument("--max-iterations-recluster", type=int, default=10)
    a.add_argument("--aggressive-bloom", action="store_true")
    a.add_argument("--skip-chimera-detection", action="store_true")
    a.add_argument("--no-snpmers", action="store_true")
    a.add_argument("--low-polymorphism", action="store_true")
    a.add_argument("-k", "--kmer-size", type=int, default=17)
    a.add_argument("--blockmer-length", type=int, default=3)
    a.add_argument("--use-blockmers", action="store_true")
    a.add_argument("--chimera-allowable-errors", type=int, default=1)
    a.add_argument("--chimera-detect-length", type=int, default=None)
    a.add_argument("--clean-dir", action="store_true")
    a.add_argument("--resume", action="store_true", help="Reuse the stage-3 checkpoint in <output>/temp when inputs and parameters are unchanged")
    # hidden no-op, mirrored from cli.rs:176-179 (driven nowhere: main.rs:135)
    a.add_argument("--phase-heterogeneous", action="store_true", help=argparse.SUPPRESS)
    a.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the DP kernels run (default cuda; cuda fails when no card "
        "is visible, cpu runs their plain PyTorch versions)",
    )
    for stage, what in ((4, "pileups"), (7, "tie-break and EM")):
        a.add_argument(
            f"--stage{stage}-backend", choices=["mesh", "host"], default="mesh",
            help=f"route of the stage-{stage} {what}: mesh (default) keeps the whole step on "
            "the device, host takes the per-job route with its host-side reduction; "
            "same outputs",
        )
    for name in ("classify", "sintax", "download", "export"):
        sub.add_parser(name, help=NOT_PORTED, add_help=False)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    ns, extra = parser.parse_known_args(argv)
    if ns.command != "asv":
        print(f"ERROR [savont-tpu-torch] subcommand {ns.command!r} is {NOT_PORTED}", file=sys.stderr)
        return 2
    if ns.profile:
        print(f"ERROR [savont-tpu-torch] --profile is {NOT_PORTED}", file=sys.stderr)
        return 2
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    from .pipeline.asv import run_cluster

    for f in ns.input_files:
        if not Path(f).exists():
            print(f"ERROR [savont-tpu-torch] Input file {f} does not exist.", file=sys.stderr)
            return 1
    level = {"warn": "warning"}.get(ns.log_level, ns.log_level)
    _setup_logging(level, Path(ns.output_dir) / "savont.log")
    fields = {k: v for k, v in vars(ns).items() if k not in ("command", "log_level", "profile")}
    run_cluster(ClusterArgs(**fields))
    return 0


if __name__ == "__main__":
    sys.exit(main())
