"""Command-line interface of the port: `python -m savont_tpu_torch
{asv, classify, sintax, download, export}`.

The flags mirror the JAX package's CLI (cli.rs), plus `--device` on `asv`,
`classify` and `sintax` (the card by default; `cpu` runs the kernels' plain
PyTorch versions) and the `asv` route flag `--stage1-backend`.
`--profile DIR` writes cProfile's profile.pstats and a
torch.profiler trace, with CUDA activity when the run's device is the card.
Under the reference's multi-process variables (parallel/distributed.py) the
process joins a process group first; `--markdown-help` prints the CLI's
docs in markdown.
"""
from __future__ import annotations

import argparse
import logging
import platform
import sys
from pathlib import Path

from . import __version__
from .config import ClassifyArgs, ClusterArgs, ExportArgs, SintaxArgs

TRACE = 5  # finer than DEBUG: per-read SNPmers, pileups, pairwise dumps
logging.addLevelName(TRACE, "TRACE")

DEVICE_HELP = ("where the kernels run (default cuda; cuda fails when no card is visible, "
               "cpu runs their plain PyTorch versions)")


def _setup_logging(level: str, log_file: Path | None) -> None:
    lvl = TRACE if level == "trace" else getattr(logging, level.upper(), logging.INFO)
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if log_file is not None:
        log_file.parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=lvl,
        format="(%(asctime)s) %(levelname)s [%(name)s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=handlers,
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
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="Write profiling traces to DIR: host cProfile stats (profile.pstats) and a "
        "torch.profiler trace (trace.json, Chrome trace format), with CUDA activity "
        "when the run's device is the card",
    )
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
    a.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help=DEVICE_HELP)
    a.add_argument(
        "--stage1-backend", choices=["host", "mesh"], default="host",
        help="route of the stage-1 split-k-mer count: host (default) scans and counts on the "
        "CPU, mesh extracts on the device (kernel 4) and sorts and counts there; same outputs",
    )

    c = sub.add_parser("classify", help="Classify ASVs against a reference database")
    c.add_argument("-i", "--input-dir", required=True)
    c.add_argument("-o", "--output-dir", default=None)
    c.add_argument("-d", "--db", required=True)
    c.add_argument("-t", "--threads", type=int, default=20)
    c.add_argument("--species-threshold", type=float, default=99.0)
    c.add_argument("--genus-threshold", type=float, default=94.5)
    c.add_argument("--detailed-unclassified", action="store_true")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help=DEVICE_HELP)

    s = sub.add_parser("sintax", help="SINTAX k-mer bootstrap classification")
    s.add_argument("-i", "--input-dir", required=True)
    s.add_argument("-o", "--output-dir", default=None)
    s.add_argument("-d", "--db", required=True)
    s.add_argument("-t", "--threads", type=int, default=20)
    s.add_argument("--min-bootstrap", type=float, default=0.8)
    s.add_argument("--n-iter", type=int, default=100)
    s.add_argument("--detailed-unclassified", action="store_true")
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help=DEVICE_HELP)

    d = sub.add_parser("download", help="Download reference databases")
    d.add_argument("--location", required=True)
    d.add_argument("--dbs", required=True, nargs="+")

    e = sub.add_parser("export", help="Export/merge results to QIIME2-compatible format")
    e.add_argument("-i", "--input-dirs", required=True, nargs="+")
    e.add_argument("-o", "--output-dir", required=True)
    e.add_argument("--no-fuzzy", action="store_true")
    e.add_argument("--relabel", nargs="+", default=None)
    return p


def _print_markdown_help(p: argparse.ArgumentParser) -> None:
    """--markdown-help: the CLI's docs in markdown, a section a subcommand
    (cli.rs:175, clap-markdown's hidden flag)."""
    print(f"# {p.prog}\n\n{p.description or ''}\n")
    subs = next((a for a in p._actions if isinstance(a, argparse._SubParsersAction)), None)
    for name, sp in (subs.choices.items() if subs else []):
        print(f"## `{p.prog} {name}`\n\n```\n{sp.format_help()}```\n")


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    if "--markdown-help" in (sys.argv[1:] if argv is None else argv):
        _print_markdown_help(parser)
        return 0
    ns = parser.parse_args(argv)
    level = {"warn": "warning"}.get(ns.log_level, ns.log_level)

    # a rank of a process group when SAVONT_COORDINATOR / _NUM_PROCESSES /
    # _PROCESS_ID (or SAVONT_DISTRIBUTED=auto) say so, before any device use
    from .parallel import distributed

    joined = not distributed.active() and distributed.maybe_init_from_env(
        getattr(ns, "device", "cpu"))
    try:
        if ns.profile:
            return _run_profiled(ns, level)
        return _dispatch(ns, level)
    finally:
        if joined:
            distributed.shutdown()


def _run_profiled(ns, level: str) -> int:
    """--profile DIR: cProfile's profile.pstats always, and a torch.profiler
    trace (trace.json) with CPU activity, and CUDA activity when the run's
    device is the card (`download` and `export` have none)."""
    import cProfile

    from torch.profiler import ProfilerActivity, profile

    out = Path(ns.profile)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if getattr(ns, "device", "cpu") == "cuda":
        activities.append(ProfilerActivity.CUDA)
    pr = cProfile.Profile()
    with profile(activities=activities) as prof:
        pr.enable()
        try:
            rc = _dispatch(ns, level)
        finally:
            pr.disable()
            pr.dump_stats(str(out / "profile.pstats"))
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"[savont-tpu-torch] profile written to {out}", file=sys.stderr)
    return rc


def _dispatch(ns, level: str) -> int:
    if ns.command == "asv":
        from .pipeline.asv import run_cluster

        for f in ns.input_files:
            if not Path(f).exists():
                print(f"ERROR [savont-tpu-torch] Input file {f} does not exist.", file=sys.stderr)
                return 1
        _setup_logging(level, Path(ns.output_dir) / "savont.log")
        run_cluster(ClusterArgs(**_fields(ns)))
        return 0

    if ns.command in ("classify", "sintax"):
        from .db.registry import load_database

        out = Path(ns.output_dir) if ns.output_dir else Path(ns.input_dir)
        _setup_logging(level, out / f"savont_{ns.command}.log")
        if ns.command == "classify":
            from .pipeline.classify import classify

            classify(ClassifyArgs(**_fields(ns)), load_database(Path(ns.db)))
        else:
            from .pipeline.sintax import SCORE_STATS, sintax
            from .tracing import span

            with span("sintax:db_load", SCORE_STATS, "db_load_s"):
                db = load_database(Path(ns.db))
            sintax(SintaxArgs(**_fields(ns)), db)
        return 0

    if ns.command == "download":
        from .db.registry import download

        _setup_logging(level, None)
        download(ns.location, ns.dbs)
        return 0

    from .pipeline.export import export

    _setup_logging(level, Path(ns.output_dir) / "savont_export.log")
    export(ExportArgs(**_fields(ns)))
    return 0


def _fields(ns) -> dict:
    """The subcommand's own arguments: its dataclass's fields."""
    return {k: v for k, v in vars(ns).items() if k not in ("command", "log_level", "profile")}


if __name__ == "__main__":
    sys.exit(main())
