"""Pipeline arguments of the subcommands, mirroring the reference CLI (cli.rs)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ClusterArgs:
    """`savont asv` tunables with reference defaults (cli.rs:45-180)."""

    input_files: list[str] = field(default_factory=list)
    output_dir: str = "savont-out"
    threads: int = 20
    # presets
    fl_16s: bool = False
    hifi: bool = False
    rrna_operon: bool = False
    pooled_samples: bool = False
    # core params
    c: int = 11
    min_read_length: int = 1100
    max_read_length: int = 2000
    quality_value_cutoff: float = 98.0
    minimum_base_quality: int = 25
    single_strand: bool = False
    min_cluster_size: int = 12
    bloom_filter_size: float = 0.0
    n_depth_cutoff: int = 250
    use_hpc: bool = False
    mask_low_quality: bool = False
    posterior_threshold_ln: float = 30.0
    max_iterations_recluster: int = 10
    aggressive_bloom: bool = False
    skip_chimera_detection: bool = False
    no_snpmers: bool = False
    low_polymorphism: bool = False
    kmer_size: int = 17
    blockmer_length: int = 3
    use_blockmers: bool = False
    chimera_allowable_errors: int = 1
    chimera_detect_length: int | None = None
    clean_dir: bool = False  # declared but unused in the reference too (cli.rs:59-61)
    phase_heterogeneous: bool = False
    resume: bool = False
    # where the DP kernels of stages 4-7 run: "cuda" (the card; raises when
    # none is visible) or "cpu" (their plain PyTorch versions)
    device: str = "cuda"
    # the route of the stage-1 split-k-mer count: "host", the native scan and
    # count on the CPU, or "mesh", kernel 4 on `device` with the sort and
    # count there (with -b, kernel 4's per-read lists into the host count).
    # Same outputs
    stage1_backend: str = "host"

    def __post_init__(self) -> None:
        if self.stage1_backend not in ("mesh", "host"):
            raise ValueError(f"stage1_backend must be 'mesh' or 'host', got {self.stage1_backend!r}")

    def apply_presets(self) -> None:
        """main.rs:459-468."""
        if self.rrna_operon:
            self.min_read_length = 3500
            self.max_read_length = 5000
        if self.hifi:
            self.min_cluster_size = 4


@dataclass
class ClassifyArgs:
    input_dir: str = ""
    output_dir: str | None = None
    db: str = ""
    threads: int = 20
    species_threshold: float = 99.0
    genus_threshold: float = 94.5
    detailed_unclassified: bool = False
    # where the alignments run: "cuda" (kernel 1, and kernels 1 + 2 for the
    # starts of the written hits; raises when no card is visible) or "cpu"
    # (their plain PyTorch versions)
    device: str = "cuda"


@dataclass
class SintaxArgs:
    input_dir: str = ""
    output_dir: str | None = None
    db: str = ""
    threads: int = 20
    min_bootstrap: float = 0.8
    n_iter: int = 100
    detailed_unclassified: bool = False
    # where the k-mer scores run: "cuda" (kernel 3) or "cpu" (its plain
    # PyTorch version)
    device: str = "cuda"


@dataclass
class ExportArgs:
    input_dirs: list[str] = field(default_factory=list)
    output_dir: str = ""
    no_fuzzy: bool = False
    relabel: list[str] | None = None


@dataclass
class DownloadArgs:
    location: str = ""
    dbs: list[str] = field(default_factory=list)
