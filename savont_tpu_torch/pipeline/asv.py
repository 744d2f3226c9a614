"""The `asv` subcommand — 7-stage pipeline (main.rs:49-196) — with every DP
alignment of stages 4-7 on the device named by `args.device` (the CUDA
kernels on "cuda", their plain PyTorch versions on "cpu")."""
from __future__ import annotations

import logging
import os
import time
from pathlib import Path

from ..config import ClusterArgs
from ..constants import ASV_FILE
from ..device import resolve_device
from . import pileup, stage1_kmers, stage23_cluster, stage4_consensus, stage5_merge, stage6_chimera, stage7_em
from .outputs import (
    sample_names_from_inputs,
    write_clusters_tsv,
    write_consensus_fasta,
    write_feature_table,
)

log = logging.getLogger("savont")


def log_memory_usage(message: str) -> None:
    """RSS telemetry at stage boundaries (utils.rs:4-24)."""
    try:
        rss_kb = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss_kb = int(line.split()[1])
                    break
        log.info("%s --- Memory usage: %.2f GB", message, rss_kb / 1e6)
    except OSError:
        log.info("Memory usage: unknown (WARNING)")


def _checkpoint_key(args: ClusterArgs) -> str:
    """Identity of a stage-3 checkpoint: inputs + every clustering tunable."""
    import hashlib

    h = hashlib.sha256()
    for f in args.input_files:
        st = os.stat(f)
        h.update(f"{f}:{st.st_size}:{st.st_mtime_ns}".encode())
    for field in (
        "kmer_size", "c", "min_read_length", "max_read_length", "quality_value_cutoff",
        "minimum_base_quality", "single_strand", "min_cluster_size", "no_snpmers",
        "low_polymorphism", "use_blockmers", "blockmer_length", "max_iterations_recluster",
    ):
        h.update(f"{field}={getattr(args, field)};".encode())
    return h.hexdigest()[:16]


def run_cluster(args: ClusterArgs) -> Path:
    resolve_device(args.device)  # "cuda" without a card raises here, before any work
    args.apply_presets()
    if args.kmer_size % 2 == 0:
        raise SystemExit("K-mer size must be odd")
    # short-amplicon runs fit a 48-wide DP corridor (output-identical to
    # wider bands on the JAX package's Zymo and 20k synthetic oracles: the
    # chain-anchored band only has to cover inter-anchor drift); the operon
    # preset keeps the conservative 128.
    # The narrowed band is scoped to this pipeline run (restored on exit so
    # a later classify/validate in the same process keeps its own default).
    from ..ops import align as _align
    from ..ops.align import set_default_band

    prev_band = _align.DEFAULT_BAND
    set_default_band(48 if args.max_read_length <= 2600 else 128)
    try:
        return _run_cluster_inner(args)
    finally:
        _align.DEFAULT_BAND = prev_band


# wall seconds of the last run by stage ("1" covers stages 1 and 1.5, "4"
# the consensus rounds, "4p" the pileups and their analysis, "7" the
# tie-break, EM and the output files)
STAGE_SECONDS: dict[str, float] = {}


_CLOCK: dict = {"stage": None, "t": 0.0}


def _mark(stage: str | None) -> None:
    """Close the running stage's clock and start `stage`'s (None: none)."""
    now = time.perf_counter()
    if _CLOCK["stage"] is not None:
        STAGE_SECONDS[_CLOCK["stage"]] = STAGE_SECONDS.get(_CLOCK["stage"], 0.0) + now - _CLOCK["t"]
    _CLOCK["stage"], _CLOCK["t"] = stage, now


def _run_cluster_inner(args: ClusterArgs) -> Path:
    STAGE_SECONDS.clear()
    _mark(None)
    try:
        return _run_stages(args)
    finally:
        _mark(None)


def _run_stages(args: ClusterArgs) -> Path:
    out_dir = Path(args.output_dir)
    temp_dir = out_dir / "temp"
    temp_dir.mkdir(parents=True, exist_ok=True)
    t_start = time.time()

    # Stage-3 checkpoint (real resume; the reference only has a stub around
    # MAGIC_EXIST_STRING, main.rs:481-493)
    import pickle

    ckpt_path = temp_dir / "checkpoint_stage3.pkl"
    ckpt_key = _checkpoint_key(args)
    resumed = False
    if args.resume and ckpt_path.exists():
        try:
            with open(ckpt_path, "rb") as f:
                ck = pickle.load(f)
            if ck.get("key") == ckpt_key:
                kmer_info, twin_reads, clusters = ck["kmer_info"], ck["twin_reads"], ck["clusters"]
                args.low_polymorphism = ck["low_polymorphism"]
                resumed = True
                log.info("Resumed from stage-3 checkpoint (%d reads, %d clusters)", len(twin_reads), len(clusters))
            else:
                log.warning("Checkpoint key mismatch (inputs/params changed); recomputing")
        except Exception as e:  # noqa: BLE001 - any corrupt checkpoint -> recompute
            log.warning("Failed to load checkpoint: %s; recomputing", e)

    if not resumed:
        _mark("1")
        log.info("=== STAGE 1: k-mers and polymorphic markers ===")
        t0 = time.time()
        kmers, counts = stage1_kmers.read_to_split_kmers(args)
        log.info("Time elapsed in for counting k-mers is: %.2fs", time.time() - t0)
        t0 = time.time()
        blockmer_sorted = None
        if args.use_blockmers:
            import numpy as np

            blk_kmers, blk_counts = stage1_kmers.read_blockmer_counts(args)
            blockmer_info = stage1_kmers.get_blockmers(blk_kmers, blk_counts, kmers, counts, args)
            vals = [v for _, pair, _ in blockmer_info for v in pair]
            blockmer_sorted = np.unique(np.array(vals, dtype=np.uint64)) if vals else np.zeros(0, np.uint64)
            log.info("Using blockmers: True (%d biallelic anchors)", len(blockmer_info))
        kmer_info = stage1_kmers.get_snpmers(kmers, counts, args)
        log.info("Time elapsed in for parsing snpmers is: %.2fs", time.time() - t0)
        log_memory_usage("STAGE 1 DONE: Obtained SNPmers")

        log.info("=== STAGE 1.5: TwinRead construction ===")
        twin_reads = stage1_kmers.twin_reads_from_files(kmer_info, args, blockmer_sorted)
        n_no_snp = sum(1 for t in twin_reads if len(t.snp_pos) == 0)
        frac_no_snp = n_no_snp / max(len(twin_reads), 1)
        log.info("reads without SNPmers: %.1f%%", frac_no_snp * 100)
        if frac_no_snp > 0.75 and not args.low_polymorphism:
            log.warning("Auto-enabling --low-polymorphism (>75%% of reads have no SNPmers)")
            args.low_polymorphism = True

        _mark("2")
        log.info("=== STAGE 2: k-mer clustering ===")
        clusters = stage23_cluster.cluster_reads_by_kmers(twin_reads, args)
        log_memory_usage("STAGE 2 DONE: Clustered reads by k-mers")
        _write_simple_clusters(temp_dir / "kmer_clusters_stage2.tsv", clusters)

        _mark("3")
        log.info("=== STAGE 3: SNPmer clustering ===")
        clusters = stage23_cluster.cluster_reads_by_snpmers(twin_reads, clusters, args, temp_dir)
        _write_final_snpmer_clusters(temp_dir / "final_snpmer_clusters_stage3.tsv", clusters, twin_reads)
        if args.resume:
            with open(ckpt_path, "wb") as f:
                pickle.dump(
                    {"key": ckpt_key, "kmer_info": kmer_info, "twin_reads": twin_reads,
                     "clusters": clusters, "low_polymorphism": args.low_polymorphism},
                    f, protocol=pickle.HIGHEST_PROTOCOL,
                )
            log.info("Wrote stage-3 checkpoint to %s", ckpt_path)

    _mark("4")
    log.info("=== STAGE 4: consensus + polish ===")
    consensuses = stage4_consensus.align_and_consensus(twin_reads, clusters, args)
    # alignment.rs:399-402 uses the standard writer (decompressed + N-trim
    # + full debug header) for the initial dump too (the writer peeks, so
    # the pileup stage still sees the uncached HPC form)
    write_consensus_fasta(consensuses, temp_dir / "consensus_sequences.fasta", "initial")
    _mark("4p")
    pileups = pileup.generate_consensus_pileups(twin_reads, consensuses, args)
    quality_error_map = pileup.estimate_quality_error_rates(pileups, consensuses, 0.1)
    low_qual = pileup.analyze_pileup_consensuses(pileups, consensuses, quality_error_map, args)
    log_memory_usage("STAGE 4 DONE: Analyzed pileups")
    for c in consensuses:
        c.decompress()
    for c in low_qual:
        c.decompress()
    write_clusters_tsv(low_qual, twin_reads, temp_dir / "low_quality_clusters.tsv", "low_quality")
    write_clusters_tsv(consensuses, twin_reads, temp_dir / "clusters_after_quality_filter_stage4.tsv", "prefilter")
    write_consensus_fasta(low_qual, temp_dir / "low_quality_consensus_sequences.fasta", "lowqual")

    _mark("5")
    log.info("=== STAGE 5: merge similar consensuses ===")
    consensuses, s5_hits = stage5_merge.merge_similar_consensuses(consensuses, low_qual, args)
    write_clusters_tsv(consensuses, twin_reads, temp_dir / "final_clusters_merged_stage5.tsv", "final")
    write_consensus_fasta(consensuses, temp_dir / "merged_consensus_sequences.fasta", "merged")

    if not args.skip_chimera_detection:
        _mark("6")
        log.info("=== STAGE 6: chimera detection ===")
        chimeric = stage6_chimera.detect_chimeras(consensuses, args, precomputed_hits=s5_hits)
        consensuses = stage6_chimera.filter_chimeras(consensuses, chimeric)
    else:
        log.info("Skipping chimera detection as per user request.")
        return out_dir

    _mark("7")
    log.info("=== STAGE 7: EM depth refinement ===")
    em_fasta = temp_dir / "final_asvs_for_em.fasta"
    write_consensus_fasta(consensuses, em_fasta, "em_refinement")

    def build_asv_trs():
        return stage1_kmers.twin_reads_from_fasta(em_fasta, kmer_info, args)

    if args.low_polymorphism:
        consensuses, _, _ = stage7_em.refine_asv_depths_with_minimap(twin_reads, consensuses, args)
    else:
        consensuses, _, _ = stage7_em.refine_asv_depths_with_em(
            twin_reads, consensuses, kmer_info, args, build_asv_trs
        )
    consensuses.sort(key=lambda c: -c.depth)

    sample_names = sample_names_from_inputs(args.input_files)
    if args.pooled_samples and len(args.input_files) > 1:
        log.info("=== STAGE 7b: per-sample quantification ===")
        per_sample = stage7_em.compute_per_sample_depths(
            twin_reads, len(args.input_files), consensuses, kmer_info, args, build_asv_trs
        )
        for i, c in enumerate(consensuses):
            c.per_sample_depths = per_sample[i]

    write_consensus_fasta(consensuses, out_dir / ASV_FILE, "final")
    ft_names = sample_names if (args.pooled_samples and len(args.input_files) > 1) else sample_names[:1]
    write_feature_table(consensuses, out_dir / "feature-table.tsv", ft_names)
    _debug_consensus_twin_read(kmer_info, consensuses, args)
    for i, c in enumerate(consensuses):
        c.id = i
    write_clusters_tsv(consensuses, twin_reads, out_dir / "final_clusters.tsv", "final")
    log.info("=== SAVONT-TPU-TORCH COMPLETED in %.1f s: %d ASVs ===", time.time() - t_start, len(consensuses))
    return out_dir


def _debug_consensus_twin_read(kmer_info, consensuses, args) -> None:
    """TRACE dump of each final consensus's SNPmer positions+bases
    (main.rs:545-600, called at main.rs:185).  The reference rebuilds a
    TwinRead per consensus via get_twin_read_syncmer against the global
    SNPmer set and trace-logs (pos, decoded kmer) pairs; we do the same
    through build_twin_read.  Gated on TRACE (level 5) so the production
    path pays nothing."""
    if not log.isEnabledFor(5):
        return
    from ..ops.encode import decode_kmer

    snpmer_sorted = kmer_info.snpmer_set_sorted()
    for i, c in enumerate(consensuses):
        seq = c.get_decompressed().tobytes()
        log.log(5, "Consensus ID: %s, Index %d, Depth: %s, Length: %d",
                c.id, i, c.depth, len(seq))
        tr = stage1_kmers.build_twin_read(seq, None, "", args, snpmer_sorted)
        if tr is None:
            continue
        pos, kmers = tr.snpmers_vec()
        snp = [(int(p), decode_kmer(int(km), args.kmer_size)) for p, km in zip(pos, kmers)]
        log.log(5, "SNPmer bases are: %s", snp)


def _write_simple_clusters(path, clusters):
    with open(path, "w") as f:
        f.write("cluster_id\tsize\trepresentative\tmembers\n")
        for i, c in enumerate(clusters):
            f.write(f"cluster_{i}\t{len(c)}\t{c[0]}\t{','.join(map(str, c))}\n")


def _write_final_snpmer_clusters(path, clusters, twin_reads):
    from .stage23_cluster import write_snpmer_clusters_tsv

    write_snpmer_clusters_tsv(path, clusters, twin_reads)
