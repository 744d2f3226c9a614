#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (savont_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It imports nothing of jax or of the JAX package.  Phases (each raises on
failure; nothing catches it, so the exit code is non-zero):
  1. device    - require a CUDA card; print its name, the torch / CUDA
                 versions and nvidia-smi's name and power limit; build and
                 load the port's host C++ oracle
                 (savont_tpu_torch/native/swalign.cpp);
  2. build     - compile savont_tpu_torch/ops/csrc/*.cu with nvcc, one
                 process per source, all started together;
  3. kernels   - seed-pinned jobs from the port's planner on random ~1,450 bp
                 templates (substitutions, 1-6 bp and 40-60 bp deletions,
                 both strands): >= 2,048 pairs at band 48 and a band-128
                 batch.  Kernel 1 (NM and payload modes) and kernel 2 must
                 equal their plain PyTorch versions on the card, and the
                 port's job routes the port's host oracle, CIGARs included;
                 the three roofline kernels and the eleven kernels of the
                 bitcast, i16ops and roll probes must equal their plain
                 versions (bitcast: formula A is the roll by 1, formula B is
                 not; roll: every mode at k = 2, 4 and 8 rows a thread).
                 Then the edge shapes: small raw inputs the planner
                 does not produce (edge_cases: bands 1 to 256, batches of 1,
                 31 and 65 pairs, one-row queries, targets of length 0 and 1
                 and shorter than the corridor, band jumps up to and past
                 the band, codes 4 / 5 / 6, a pair of score 0, ties across
                 rows and lanes) through both modes of kernel 1 and through
                 kernel 2; and kernel 2 alone on walk_edge_cases: start rows on the edges of its
                 shared-memory windows, payloads at every alignment and
                 flush with the end of their storage, wild payloads, the
                 stage-4 mix of score-0 rows, a walk cut by ops_max, CIGARs
                 of maxrun - 1, maxrun and maxrun + 1 runs for maxrun 4, 5
                 and 512.  Kernel 2 is timed as its launch alone (20 queued
                 launches, and one), through walk_rle with its validation,
                 and on the stage-4 mix.
                 Tolerance 0 throughout: every output is an integer;
  4. probes    - the timed runs of the integer roofline probe
                 (savont_tpu_torch.probes.roofline.measure: the card's int32
                 max/add rate, which bounds kernel 1) and of the bitcast,
                 i16ops and roll probes, each time the mean of 20 launches
                 queued back to back with the single launch's beside it; the
                 outputs of the timed launches must equal their plain
                 versions' too, at tolerance 0; every roll mode and k must
                 run one chain instruction per element a step (the SASS of
                 its step loop) and take no less than its bound;
  5. main path - a seed-pinned 5,000-read fastq through
                 `savont_tpu_torch.cli.main(["asv", ..., "--device", "cuda"])`
                 (what `python -m savont_tpu_torch` runs) with the default
                 routes, the device routes of stages 4 and 7, once untimed
                 and once timed: the outputs must equal the sha256 digests
                 pinned below (those of the JAX package's host run on the
                 same reads; tests/test_torch_chip_smoke.py holds them to
                 it), every ASV must be at NM=0 against the templates,
                 kernels 1 (both modes) and 2 launched by the device routes
                 (check_asv_routes), no plain version called, no job handed
                 to the per-job consumers.  Then a 1,500-read sample with
                 the flat planner made to decline it, so that every call of
                 both routes falls to the per-job consumers (kernels 1 and
                 2 job by job, stage 4's scatter on the host), held to its
                 own digests, to each kernel launched and no plain version.
  6. classification - in phase 5's work directory, through
                 `savont_tpu_torch.cli.main` on the card: the port's
                 build_emu_slice of phase 5's templates (10,000 references),
                 `classify` of the phase-5 ASVs and of 40 hard ASVs cut from
                 the references (substitutions, foreign ends, both strands,
                 two samples), `sintax` of the phase-5 ASVs under
                 `--profile`, `export` of the two asv directories.  Every
                 output must equal the sha256 digests pinned below (the JAX
                 package's host runs in a fresh process); each route's
                 counts, set to 0 just before it, must show kernel 1 (NM)
                 over the candidate jobs, kernels 1 (payload) + 2 over the
                 written hits only, kernels 6 and 3 once a chunk on the
                 sintax scores with every row's k-mers extracted on the
                 card, and no plain version.  Then kernel 3 against its plain version
                 and the dense composition, exact, on its 11 edge cases
                 (ties across rows and across chunks, sentinel and empty
                 rows, repeated slots at score 32, rows of 1 to 20,000
                 k-mers, more distinct query k-mers than a block stages in
                 shared memory, 8,205 pairs over three pair tiles, a key
                 held by every pair, the largest ordinal at score 32, one
                 pair and one row); and at the cell's three shapes (the
                 phase-5 ASVs' 1,000 pairs, the hard ASVs' 4,000 and both
                 sets in one run, 5,000 over two pair tiles, each against
                 the first 4,096 references), timed with its bound; kernel
                 6 against its plain version, exact, on sintax_ref_cases
                 (every byte value, lowercase, U / u, N and IUPAC codes,
                 rows of 0 to 13 bases, homopolymers and tandem repeats, a
                 sequence and its reverse complement, palindromic k-mers,
                 every alignment, the edges of its tiles, a chunk of 4,096
                 EMU-shaped references, rows past its shared memory) and
                 at the database's first 4,096 references, timed with its
                 bound, the plain version and the library composition;
                 the route's scores on the card (_device_scores) equal to
                 the host stream's (_host_scores); and kernel 1 (NM) timed
                 at the classify cell's shapes.
  7. stage-1 k-mers - kernels 4 (split k-mers) and 5 (open syncmers)
                 against their plain versions on the card, exact, on
                 kmer_edge_cases (reads of length 0, k - 1, k and k + 1,
                 masked palindromes alone and back to back, homopolymers,
                 low, all-equal and absent qualities, batches of 1 and 65,
                 a 5,000-bp operon read, reads of one tile of positions, one
                 more, three tiles and 12,000 bp; reads from every byte
                 offset mod 16, the last ending the buffer off a 16-byte
                 boundary; reads one position each side of one and two
                 rounds of a position a thread and of a tile, qualities all
                 equal or equal but for the last base) at k = 17 and 31 (kernel
                 5 at c = 11 and one other c), with kernel 4's per-read
                 lists and the card's count held to the host's too; then
                 the kernel cell, 20,000 of write_reads' reads (29 M
                 positions): both kernels exact and timed with their
                 bounds, the compaction and the count's sort (a library
                 call) timed apart, the card's count equal to the host
                 scan's; then phase 5's reads through read_to_split_kmers
                 on the host and on the card in turns, without -b and with
                 it, with the stage's seconds by part (COUNT_STATS) and
                 equal tables, and one
                 `asv --stage1-backend mesh` held to DIGESTS, kernel 4
                 launched by it;
  operon       - the rRNA-operon preset (--rrna-operon: reads of 3,500 to
                 5,000 bp, band 128).  Kernels 1 (both modes) and 2 at
                 operon shapes: 512 reads of 16 random 4,400-bp templates
                 through the planner at band 128 (ops_max about 9,000),
                 against their plain versions on the card at tolerance 0
                 and the job routes against the host oracle, each timed as
                 20 queued launches and one alone, with its bound and
                 kernel 2's pairs a block.  Then a seed-pinned 10,000-read
                 operon sample (10 templates of 4,400 bp, phase 5's error
                 model) through `asv --rrna-operon` on the card, once
                 untimed, once timed, once with --stage1-backend mesh: each
                 held to DIGESTS_OPERON (the JAX package's host run), NM=0,
                 kernels 1 (both modes) and 2 launched (and kernel 4 by the
                 mesh run), no plain version, no fallback, stage 7 carrying
                 at least 5,000 jobs, both device routes every job their
                 planner made in launches their wrappers counted; each
                 run's wall, stage seconds, route seconds, launch cut,
                 overflow pairs and kernel 2's pairs
                 a block printed, with nvidia-smi's name and power limit;
  scale        - one ONT PromethION 16S barcode's scale: a seed-pinned
                 sample of 100,000 reads (scale_sample: phase 5's error
                 model, 48 templates, 24 random and a 4-6 SNP variant of
                 each, in even abundance) through `asv` on the card on the
                 default routes and with --stage1-backend mesh: each held
                 to DIGESTS_SCALE (the JAX package's host run), all 48 ASVs
                 at NM=0, kernels 1 (both modes) and 2 launched (and 4 by
                 the mesh run), no plain version, no fallback, stages 4 and
                 7 each in two launches or more carrying every planned job,
                 in launches their wrappers counted; each run's wall,
                 stage seconds, route seconds, launch cut
                 and torch.cuda.max_memory_allocated printed (and stage 1's
                 count under mesh).  Then build_emu_slice of the 48
                 templates at 100,000 references, `classify` of the 48 ASVs
                 and of 40 hard ASVs cut from that database and `sintax` of
                 the 48 ASVs, held to DIGESTS_SCALE_CLASSIFICATION, sintax
                 over every reference in chunks of 4,096 (25 launches each
                 of kernels 6 and 3, every row extracted on the card).
                 Then kernel 1 (NM) on one full stage-7 launch of the sample (16,384 jobs at band 48) and kernel 3 on the
                 48 ASVs' 4,800 pairs (two pair tiles) against the first
                 4,096 references: each against its plain version at
                 tolerance 0, timed as 20 queued launches and one alone,
                 with its bound;
  8. ranks     - the port over ranks (parallel/distributed.py), the ranks
                 being this script again with --rank-worker, each into its
                 own directory; a rank that fails fails the run.  One NCCL
                 rank through the CLI under SAVONT_COORDINATOR /
                 _NUM_PROCESSES / _PROCESS_ID on phase 5's reads: DIGESTS,
                 phase 5's jobs, NCCL all_gather (stage 7) and all_reduce
                 (stage 4) counted.  Two ranks sharing the card over gloo:
                 `asv` on phase 5's reads (DIGESTS on each rank, the ranks'
                 stage-4 and stage-7 jobs adding up to phase 5's, each more
                 than none, no fallback), `sintax` of phase 5's ASVs against phase 6's
                 database (DIGESTS_CLASSIFICATION's files; the ranks'
                 references adding up to phase 6's, neither above 60%),
                 split_kmer_count over the ranks at phase 7's kernel cell
                 (equal to the one-card count) and sharded_classify_nm of
                 phase 5's ASVs against the first 1,000 references (equal to
                 one rank's); with two cards or more, the same over NCCL,
                 one card a rank.  One `ranks` JSON line gives each run's
                 walls beside nvidia-smi's name and power limit, the
                 collectives' calls and bytes and each rank's share.
The last three lines of stdout are nvidia-smi's name / power limit, the
kernels JSON, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BAND = 48
OPERON_BAND = 128
N_PAIRS_MIN = 2048
N_READS = 5000
N_READS_SMALL = 1500   # the per-job consumers' run
TEMPLATE_LEN = 1450
SEED = 2026
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MAXRUN = 512
# a shared-memory load's round trip, in cycles, and the SM clock it is turned
# into time at, both assumed and not measured here: about 30 cycles is what
# the pointer-chasing microbenchmark of Luo et al., "Dissecting the NVIDIA
# Hopper Architecture through Microbenchmarking and Multiple Level Analysis"
# (arXiv:2402.13499, 2024, its table of memory latencies), reads for shared
# memory on an H100; 1.98 GHz is the largest SM clock nvidia-smi reports for
# the H100 SXM
LDS_ROUND_TRIP_CYCLES = 30
SM_CLOCK_HZ = 1.98e9
EDGE_BANDS = (1, 7, 32, 33, 48, 64, 100, 128, 200, 256)
EDGE_SEED = 2027
# integer instructions per DP cell of the sequential recurrence: the count
# behind kernel 1's bound, which does not move with the implementation.  It
# was taken from the SASS of the one-thread-per-pair kernel that walked the
# band in sequence (band <= 64): NM mode 61 of the 88 instructions of a
# one-cell loop trip, payload mode 121 of 146 in a two-cell trip; the rest
# were loads, stores and branches.  The warp-per-pair kernel's own row loop
# is listed by python -m savont_tpu_torch.probes.roofline --sass DIR
OPS_PER_CELL = {"sw_forward_nm": 61, "sw_forward_payload": 60.5}
# sha256 of the outputs of the JAX package's host run_cluster(threads=4) on
# write_reads' fastq, named reads.fq.gz
DIGESTS = {
    "final_asvs.fasta": "f77dec4f95ac143c7f9744bd6fca0b8757824af1f1e85d39c04208a6b2bb6f13",
    "feature-table.tsv": "5508ec928bf4106aaece7efe0c686abb5f30c8a15b0f37c7d911f85ae37a5463",
    "temp/read_to_asv_mappings.tsv": "edaf681418d63f60bc88d8e4ad7bd85924beff57901ca6380f76d987525944cd",
}
# the same on write_reads' N_READS_SMALL sample
DIGESTS_SMALL = {
    "final_asvs.fasta": "87c981361e01054f4f74012e3e1c1808167b483b298564ae9379372e21d7441b",
    "feature-table.tsv": "1c1b7107daedd81a76a11857b552dd88f050805814caa756762c6e5b96114499",
    "temp/read_to_asv_mappings.tsv": "6897ce9c6e927edd0e732e75e67263db6364f216e283caabb7e2e70a9c12a2e2",
}
# phase 6: the classification cell
DB_REFS = 10_000        # build_emu_slice's default size
DB_SEED = 11
N_HARD = 40             # hard ASVs cut from DB references
HARD_SEED = SEED + 6
EXPORT_LABELS = ("main_path", "host_routes")  # export's sample names for the two runs
SMS = 132               # H100 SXM
LDS_PER_CLOCK = 32      # shared-memory loads an SM serves a clock (32 banks)
ORD_MASK = 0x3FFFFFF    # the largest ordinal a sintax key holds
SINTAX_PAIR_TILE = 4096  # kernel 3's pairs a block (kPairTile, ops/csrc/sintax_scores.cu)
SINTAX_SMEM_KEYS = 4096  # the most query keys kernel 3 stages a block (kSmemKeys, the same file)
# kernel 3's timed query matrices: phase 5's ASVs (one pair tile), the hard
# ASVs (one tile, D past SINTAX_SMEM_KEYS) and both in one run (two tiles)
SINTAX_SHAPES = ("mesh", "hard", "mesh_hard")
SINTAX_REF_TILE = 2048   # kernel 6's positions a staged tile (kTile, ops/csrc/sintax_ref_kmers.cu)
SINTAX_REF_OPTIN = 12_288  # k-mers past which kernel 6's shared memory needs the opt-in (48 KB)
# sha256 of the outputs of the JAX package's host runs, in a fresh process
# (band 128), on the classification cell's inputs: its build_emu_slice of
# phase 5's templates, classify of the phase-5 ASVs (written into their
# directory) and of write_hard_asvs' ASVs, sintax of the phase-5 ASVs and
# export of the phase-5 and small-sample directories (relabelled); paths relative to the
# work directory (tests/test_torch_chip_smoke.py re-derives them)
DIGESTS_CLASSIFICATION = {
    "db/emu/species_taxid.fasta": "1df58e52aef73664c0cbc02741923fd7ce6dd8bc1374c22f9db7af9924084988",
    "db/emu/taxonomy.tsv": "3cb59010f9eb05e918b8104c7db9869bdc903a645e97c22c448a5e7e17a7407b",
    "mesh/species_abundance.tsv": "e8b2011f9e361c051e1cafdf2b82ca3441eda81c450f8448ed9f4fa81cf4d6cd",
    "mesh/genus_abundance.tsv": "2070ca12b41e8adffdc8298e62e61ccd95b91dfa1d1d5a86a8ae2ef00f32d03e",
    "mesh/asv_mappings.tsv": "c9fd03eed3a149f08741cf4fb9ab3303f1cc0bcc3e5a02875d46b56b86d5ada9",
    "hard/species_abundance.tsv": "38076853719efc8603ff7511e1a1fc17eb44f3b44cd755645a03dfe230d2e052",
    "hard/genus_abundance.tsv": "c8798393a17f36f01e27b107397057c12c4bfe819f98785944051558751eb58f",
    "hard/asv_mappings.tsv": "f990c45676a726fe3aae7c5b5e77e9ae5a4da32f8e18be5c9edf560d233964bc",
    "sintax/genus_abundance.tsv": "2070ca12b41e8adffdc8298e62e61ccd95b91dfa1d1d5a86a8ae2ef00f32d03e",
    "sintax/asv_mappings.tsv": "37af17db4161d0d13ef22c4d9598b3a1c5c0f1a5a9cb5f4c5ecd7a8eeb579751",
    "export/merged_feature_table.tsv": "e063174d4cb8da22d446f6d4de1a36a8f29b4bc48975ae873d515882663a65cd",
    "export/merged_rep_seqs.fasta": "b8cfff01428ce90207ca5eb4afa828a4ba74f07eb2a4317f7676d904535252f5",
    "export/merged_asv_taxonomy.tsv": "2aedcfcd0ab7b63cc4613542e3d9e83709992b3720b7160183d176792e4ffb34",
    "export/merged_taxon_counts.tsv": "b950ef75a0eae0162dc913bcf27c21c172e10100c37dbc459c7809a480f55d6c",
}
# phase 7: stage-1 device k-mers
KMER_KS = (17, 31)          # kernel 4's k at the edge cases (17: -k's default)
SYNC_KC = ((17, 11), (17, 7), (31, 11), (31, 21))  # kernel 5's (k, c) there (c = 11: -c's default)
MIN_BQ = 25                 # --minimum-base-quality's default
KMER_TILE = 2048            # positions a block stages at once (kTile, ops/csrc/split_kmers.cu, syncmers.cu)
KMER_THREADS = 256          # threads a block, one position each in turn (kThreads, the same sources)
N_KMER_READS = 20_000       # the kernel cell
KMER_SEED = SEED + 7
STAGE1_ORDER = ("host", "mesh", "mesh", "host", "host", "mesh")  # read_to_split_kmers turns
STAGE1_BLOOM_ORDER = ("host", "mesh", "mesh", "host")  # the same with -b, at the main-path cell
STAGE1_BLOOM_SIZE = 1.0     # -b's value there
# 32-bit integer operations a position the functions need, counted for a
# rolling scan in C with a 64-bit shift, or, and, add, xor or compare as two
# (the kernels take each k-mer from packed words instead): kernel 4
# rolls a forward and a reverse k-mer (14), masks both (4), compares them
# (4), selects and flags (3) and gates (3); kernel 5 rolls an s-mer pair
# (14), takes its minimum (3) and hashes it (19 64-bit operations, 38), rolls
# and compares a k-mer pair (22), and tests the centre hash against the
# minimum of each side of its window: a sliding minimum of one side's width
# (prefix and suffix minima in blocks of that width and one to join them,
# 3 64-bit minimums of 3, whatever the width), one for each distinct width
# above 1, then a compare with each side (2) and their and (1), as kernel
# 5 does
KMER_OPS = {"split_kmers": 28, "syncmers": 77, "sliding_min": 9, "side_compare": 2}


def syncmer_ops(c: int) -> int:
    """KMER_OPS of kernel 5's function a position at c: the window of c
    hashes has (c - 1) // 2 on the centre's left and the rest on its
    right."""
    sides = [w for w in ((c - 1) // 2, c - 1 - (c - 1) // 2) if w > 0]
    if not sides:
        return KMER_OPS["syncmers"]
    return (KMER_OPS["syncmers"] + KMER_OPS["sliding_min"] * len({w for w in sides if w > 1})
            + KMER_OPS["side_compare"] * len(sides) + len(sides) - 1)


# phase "operon": the rRNA-operon preset (--rrna-operon: reads of 3,500 to
# 5,000 bp, DP band 128) on one ONT 16S-ITS-23S operon barcode's worth of reads
N_READS_OPERON = 10_000
OPERON_TEMPLATE_LEN = 4400
OPERON_SEED = SEED + 8          # the sample's own generator
OPERON_KERNEL_SEED = SEED + 9   # the jobs of kernels 1 and 2 at operon shapes
OPERON_KERNEL_TEMPLATES, OPERON_KERNEL_READS = 16, 32  # 512 reads through the planner
# sha256 of the outputs of the JAX package's host run_cluster(threads=4,
# rrna_operon=True) on write_reads' operon sample (operon_sample)
DIGESTS_OPERON = {
    "final_asvs.fasta": "a5caabf08d94c0017423f9b6d59ad174e50280392ce1b32481882646b7bf547f",
    "feature-table.tsv": "a3d9ec279c7017d8a35a8810527a2723fc41ed34a1556e771a419f55abb40d7b",
    "temp/read_to_asv_mappings.tsv": "91054c6e10d25896a61944083abaa9e4bd543b1d0673c11964e8e2e4559eb3a6",
}
# phase "scale": one ONT PromethION 16S barcode's worth of reads from a
# community of tens of taxa, classified against 100,000 references
N_READS_SCALE = 100_000
N_TEMPLATES_SCALE = 48          # 24 random templates and a 4-6 SNP variant of each
SCALE_SEED = SEED + 10          # the sample's own generator
SCALE_BATCH = 10_000            # reads drawn at once
SCALE_DB_REFS = 100_000
# sha256 of the outputs of the JAX package's host `asv -t 4`, in a fresh
# process, on scale_sample's reads
DIGESTS_SCALE = {
    "final_asvs.fasta": "11029928b9034bda8f028e43be9be62962bb9d34d77b448d45160bd34548b90d",
    "feature-table.tsv": "0871bf06da7e55f884c0266e862bd3e9a3e940e39b63fc49d02b0692b5499f82",
    "temp/read_to_asv_mappings.tsv": "2574b6732c3dffc4d7050993f86b9704435e780c47ac260032436e0356430e32",
}
# the same for its build_emu_slice of the scale templates (SCALE_DB_REFS
# references, DB_SEED), `classify` of the scale ASVs (written into their
# directory, asv/) and of write_hard_asvs' ASVs cut from that database
# (hard/), and `sintax` of the scale ASVs (sintax/), each in a fresh process
# (band 128); paths relative to the scale phase's directory
# (tests/test_torch_scale_digests.py re-derives both sets)
DIGESTS_SCALE_CLASSIFICATION = {
    "db/emu/species_taxid.fasta": "56342b43e1d66a582c5ecdc3105ab407445a42672c59d7f376d138cee37e4982",
    "db/emu/taxonomy.tsv": "b1f31fac1e8ac1d50c08286e429a5a4adaafc30119a84c5d911e02c1b494b871",
    "asv/species_abundance.tsv": "e1fd44c77682c8ae621e02cad616d2da0915468e2115bc47f4c33d0db6490d4b",
    "asv/genus_abundance.tsv": "b480352fa00ca1d0a8b7006af8ab896a09268b546aa12353ec8476c3bb3255db",
    "asv/asv_mappings.tsv": "6658d2bad5464ab9c2024904abb175c62710f15ee24b7a224a263426c4bf3134",
    "hard/species_abundance.tsv": "8d7ea48379d166c73184174006038c9f864fc0dabed6ce2577205d0ce5502de4",
    "hard/genus_abundance.tsv": "10b16c9e295901d9b196abf3e1d3856c7648ad5c8445296927be4ccef297e692",
    "hard/asv_mappings.tsv": "0d0da052201e457b10b3f688a8a1dda624de2bc6ee17bc3b497b425f4e1fac87",
    "sintax/genus_abundance.tsv": "b480352fa00ca1d0a8b7006af8ab896a09268b546aa12353ec8476c3bb3255db",
    "sintax/asv_mappings.tsv": "aeaea4c5f191f28884ad45268b2cd6e46def0620e16c6466942165f114dcd74c",
}
# kernel 2's shared memory (ops/csrc/sw_walk.cu: kWarps, kStages, kMaxRows,
# kWindowBytes, kMaxShared)
WALK_WARPS, WALK_STAGES, WALK_MAX_ROWS, WALK_WINDOW_BYTES = 4, 3, 32, 4096
WALK_MAX_SHARED = 227 * 1024


# phase 8: ranks (parallel/distributed.py)
RANKS = 2                  # ranks of the gloo runs
RANKS_TIMEOUT_S = 300      # a run's ranks are killed past this
RANKS_CLASSIFY_REFS = 1000  # sharded_classify_nm: the phase-5 ASVs against the first 1,000 references
# the one-host ranks' collectives go over loopback
RANK_ENV = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo"}


KERNELS = {  # name: (source, the TPU kernel it replaces)
    "sw_forward_nm": ("savont_tpu_torch/ops/csrc/sw_forward.cu", "savont_tpu/ops/align_pallas.py:296"),
    "sw_forward_payload": ("savont_tpu_torch/ops/csrc/sw_forward.cu", "savont_tpu/ops/align_pallas.py:296"),
    "sw_walk": ("savont_tpu_torch/ops/csrc/sw_walk.cu", "savont_tpu/ops/align_jax.py:414"),
    "roofline_peak": ("savont_tpu_torch/ops/csrc/roofline.cu", "scripts/pallas_roofline.py:43"),
    "roofline_ilp": ("savont_tpu_torch/ops/csrc/roofline.cu", "scripts/pallas_roofline.py:59"),
    "roofline_swar": ("savont_tpu_torch/ops/csrc/roofline.cu", "scripts/pallas_roofline.py:87"),
    "probe_bitcast": ("savont_tpu_torch/ops/csrc/probe_bitcast.cu", "scripts/pallas_probe_bitcast.py:24"),
    **{f"probe_i16_{op}": ("savont_tpu_torch/ops/csrc/probe_i16ops.cu",
                           f"scripts/pallas_probe_i16ops.py:{line}")
       for op, line in (("max", 44), ("lt", 45), ("eq", 46), ("select", 47), ("sra15", 48),
                        ("bitsel", 49), ("dpx", 22))},
    **{f"probe_roll_{mode}": ("savont_tpu_torch/ops/csrc/probe_roll.cu", "scripts/pallas_probe_roll.py:25")
       for mode in ("add", "shfl", "smem")},
    "sintax_scores": ("savont_tpu_torch/ops/csrc/sintax_scores.cu", "savont_tpu/parallel/mesh.py:977"),
    # no TPU kernel: the host extraction it takes over
    "sintax_ref_kmers": ("savont_tpu_torch/ops/csrc/sintax_ref_kmers.cu",
                         "savont_tpu/pipeline/sintax.py:162"),
    "split_kmers": ("savont_tpu_torch/ops/csrc/split_kmers.cu", "savont_tpu/ops/kmers_jax.py:64"),
    "syncmers": ("savont_tpu_torch/ops/csrc/syncmers.cu", "savont_tpu/ops/kmers_jax.py:104"),
}


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_done(name: str) -> None:
    log(f"[{time.perf_counter() - T0:6.1f} s] {name} done")


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean device milliseconds per call over `reps` calls, after a warm-up
    call unless the caller has made one."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mutate(rng, seq: bytes, kind: int) -> bytes:
    """1.5% substitutions plus, by kind: 0 none, 1 one 1-6 bp deletion,
    2 one 40-60 bp deletion, 3 three 1-6 bp deletions."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    b = np.frombuffer(seq, dtype=np.uint8).copy()
    nsub = rng.binomial(len(b), 0.015)
    pos = rng.choice(len(b), nsub, replace=False)
    b[pos] = bases[(np.searchsorted(bases, b[pos]) + rng.integers(1, 4, nsub)) % 4]
    s = b.tobytes()
    cuts = {0: [], 1: [(1, 6)], 2: [(40, 60)], 3: [(1, 6)] * 3}[kind]
    for lo_len, hi_len in cuts:
        p = int(rng.integers(100, len(s) - 160))
        s = s[:p] + s[p + int(rng.integers(lo_len, hi_len + 1)):]
    return s


def make_pairs(rng, n_templates: int, reads_per: int,
               template_len: int = TEMPLATE_LEN) -> list[tuple[bytes, list[bytes]]]:
    """n_templates random templates of template_len bases, each with
    reads_per mutated reads."""
    import numpy as np

    from savont_tpu_torch.ops.encode import revcomp_bytes

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for _ in range(n_templates):
        t = rng.choice(bases, template_len).tobytes()
        reads = []
        for k in range(reads_per):
            q = mutate(rng, t, k % 4)
            if (k // 4) % 2:
                q = revcomp_bytes(q)
            reads.append(q)
        out.append((t, reads))
    return out


def plan(pairs, band: int) -> list:
    """The port's planner over make_pairs' output: one index per template."""
    from savont_tpu_torch.ops.align import TargetIndex
    from savont_tpu_torch.ops.align_batch import plan_jobs

    jobs = []
    for t, reads in pairs:
        idx = TargetIndex([t])
        for q in reads:
            jobs.extend(plan_jobs(idx, q, band=band, min_anchors=2))
    return jobs


def edge_case(rng, name: str, band: int, B: int, Lq: int) -> dict:
    """B raw pairs at `band`: per-row advances drawn from 0, 1, 2, 3, band-1,
    band and band+5 (row 1 included; every second pair advances by 1 in 93%
    of its rows), corridors that start at column 0 to 3, target lengths by
    pair index (0, 1, below the band, inside the last corridor rows, past
    them), queries read off the target along the corridor with an offset
    that moves mid-way (so E and F gaps win), 4% substitutions, codes 4 in
    both, a padded query tail (code 5), target padding (code 6) past each
    target's end, and one all-padding query, whose score is 0."""
    import numpy as np

    steps = np.array([0, 1, 2, 3, band - 1, band, band + 5])
    wild = rng.choice(steps, (B, Lq), p=[0.2, 0.62, 0.06, 0.04, 0.03, 0.03, 0.02])
    calm = rng.choice(steps, (B, Lq), p=[0.03, 0.93, 0.015, 0.01, 0.005, 0.005, 0.005])
    dl = np.where((np.arange(B) % 2 == 1)[:, None], calm, wild)  # odd pairs align at length
    lo = np.concatenate([rng.integers(0, 4, (B, 1)), dl], axis=1).cumsum(axis=1)
    lo[0] -= lo[0, 0]  # pair 0 starts at column 0: the free left edge
    if Lq > 1:
        lo[0, 1] = 0
        lo[0] = np.maximum.accumulate(lo[0])
    end = lo[:, -1] + band
    kinds = np.arange(B) % 8
    tlens = np.where(kinds == 5, 0, np.where(kinds == 6, 1, np.where(
        kinds == 7, rng.integers(1, max(band, 2), B), np.where(
            (kinds == 3) | (kinds == 4), np.maximum(end - band // 2 - 1, 1), end + 2))))
    Lt = int(max(tlens.max(), 1)) + 3
    t = rng.integers(0, 4, (B, Lt))
    t[rng.random((B, Lt)) < 0.03] = 4
    off = np.where(np.arange(Lq) < Lq // 2, band // 2,
                   np.where(np.arange(Lq) < 3 * Lq // 4, min(band // 2 + 3, band - 1), band // 2))
    q = np.take_along_axis(t, np.minimum(lo[:, 1:] + off[None, :], Lt - 1), axis=1)
    sub = rng.random((B, Lq)) < 0.04
    q[sub] = rng.integers(0, 4, int(sub.sum()))
    q[rng.random((B, Lq)) < 0.02] = 4
    q[kinds == 2, Lq - Lq // 10:] = 5
    if B > 4:
        q[4] = 5
    t[np.arange(Lt)[None, :] >= tlens[:, None]] = 6
    i32 = np.int32
    return {"name": name, "band": band, "q": q.astype(i32), "t": t.astype(i32),
            "lo": lo.astype(i32), "tlens": tlens.astype(i32)}


def tie_case(band: int) -> dict:
    """Three pairs whose maximum is reached in two rows and in several band
    cells: the target repeats ACGT, the query is six repeats, 30 rows of
    padding (which send every score back to 0) and the six repeats again.
    Corridors: one column per row, no advance at all, two columns per row."""
    import numpy as np

    unit = np.arange(4)
    q = np.concatenate([np.tile(unit, 6), np.full(30, 5), np.tile(unit, 6)])
    Lq = len(q)
    rows = np.arange(Lq + 1)
    lo = np.stack([np.maximum(rows - 1, 0), np.zeros(Lq + 1, int), 2 * np.maximum(rows - 1, 0)])
    Lt = int(lo.max()) + band + 8
    t = np.tile(unit, Lt // 4 + 1)[:Lt]
    i32 = np.int32
    return {"name": f"ties_band{band}", "band": band, "q": np.tile(q, (3, 1)).astype(i32),
            "t": np.tile(t, (3, 1)).astype(i32), "lo": lo.astype(i32),
            "tlens": np.full(3, Lt, i32)}


def edge_cases(seed: int = EDGE_SEED) -> list[dict]:
    """The edge shapes of phase 3: every band of EDGE_BANDS with 65 or 31
    pairs and a few hundred rows, batches of one pair, one-row queries, and
    the tie cases.  Each case: name, band, and int32 q (B, Lq), t (B, Lt),
    lo (B, Lq+1), tlens (B,)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cases = []
    for k, band in enumerate(EDGE_BANDS):
        B = (65, 31)[k % 2]
        Lq = (230, 157)[k % 2] if band <= 64 else (90, 61)[k % 2]
        cases.append(edge_case(rng, f"band{band}_B{B}_Lq{Lq}", band, B, Lq))
    cases.append(edge_case(rng, "band48_B1_Lq311", 48, 1, 311))
    cases.append(edge_case(rng, "band256_B1_Lq40", 256, 1, 40))
    cases.append(edge_case(rng, "band48_B31_Lq1", 48, 31, 1))
    cases.append(edge_case(rng, "band1_B1_Lq1", 1, 1, 1))
    cases.append(edge_case(rng, "band200_B65_Lq1", 200, 65, 1))
    cases += [tie_case(48), tie_case(33), tie_case(7)]
    return cases


def walk_window_rows(band: int) -> int:
    """Payload rows per shared-memory window of kernel 2 (sw_walk.cu:
    kWindowBytes / band, between 1 and kMaxRows)."""
    return min(32, max(1, 4096 // band))


def walk_case(rng, name: str, band: int, B: int, Lq: int, wild: bool = False, **over) -> dict:
    """Raw inputs of kernel 2 that kernel 1 need not have made: the walk is
    defined on any payload bytes.  Each of the six payload bits is drawn on
    its own: calm walks are long diagonals with short E and F runs and
    cross every window (under band 16 nearly pure diagonals, which a narrow
    band needs to get that far); `wild` ones change state at every other
    cell.  Rows advance by 0 to 3, or with `drift` by 0, 1 or 2 at 15 / 70 /
    15%, so that a diagonal run leaves a narrow band midway.  The start rows
    go round the window's edges (row 1, one under, at and one over W, 2W and
    3W, the last row), the start cells lie in the band's middle half, pair 5
    has score 0 and pair 11 a negative one.  `over` sets ops_max, maxrun,
    drift, offset (the bytes between the start of the payload's storage and
    its first byte, so that no pair is 16-byte aligned) and zero_rows (score
    0 except every third pair, the stage-4 route's mix)."""
    import numpy as np

    W = walk_window_rows(band)
    # use_g, g_zero, g_f, exitE, from_h, mismatch
    narrow = band < 16 and not wild
    p_bits = ((0.6, 0.01, 0.3, 0.5, 0.5, 0.5) if wild else
              (0.999, 0.001, 0.002, 0.6, 0.6, 0.05) if narrow else
              (0.97, 0.001, 0.03, 0.6, 0.6, 0.05))
    payload = np.zeros((B, Lq, band), np.uint8)
    for k, p in enumerate(p_bits):
        payload |= (rng.random((B, Lq, band)) < p).astype(np.uint8) << k
    dl = rng.choice(4, (B, Lq), p=[0.15, 0.7, 0.15, 0] if over.get("drift") else
                    [0.002, 0.996, 0.002, 0] if narrow else [0.05, 0.9, 0.03, 0.02])
    lo = np.concatenate([rng.integers(0, 4, (B, 1)), dl], axis=1).cumsum(axis=1)
    edges = [r for r in (1, 2, W - 1, W, W + 1, 2 * W - 1, 2 * W, 2 * W + 1, 3 * W, 3 * W + 1,
                         Lq - 1, Lq) if 1 <= r <= Lq]
    ri = np.array([edges[b % len(edges)] for b in range(B)])
    bj = rng.integers(band // 4, max(3 * band // 4, band // 4 + 1), B)
    score = np.ones(B, int)
    score[5:B:12] = 0
    score[11:B:12] = -3
    if over.get("zero_rows"):
        score[np.arange(B) % 3 != 0] = 0
    i32 = np.int32
    return {"name": name, "band": band, "payload": payload, "lo": lo.astype(i32),
            "score": score.astype(i32), "ri": ri.astype(i32), "bj": bj.astype(i32),
            "ops_max": over.get("ops_max", 600), "maxrun": over.get("maxrun", MAXRUN),
            "offset": over.get("offset", 0)}


def walk_runs_case(name: str, band: int, maxrun: int) -> dict:
    """Six pairs whose payload bits are laid along a chosen path, so that the
    CIGAR has exactly maxrun - 1, maxrun and maxrun + 1 runs (the last an
    overflow), each once with the path running into row 0 and once stopped
    three rows above it by a cell of G = 0.  Forward, the runs are M, I, M, D,
    M, I, ... of one or two ops each; every advance is 1, so an insertion
    moves the band cell up by one and a deletion back.  Returns the inputs of
    walk_case, and n_runs (6,), what the walk must count."""
    import numpy as np

    M, I, D = 0, 1, 2
    targets = [maxrun - 1, maxrun, maxrun + 1] * 2
    Lq = 2 * (maxrun + 1) + 8
    B = len(targets)
    payload = np.zeros((B, Lq, band), np.uint8)
    ri = np.zeros(B, int)
    bj0 = band // 2
    for b, n in enumerate(targets):
        runs = [(M, 1 + k % 4 // 2) if k % 2 == 0 else ((I, D)[k // 2 % 2], 1 + k % 3 // 2)
                for k in range(n)]
        back = [op for op, length in reversed(runs) for _ in range(length)]
        rows = sum(op != D for op in back)
        spare = 3 * (b >= 3)  # rows left above the path: it ends on a G = 0 cell
        r, j, st = rows + spare, bj0, "H"
        ri[b] = r
        for k, op in enumerate(back):
            nxt = back[k + 1] if k + 1 < len(back) else None
            cell = payload[b, r - 1]
            if op == M:
                cell[j] |= (st == "H") * 1 | (k % 7 == 0) * 32
                r, st = r - 1, "H"
            elif op == I:
                cell[j] |= (st == "H") * 1 | (st != "F") * 4 | (nxt != I) * 16
                r, j, st = r - 1, j + 1, "F" if nxt == I else "H"
            else:
                if st == "G":
                    raise AssertionError("a deletion cannot follow the exit of a deletion")
                cell[j] |= (nxt != D) * 8
                j, st = j - 1, "E" if nxt == D else "G"
        if r > 0:
            payload[b, r - 1, j] |= 1 | 2  # the last op was a match: state H, use_g, G = 0
    i32 = np.int32
    return {"name": name, "band": band, "payload": payload,
            "lo": np.tile(np.arange(Lq + 1), (B, 1)).astype(i32), "score": np.ones(B, i32),
            "ri": ri.astype(i32), "bj": np.full(B, bj0, i32), "ops_max": max(3 * Lq, 600),
            "maxrun": maxrun, "offset": 0, "n_runs": np.array(targets, i32)}


def walk_edge_cases(seed: int = EDGE_SEED + 1) -> list[dict]:
    """The edge shapes of kernel 2 alone: every band class with start rows on
    the window edges and payloads at every alignment, wild payloads,
    diagonal runs that drift out of a narrow band, the stage-4 mix (two
    thirds of the rows at score 0), a walk cut by ops_max in the middle of a
    window (with a start row of 0, which kernel 1 never gives), and CIGARs
    of maxrun - 1, maxrun and maxrun + 1 runs for maxrun 4, 5 (rows that are
    no multiple of 16 bytes) and 512.  Each case: name,
    band, payload (B, Lq, band) uint8, int32 lo (B, Lq+1), score, ri, bj (B,),
    ops_max, maxrun, offset."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cases = []
    for k, band in enumerate((1, 7, 33, 48, 100, 128, 200, 256)):
        Lq = 3 * walk_window_rows(band) + 5
        cases.append(walk_case(rng, f"walk_band{band}", band, 24, Lq,
                               offset=(0, 1, 5, 8, 15, 3, 0, 7)[k]))
    cases.append(walk_case(rng, "walk_wild_band48", 48, 65, 101, wild=True, offset=13))
    cases.append(walk_case(rng, "walk_wild_band7_maxrun5", 7, 31, 131, wild=True, maxrun=5,
                           offset=2))
    cases.append(walk_case(rng, "walk_drift_band7", 7, 65, 101, drift=True, offset=11))
    cases.append(walk_case(rng, "walk_mix_band48", 48, 96, 101, zero_rows=True))
    cut = walk_case(rng, "walk_opsmax40_band48", 48, 24, 101, ops_max=40, offset=9)
    cut["ri"][:2] = 0  # reads row 0 for one op
    cases.append(cut)
    cases += [walk_runs_case(f"walk_runs_maxrun{m}", 48, m) for m in (4, 5, 512)]
    return cases


def check_edge_shapes() -> int:
    """Kernel 1 in both modes and kernel 2 on its payload against their plain
    versions on the card, exact, over edge_cases; then kernel 2 alone over
    walk_edge_cases.  Returns the case count."""
    import torch

    from savont_tpu_torch.ops.align_torch import sw_forward, sw_forward_reference
    from savont_tpu_torch.ops.traceback_torch import (
        walk_rle, walk_rle_launch, walk_rle_reference,
    )

    walk_cases = walk_edge_cases()
    for case in walk_cases:
        band, off = case["band"], case["offset"]
        # the payload as a view that ends with its storage
        storage = torch.empty(off + case["payload"].size, dtype=torch.uint8, device="cuda")
        payload = storage[off:].view(case["payload"].shape)
        payload.copy_(torch.from_numpy(case["payload"]))
        args = (payload, *(torch.from_numpy(case[k]).cuda() for k in ("lo", "score", "ri", "bj")),
                band, case["ops_max"], case["maxrun"])
        got = walk_rle(*args)
        torch.cuda.synchronize()
        want = walk_rle_reference(*args)
        err = max_abs_diff(zip(got, want))
        if err:
            raise AssertionError(f"edge case {case['name']}: kernel 2 differs from its plain "
                                 f"version by {err}")
        n_runs = want[1][:, 0]
        log(f"  edge {case['name']}: {payload.shape[0]} pairs, Lq {payload.shape[1]}, band {band}, "
            f"payload {payload.data_ptr() % 16} bytes past a 16-byte line, ops_max "
            f"{case['ops_max']}, maxrun {case['maxrun']}, {int((args[2] <= 0).sum())} of score "
            f"<= 0, {int((n_runs > case['maxrun']).sum())} overflowed, longest path "
            f"{int((want[1][:, 2] - want[1][:, 1]).max())} rows: walk == plain (exact)")
    # a warp keeps ops_max op bytes in shared memory: at 150,000 one warp is a
    # block and the walk is still exact; at 300,000 no block holds them, and
    # the wrapper says so instead of launching
    big = (*args[:6], 150_000, case["maxrun"])
    if max_abs_diff(zip(walk_rle(*big), walk_rle_reference(*big))):
        raise AssertionError("kernel 2 differs from its plain version at ops_max 150,000")
    try:
        walk_rle_launch(*args[:6], 300_000, case["maxrun"])
    except ValueError as e:
        log(f"  edge ops_max 150,000: walk == plain (exact); ops_max 300,000 refused: {e}")
    else:
        raise AssertionError("kernel 2 took an ops_max that no block's shared memory holds")

    cases = edge_cases()
    for case in cases:
        band = case["band"]
        q, t, lo, tl = (torch.from_numpy(case[k]).cuda() for k in ("q", "t", "lo", "tlens"))
        ops_max = q.shape[1] + t.shape[1]
        nm_k = sw_forward(q, t, lo, tl, band)
        pay_k = sw_forward(q, t, lo, tl, band, emit_payload=True)
        payload, score, ri, bj = pay_k
        walk_k = walk_rle(payload, lo, score, ri, bj, band, ops_max)
        torch.cuda.synchronize()
        nm_r = sw_forward_reference(q, t, lo, tl, band)
        pay_r = sw_forward_reference(q, t, lo, tl, band, emit_payload=True)
        walk_r = walk_rle_reference(payload, lo, score, ri, bj, band, ops_max)
        err = {"sw_forward_nm": max_abs_diff([(nm_k, nm_r)]),
               "sw_forward_payload": max_abs_diff(zip(pay_k, pay_r)),
               "sw_walk": max_abs_diff(zip(walk_k, walk_r))}
        if any(err.values()):
            raise AssertionError(f"edge case {case['name']}: kernels differ from their plain "
                                 f"versions: {err}")
        log(f"  edge {case['name']}: {q.shape[0]} pairs, Lq {q.shape[1]}, band {band}, "
            f"{int((nm_r[:, 0] == 0).sum())} of score 0: NM, payload, walk == plain (exact)")
    return len(cases) + len(walk_cases)


def sintax_case(rng, name: str, P: int, R: int, L: int, chunk: int, **over) -> dict:
    """Raw inputs of kernel 3 in the JAX step's uint32 convention: R sorted
    rows of up to L unique k-mers (below 2^24) padded with 0xFFFFFFFF, P
    pairs of 32 slots drawn three quarters from the rows' k-mers (so scores
    spread) and a quarter at random, ordinals 0..R-1 launched `chunk` rows at
    a time into one accumulator.  `over`: `lengths` (each row's k-mer count,
    instead of drawn), `tie_rows` (rows that repeat row 0's k-mers, so their
    pairs tie across rows and chunks), `empty_rows` (rows of padding only),
    `hot` (every pair's first `hot` slots hold row 0's first k-mer: a key
    held by every pair, repeated in each), `sentinel_pairs` (k-mer-less
    ASVs: every slot 0xFFFFFFFE), `dup_pairs` (pairs whose 32 slots hold 3
    k-mers of row 1, so a repeated slot counts each time and the score is
    32), `full` (rows filled to L, no padding), `ridx` (the rows'
    ordinals)."""
    import numpy as np

    refk = np.full((R, L), 0xFFFFFFFF, dtype=np.uint32)
    lengths = over.get("lengths")
    for r in range(R):
        if lengths is not None:
            n = lengths[r]
        else:
            n = L if over.get("full") else int(rng.integers(max(1, L // 2), L + 1))
        refk[r, :n] = np.sort(rng.choice(1 << 24, n, replace=False))
    for r in over.get("tie_rows", ()):
        refk[r] = refk[0]
    for r in over.get("empty_rows", ()):
        refk[r] = 0xFFFFFFFF
    live = refk[refk != 0xFFFFFFFF]
    q = rng.integers(0, 1 << 24, (P, 32)).astype(np.uint32)
    if len(live):
        pick = rng.random((P, 32)) < 0.75
        q[pick] = rng.choice(live, int(pick.sum()))
    q[:, : over.get("hot", 0)] = refk[0, 0]
    for p in over.get("sentinel_pairs", ()):
        q[p] = 0xFFFFFFFE
    for p in over.get("dup_pairs", ()):
        q[p] = rng.choice(refk[1, :3], 32)
    ridx = np.asarray(over.get("ridx", range(R)), dtype=np.uint32)
    return {"name": name, "queries": q, "refk": refk, "ridx": ridx, "chunk": chunk}


def sintax_edge_cases(seed: int = EDGE_SEED + 2) -> list[dict]:
    """The edge shapes of kernel 3: ties of equal score across rows and
    across chunk boundaries, sentinel rows of k-mer-less ASVs, references
    with no k-mer, repeated slots with a score of 32, a row of 16,384
    k-mers, rows without padding, one pair against one reference; more
    distinct query k-mers than a block stages in shared memory
    (SINTAX_SMEM_KEYS, the last steps of a search in L2), more pairs than
    one pair tile (SINTAX_PAIR_TILE, the last tile ragged), a key held by every pair four times over two tiles,
    the largest ordinal at score 32 (key 0x80000000), rows of one k-mer
    beside rows of 13,000 and 20,000, and chunks of 4 rows that split runs
    of tied rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    top = ORD_MASK
    return [
        sintax_case(rng, "ties_chunks", 300, 40, 64, 7, tie_rows=(3, 6, 7, 8, 20, 39),
                    sentinel_pairs=(0, 17, 299), empty_rows=(5, 9, 33), dup_pairs=(1, 2, 150)),
        sintax_case(rng, "long_row", 257, 3, 16384, 3, tie_rows=(2,), dup_pairs=(5,)),
        sintax_case(rng, "full_rows", 33, 16, 8, 16, full=True, tie_rows=(15,)),
        sintax_case(rng, "one_pair_one_ref", 1, 1, 8, 1),
        sintax_case(rng, "one_pair_sentinel", 1, 2, 8, 1, sentinel_pairs=(0,)),
        sintax_case(rng, "many_keys", 3000, 24, 4096, 8, tie_rows=(9,), dup_pairs=(3,)),
        sintax_case(rng, "many_pairs", 2 * SINTAX_PAIR_TILE + 13, 12, 128, 5, tie_rows=(6,),
                    sentinel_pairs=(0, SINTAX_PAIR_TILE, 2 * SINTAX_PAIR_TILE + 12),
                    dup_pairs=(1, SINTAX_PAIR_TILE - 1, 2 * SINTAX_PAIR_TILE + 11)),
        sintax_case(rng, "hot_key", SINTAX_PAIR_TILE + 904, 10, 64, 4, hot=4, tie_rows=(3, 7),
                    sentinel_pairs=(17,), dup_pairs=(2,)),
        sintax_case(rng, "max_ordinal", 64, 4, 32, 2, dup_pairs=(0, 1, 63),
                    ridx=(5, top, 7, top - 1)),
        sintax_case(rng, "short_long_rows", 300, 6, 20000, 3, lengths=(1, 13000, 1, 20000, 2, 1),
                    dup_pairs=(7,)),
        sintax_case(rng, "ties_split", 200, 18, 16, 4, tie_rows=(1, 3, 4, 7, 8, 11, 12, 16, 17),
                    sentinel_pairs=(9,), dup_pairs=(5,)),
    ]


def sintax_ref_cases(seed: int = EDGE_SEED + 4) -> list[dict]:
    """Raw inputs of kernel 6, each a chunk of references (bytes) launched
    at once: every byte value; lowercase bases, U / u, N, IUPAC codes, '-'
    and '\\r'; rows of 0, 1, 11, 12 and 13 bases beside longer ones;
    homopolymers and tandem repeats (many repeated k-mers); a sequence and
    its reverse complement (the same row); k-mers that are their own reverse
    complement; rows from every byte offset mod 16, the last ending the
    buffer off a 16-byte boundary; rows one position each side of one, two
    and three staged tiles (SINTAX_REF_TILE), of a compaction tile and of a
    power of two; one chunk of 4,096 references of 1,330-1,570 bp, shaped
    like the sintax cell's EMU references; and rows longer than a block's
    shared memory holds (sorted in device memory; one of them of repeats
    only) beside rows that need the opt-in above 48 KB."""
    import numpy as np

    from savont_tpu_torch.ops.encode import revcomp_bytes

    rng = np.random.default_rng(seed)

    def rand(n: int, alphabet: bytes = b"ACGT") -> bytes:
        return rng.choice(np.frombuffer(alphabet, dtype=np.uint8), n).tobytes()

    def sprinkle(seq: bytes, share: float, alphabet: bytes) -> bytes:
        a = np.frombuffer(seq, dtype=np.uint8).copy()
        at = rng.random(len(a)) < share
        a[at] = rng.choice(np.frombuffer(alphabet, dtype=np.uint8), int(at.sum()))
        return a.tobytes()

    base = rand(1450)
    rc = revcomp_bytes(base)
    aligned = [rand(12 + 3 * i + (i % 16)) for i in range(48)]
    if sum(map(len, aligned)) % 16 == 0:
        aligned[-1] += b"A"
    tile = SINTAX_REF_TILE
    emu = []
    for i in range(4096):
        seq = rand(int(rng.integers(1330, 1571)))
        if i % 50 == 0:
            seq = sprinkle(seq, 0.01, b"NRYKMSWBDHVn")
        if i % 70 == 0:
            seq = seq[:400] + seq[400:900].lower() + seq[900:]
        emu.append(seq)
    return [
        {"name": "bytes", "seqs": [bytes(range(256)) * 3, rng.integers(0, 256, 700, dtype=np.uint8)
                                   .tobytes(), bytes(range(255, -1, -1)) + b"ACGT" * 10]},
        {"name": "case_u_n", "seqs": [base, base.lower(), base.replace(b"T", b"U"),
                                      base.lower().replace(b"t", b"u"),
                                      sprinkle(base, 0.05, b"NnRYKMSWBDHV-\r"),
                                      sprinkle(base, 0.3, b"acgtuU")]},
        {"name": "lengths", "seqs": [b"", rand(1), rand(11), rand(12), rand(13), rand(11).lower(),
                                     b"N" * 12, rand(13) + b"\r", rand(40), b"", rand(12)]},
        {"name": "repeats", "seqs": [b"A" * 500, b"c" * 300, b"T" * 1000, b"N" * 200, b"AC" * 300,
                                     b"ACGTTGCA" * 100, rand(12) * 50, rand(7) * 90, rand(100) * 5,
                                     rand(300) + b"G" * 600 + rand(300)]},
        {"name": "revcomp", "seqs": [base, rc, base.lower(), rc.lower(), rand(20)]},
        {"name": "palindromes", "seqs": [b"AAACCCGGGTTT", b"ACGTACGTACGT" * 20,
                                         b"".join(h + revcomp_bytes(h) for h in
                                                  (rand(6) for _ in range(100)))]},
        {"name": "alignments", "seqs": aligned},
        {"name": "tile_edges", "seqs": [rand(n + 11) for n in (
            tile - 1, tile, tile + 1, 2 * tile, 2 * tile + 1, 3 * tile - 1, 255, 256, 257, 1023,
            1024, 1025)]},
        {"name": "emu_chunk", "seqs": emu},
        {"name": "long_rows", "seqs": [rand(1450), rand(20_000), rand(57_000), rand(1450),
                                       rand(60_000), rand(131_083), rand(997) * 70, b"A" * 60_000,
                                       rand(13)]},
    ]


def check_sintax_ref_kmers() -> int:
    """Kernel 6 against its plain version on the card, exact, over
    sintax_ref_cases, one launch a case, each launch counted; long_rows
    must hold rows longer than the card's shared memory holds and one that
    needs the opt-in.  Returns the case count."""
    import numpy as np
    import torch

    from savont_tpu_torch.ops import sintax_torch as st
    from savont_tpu_torch.ops.build import build_kernels

    cap = build_kernels().sintax_ref_kmers_smem_cap()
    cases = sintax_ref_cases()
    for case in cases:
        host = st.ref_rows(case["seqs"])
        caps = np.diff(host[2])
        n0 = st.LAUNCHES["sintax_ref_kmers"]
        got = st.sintax_ref_kmers(st.ref_rows_on(*host, "cuda"))
        torch.cuda.synchronize()
        want = st.sintax_ref_kmers_reference(st.ref_rows_on(*host, "cpu"))
        if st.LAUNCHES["sintax_ref_kmers"] != n0 + 1:
            raise AssertionError(f"sintax ref case {case['name']}: {st.LAUNCHES} launches")
        if not torch.equal(got.cpu(), want):
            bad = np.flatnonzero((got.cpu() != want).numpy())
            r = int(np.searchsorted(host[2], bad[0], side="right")) - 1
            raise AssertionError(f"sintax ref case {case['name']}: kernel 6 differs from its "
                                 f"plain version at {len(bad)} of {len(want)} values, first in row "
                                 f"{r} of {len(caps)} ({caps[r]} k-mers)")
        if case["name"] == "long_rows" and not (caps.max() > cap and
                                                 ((caps > SINTAX_REF_OPTIN) & (caps <= cap)).any()):
            raise AssertionError(f"long_rows: capacities {caps.tolist()} against a shared-memory "
                                 f"cap of {cap} k-mers")
        kept = int((want != st.ROW_PAD).sum())
        log(f"  ref edge {case['name']}: {len(caps)} rows, {len(host[0])} bytes, {len(want)} "
            f"positions, {kept} distinct k-mers kept, longest row {caps.max(initial=0)}, "
            f"{int((caps > cap).sum())} rows past the shared-memory cap of {cap}: kernel 6 == plain "
            f"(exact)")
    return len(cases)


def sintax_ref_bound(n_bytes: int, R: int, n_kmers: int) -> dict:
    """Least time for kernel 6's function on a chunk: the bases read once,
    the two offset arrays read once and the rows written once, over the
    memory rate."""
    moved = n_bytes + 16 * (R + 1) + 4 * n_kmers
    return {"bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": moved}


def sintax_ref_cell(seqs: list, tag: str) -> dict:
    """Kernel 6 at the sintax route's chunk shape, one launch as the route
    makes it over the references `seqs`; against its plain version on the
    card and the library composition (the canonical k-mers as (row << 32 |
    k-mer) keys padded to the longest row, precomputed: torch.sort along
    the rows, then torch.unique_consecutive), exact; timed (queued and
    single) in the order library, plain, kernel, kernel, plain, library."""
    import numpy as np
    import torch

    from savont_tpu_torch.ops import sintax_torch as st
    from savont_tpu_torch.ops.kmers_torch import _pack
    from savont_tpu_torch.probes.roofline import QUEUED_RUNS, launch_ms

    host = st.ref_rows(seqs)
    rows = st.ref_rows_on(*host, "cuda")
    R, n = len(seqs), rows.n_kmers
    got = st.sintax_ref_kmers(rows)
    want = st.sintax_ref_kmers_reference(rows)
    # the library composition's input: every position's canonical k-mer,
    # keyed by its row, in rows padded past their ends with the row's
    # largest key
    caps = rows.row_off[1:] - rows.row_off[:-1]
    row = torch.repeat_interleave(torch.arange(R, device="cuda"), caps)
    pos = torch.arange(n, device="cuda") - rows.row_off[:-1][row]
    fwd, rev = _pack(st.BYTE_CODE.cuda()[rows.seqs.long()], rows.off[:-1][row] + pos, st.K)
    padded = (torch.arange(R, device="cuda")[:, None] << 32 | 0xFFFFFFFF).repeat(1, rows.max_n)
    padded[row, pos] = row << 32 | torch.minimum(fwd, rev)

    def library():
        return torch.unique_consecutive(torch.sort(padded, dim=1).values)

    lib = library()
    live = got != st.ROW_PAD
    torch.cuda.synchronize()
    lib_live = lib[(lib & 0xFFFFFFFF) != 0xFFFFFFFF]
    err = int(not torch.equal(got, want)) + int(not torch.equal(
        lib_live, row[live] << 32 | got[live].long()))
    if err:
        raise AssertionError(f"kernel 6 differs from its plain version or the library composition "
                             f"at {tag}'s chunk ({err})")
    out_t = torch.empty_like(got)
    l1 = launch_ms(library, reps=1)
    p1 = launch_ms(lambda: st.sintax_ref_kmers_reference(rows), reps=1)
    k1 = launch_ms(lambda: st.sintax_ref_kmers_launch(rows, out_t), runs=QUEUED_RUNS)
    k2 = launch_ms(lambda: st.sintax_ref_kmers_launch(rows, out_t), runs=QUEUED_RUNS)
    p2 = launch_ms(lambda: st.sintax_ref_kmers_reference(rows), reps=1)
    single = launch_ms(lambda: st.sintax_ref_kmers_launch(rows, out_t))
    l2 = launch_ms(library, reps=1)
    torch.cuda.synchronize()
    if not torch.equal(out_t, want):
        raise AssertionError(f"kernel 6's timed launches at {tag}'s chunk differ from its plain "
                             "version")
    b = sintax_ref_bound(len(host[0]), R, n)
    lens = np.diff(host[1])
    out = {"max_abs_err": err, "ms": min(k1, k2), "single_ms": single, "plain_ms": min(p1, p2),
           "library_ms": min(l1, l2), "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "shape": {"R": R, "bytes": len(host[0]), "kmers": n, "kept": int(live.sum()),
                     "len_min": int(lens.min()), "len_max": int(lens.max()),
                     "moved_bytes": b["bytes"]}}
    log(f"  sintax_ref_kmers at {tag}'s chunk ({R} references of {lens.min()}-{lens.max()} bp, "
        f"{len(host[0])} bytes, {n} positions, {out['shape']['kept']} distinct k-mers kept): "
        f"kernel {out['ms']:.4f} ms queued ({QUEUED_RUNS} launches; {k1:.4f}, {k2:.4f}), "
        f"{single:.4f} ms single, {100 * b['bound_ms'] / out['ms']:.1f}% of bound; plain "
        f"{out['plain_ms']:.2f} ms ({p1:.2f}, {p2:.2f}); library (torch.sort along the padded "
        f"rows + unique_consecutive) {out['library_ms']:.3f} ms ({l1:.3f}, {l2:.3f}); bound "
        f"{b['bound_ms']:.4f} ms (bytes: {b['bytes']} at {HBM_BYTES_PER_S / 1e12} TB/s); exact; "
        f"{nvidia_smi_line()}")
    return out


def sintax_route_check(db_dir: Path, asv_fasta: Path) -> dict:
    """sintax's scores on the card (_device_scores, kernels 6 and 3) against
    the host stream (_host_scores) for asv_fasta's ASVs (100 iterations)
    against db_dir: equal scores and taxa, every kept reference's row
    extracted by kernel 6 (kmer_rows_card == refs), kernel 6 launched once
    a chunk."""
    import dataclasses
    import math

    from savont_tpu_torch.db import registry
    from savont_tpu_torch.io.fastx import read_fastx
    from savont_tpu_torch.ops import sintax_torch as st
    from savont_tpu_torch.pipeline import sintax as route

    db = registry.load_database(db_dir)
    subs = route.query_matrix([r.seq.upper() for r in read_fastx(str(asv_fasta))], 100)
    for k in route.SCORE_STATS:
        route.SCORE_STATS[k] = type(route.SCORE_STATS[k])()
    st.reset_counters()
    t0 = time.perf_counter()
    dev_scores, dev_tax = route._device_scores(subs, db, len(subs), "cuda")
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_scores, host_tax = route._host_scores(subs, route.QUERY_SENTINEL, db, len(subs))
    host_s = time.perf_counter() - t0
    sx = dict(route.SCORE_STATS)
    as_rows = lambda tx: [None if e is None else dataclasses.astuple(e) for e in tx]
    if not ((dev_scores == host_scores).all() and as_rows(dev_tax) == as_rows(host_tax)):
        raise AssertionError("sintax: the scores on the card differ from the host stream's")
    launches = st.LAUNCHES["sintax_ref_kmers"]
    if not (sx["refs"] > 0 and sx["kmer_rows_card"] == sx["refs"] and
            launches == st.LAUNCHES["sintax_scores"] == math.ceil(sx["refs"] / route.CHUNK_ROWS)):
        raise AssertionError(f"sintax: kernel 6 did not extract every row: {sx}, {st.LAUNCHES}")
    if any(st.REFERENCE_CALLS.values()):
        raise AssertionError(f"sintax: plain versions called on the card: {st.REFERENCE_CALLS}")
    log(f"sintax route on the card == host stream ({len(subs)} pairs, {sx['refs']} references, "
        f"kmer_rows_card {sx['kmer_rows_card']}, {launches} launches of kernels 6 and 3): route "
        f"{dev_s:.3f} s (extract {sx['extract_s']:.3f} s, parse {sx['parse_s']:.3f} s, flush "
        f"{sx['flush_s']:.3f} s), host stream "
        f"{host_s:.3f} s")
    return {"stats": sx, "launches": launches, "route_s": dev_s, "host_s": host_s}


def sintax_refs_alone(work: Path) -> dict:
    """Kernel 6 alone, to iterate on it: the kernels built, its cases
    (check_sintax_ref_kmers), its time at the emu_chunk case, then
    sintax_route_check against a build_emu_slice of 8 random 1,450-bp
    templates (10,000 references) in `work`, those templates as the
    ASVs."""
    import numpy as np

    from savont_tpu_torch.db.synth import build_emu_slice
    from savont_tpu_torch.ops.build import build_kernels

    build_kernels()
    n = check_sintax_ref_kmers()
    cell = sintax_ref_cell(next(c["seqs"] for c in sintax_ref_cases() if c["name"] == "emu_chunk"),
                           "emu_chunk")
    rng = np.random.default_rng(SEED + 11)
    tpl = work / "templates.fa"
    tpl.write_text("".join(f">t{i}\n{''.join(rng.choice(list('ACGT'), TEMPLATE_LEN))}\n"
                           for i in range(8)))
    build_emu_slice(tpl, work / "db", n_refs=DB_REFS, seed=DB_SEED, device="cuda")
    route = sintax_route_check(work / "db" / "emu", tpl)
    return {"cases": n, "cell": cell, "route": route}


def max_jump(job) -> int:
    import numpy as np

    return int(np.diff(job.lo).max()) if len(job.lo) > 1 else 0


def max_abs_diff(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in pairs)


def check_kernels(jobs, band: int, time_plain: bool, queued: bool = False) -> dict:
    """Kernels 1 and 2 against their plain versions on the card, and the
    port's job routes against the port's host oracle.  Returns per kernel
    the error and its time, with `time_plain` the plain version's time too,
    and the shapes the bounds need.  Kernel 1's time is the better of two
    means of 5 launches, or with `queued` the mean of QUEUED_RUNS launches
    queued back to back with one launch alone beside it (single_ms), as
    kernel 2's always is; with `queued` the plain version is timed once,
    before the kernel, not in turns around it (at operon shapes one call
    takes seconds)."""
    import numpy as np
    import torch

    from savont_tpu_torch.ops.align_torch import (
        jobs_to_tensors, sw_forward, sw_forward_jobs, sw_forward_reference,
    )
    from savont_tpu_torch.ops.host_dp import run_jobs_host, run_jobs_nm_host
    from savont_tpu_torch.ops.traceback_torch import (
        sw_traceback_jobs, walk_rle, walk_rle_launch, walk_rle_reference,
    )
    from savont_tpu_torch.probes.roofline import QUEUED_RUNS, launch_ms

    order = sorted(range(len(jobs)), key=lambda i: len(jobs[i].qcodes))
    sjobs = [jobs[i] for i in order]
    q, t, lo, tl = jobs_to_tensors(sjobs, "cuda")
    B, Lq = q.shape
    Lt = t.shape[1]
    ops_max = Lq + Lt
    res = {}

    nm_k = sw_forward(q, t, lo, tl, band)
    nm_r = sw_forward_reference(q, t, lo, tl, band)
    torch.cuda.synchronize()
    res["sw_forward_nm"] = {"max_abs_err": max_abs_diff([(nm_k, nm_r)])}

    pay_k = sw_forward(q, t, lo, tl, band, emit_payload=True)
    pay_r = sw_forward_reference(q, t, lo, tl, band, emit_payload=True)
    torch.cuda.synchronize()
    res["sw_forward_payload"] = {"max_abs_err": max_abs_diff(zip(pay_k, pay_r))}

    payload, score, ri, bj = pay_k
    walk_k = walk_rle(payload, lo, score, ri, bj, band, ops_max)
    walk_r = walk_rle_reference(payload, lo, score, ri, bj, band, ops_max)
    torch.cuda.synchronize()
    res["sw_walk"] = {"max_abs_err": max_abs_diff(zip(walk_k, walk_r))}
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} differs from its plain version at band {band}: {r}")

    # kernel 2 is timed as its launch alone: the public wrapper's validation
    # reads the start cells back and waits for the device
    walk_args = (payload, lo, score, ri, bj, band, ops_max)
    per = {
        "sw_forward_nm": (lambda: sw_forward(q, t, lo, tl, band),
                          lambda: sw_forward_reference(q, t, lo, tl, band)),
        "sw_forward_payload": (
            lambda: sw_forward(q, t, lo, tl, band, emit_payload=True),
            lambda: sw_forward_reference(q, t, lo, tl, band, emit_payload=True)),
        "sw_walk": (lambda: walk_rle_launch(*walk_args), lambda: walk_rle_reference(*walk_args)),
    }
    for name, (kern, plain) in per.items():
        # plain, kernel, kernel, plain: the two orders of one pair (the
        # comparison above was the plain version's warm-up); kernel 2, a
        # tenth of kernel 1's time, as the mean of QUEUED_RUNS launches
        # queued back to back
        p1 = cuda_ms(plain, 1, warm_up=False) if time_plain else None
        if name == "sw_walk" or queued:
            k1, k2 = (launch_ms(kern, reps=2, runs=QUEUED_RUNS) for _ in range(2))
        else:
            k1, k2 = cuda_ms(kern, 5), cuda_ms(kern, 5)
        p2 = cuda_ms(plain, 1, warm_up=False) if time_plain and not queued else p1
        res[name].update(ms=min(k1, k2))
        if queued and name != "sw_walk":
            res[name].update(single_ms=launch_ms(kern))
        line = f"  {name}: kernel {min(k1, k2):.3f} ms ({1e3 * min(k1, k2) / B:.3f} us/pair)"
        if time_plain:
            res[name].update(plain_ms=min(p1, p2))
            line += f", plain {min(p1, p2):.1f} ms ({1e3 * min(p1, p2) / B:.1f} us/pair)"
        log(f"{line}, {B} pairs, Lq {Lq}, band {band}")
    # beside kernel 2's queued time: one launch between its events (which
    # holds the wrapper's host time), the public wrapper with its validation,
    # and the stage-4 route's mix (a seeded third of the rows walk; the others
    # have score 0), its output compared as well
    walks = torch.from_numpy(np.random.default_rng(EDGE_SEED).random(B) < 1 / 3).to(score.device)
    mix_args = (payload, lo, torch.where(walks, score, 0), *walk_args[3:])
    res["sw_walk"].update(
        single_ms=launch_ms(per["sw_walk"][0]),
        checked_ms=launch_ms(lambda: walk_rle(*walk_args)),
        mix_ms=launch_ms(lambda: walk_rle_launch(*mix_args), runs=QUEUED_RUNS))
    err = max_abs_diff(zip(walk_rle_launch(*mix_args), walk_rle_reference(*mix_args)))
    if err:
        raise AssertionError(f"sw_walk on the stage-4 mix differs from its plain version at "
                             f"band {band} by {err}")
    w = res["sw_walk"]
    log(f"  sw_walk, launch alone: {w['ms']:.4f} ms queued ({QUEUED_RUNS} launches), "
        f"{w['single_ms']:.4f} ms single, {w['checked_ms']:.4f} ms through walk_rle with its "
        f"validation; stage-4 mix ({B - int(walks.sum())} of {B} rows at score 0) "
        f"{w['mix_ms']:.4f} ms queued")
    # what the bounds need: the shapes, the walked path lengths (the op
    # counts of the CIGAR runs kernel 2 wrote) and the rows under the start
    # cells, which are the rows kernel 2 streams
    steps = (walk_k[0].cpu().numpy().view(np.uint32) >> 4).sum(axis=1)
    res["shape"] = {"B": B, "Lq": Lq, "Lt": Lt, "band": band, "walk_steps": int(steps.sum()),
                    "walk_max_steps": int(steps.max()),
                    "walk_rows": int(ri[score > 0].sum())}

    # the port's job routes (kernel 1 + kernel 2 on the card) against the
    # port's host oracle (native/swalign.cpp)
    host_nm = run_jobs_nm_host(jobs, band)
    host_tb = run_jobs_host(jobs, band)
    port_nm = sw_forward_jobs(jobs, band, "cuda")
    port_tb = sw_traceback_jobs(jobs, band, device="cuda")
    for i, (h, p) in enumerate(zip(host_nm, port_nm)):
        hk = None if h is None else (h[0], h[2], h[4], h[6])
        pk = None if p is None else (p[0], p[2], p[4], p[6])
        if hk != pk:
            raise AssertionError(f"NM route job {i}: host {hk} port {pk}")
    for i, (h, p) in enumerate(zip(host_tb, port_tb)):
        same = (h is None and p is None) or (
            h is not None and p is not None and h[:5] == p[:5] and h[6] == p[6]
            and np.array_equal(np.asarray(h[5], np.uint32), np.asarray(p[5], np.uint32))
        )
        if not same:
            raise AssertionError(f"traceback route job {i}: host {h} port {p}")
    n_aligned = sum(h is not None for h in host_tb)
    log(f"  band {band}: {len(jobs)} pairs ({n_aligned} aligned), "
        f"{sum(max_jump(j) > 2 for j in jobs)} with band jumps > 2, "
        f"{sum(max_jump(j) == 2 for j in jobs)} with max advance 2: kernels == plain, "
        f"routes == host oracle (exact)")
    return res


def walk_warp_bytes(band: int, ops_max: int, maxrun: int = MAXRUN) -> int:
    """Kernel 2's shared memory for one pair's warp (sw_walk.cu make_layout):
    WALK_STAGES payload windows of up to WALK_MAX_ROWS rows and
    WALK_WINDOW_BYTES bytes, each with its lo words, ops_max op bytes and
    maxrun run words, every part rounded up to 16 bytes."""
    rows = min(max(WALK_WINDOW_BYTES // band, 1), WALK_MAX_ROWS)
    win_bytes = ((rows * band + 15) & ~15) + 16
    lo_words = (rows + 1 + 3) & ~3
    return (WALK_STAGES * (win_bytes + 4 * lo_words) + ((ops_max + 15) & ~15)
            + ((4 * maxrun + 15) & ~15))


def walk_warps_per_block(warp_bytes: int) -> int:
    """Kernel 2's pairs a block: WALK_WARPS, halved while the block's
    shared memory exceeds WALK_MAX_SHARED (sw_walk_launch)."""
    warps = WALK_WARPS
    while warps > 1 and warps * warp_bytes > WALK_MAX_SHARED:
        warps //= 2
    return warps


def sw_bounds(shape: dict, int32_ops_per_s: float) -> dict:
    """Least time for kernels 1 and 2 at these shapes: the larger of the
    integer operations over the measured int32 rate and the bytes (each
    input read once, each output written once) over the card's memory
    rate.  Kernel 2's bound is its bytes: one payload byte and one lo word
    per walked step, the start cells, and the CIGAR rows and meta it writes.
    Beside the bound, and not part of it, two times that say what the
    warp-per-pair design can reach: `whole_rows_ms`, the bytes it streams
    (every payload row under a start cell, whole, and its lo word) over the
    memory rate, and `chain_floor_ms`, the longest walk's steps, each waiting
    for one shared-memory load (LDS_ROUND_TRIP_CYCLES at SM_CLOCK_HZ), which
    no number of warps shortens."""
    B, Lq, Lt, band = shape["B"], shape["Lq"], shape["Lt"], shape["band"]
    cells = B * Lq * band
    inputs = 4 * (B * Lq + B * Lt + B * (Lq + 1) + B)
    out = {}
    for name, out_bytes in (("sw_forward_nm", 16 * B), ("sw_forward_payload", cells + 12 * B)):
        t_ops = cells * OPS_PER_CELL[name] / int32_ops_per_s * 1e3
        t_bytes = (inputs + out_bytes) / HBM_BYTES_PER_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "cells": cells}
    walk_bytes = shape["walk_steps"] * 5 + 12 * B + 4 * B * MAXRUN + 24 * B
    out["sw_walk"] = {
        "bound_ms": walk_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "whole_rows_ms": shape["walk_rows"] * (band + 4) / HBM_BYTES_PER_S * 1e3,
        "chain_floor_ms": shape["walk_max_steps"] * LDS_ROUND_TRIP_CYCLES / SM_CLOCK_HZ * 1e3}
    return out


def write_reads(path: Path, tpl_path: Path, rng, n_reads: int = N_READS,
                template_len: int = TEMPLATE_LEN) -> None:
    """n_reads ONT-like reads from 10 templates of template_len bases (5
    random, 5 variants with 4-6 SNPs): 1.5% substitutions each, 30% with a
    1-2 bp deletion, 10% with a 2-6 bp deletion, 2% with a 50 bp deletion,
    half reverse-complemented."""
    import numpy as np

    from savont_tpu_torch.ops.encode import revcomp_bytes

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    templates = []
    for _ in range(5):
        templates.append(rng.choice(bases, template_len).tobytes())
    for base in list(templates):
        v = np.frombuffer(base, dtype=np.uint8).copy()
        pos = rng.choice(np.arange(60, template_len - 60), int(rng.integers(4, 7)), replace=False)
        v[pos] = bases[(np.searchsorted(bases, v[pos]) + rng.integers(1, 4, len(pos))) % 4]
        templates.append(v.tobytes())
    with open(tpl_path, "w") as f:
        for i, t in enumerate(templates):
            f.write(f">template{i}\n{t.decode()}\n")
    with gzip.open(path, "wt") as out:
        for i in range(n_reads):
            ti = i % len(templates)
            b = np.frombuffer(templates[ti], dtype=np.uint8).copy()
            nsub = rng.binomial(len(b), 0.015)
            pos = rng.choice(len(b), nsub, replace=False)
            b[pos] = bases[(np.searchsorted(bases, b[pos]) + rng.integers(1, 4, nsub)) % 4]
            s = b.tobytes()
            for frac, lo_len, hi_len in ((0.30, 1, 2), (0.10, 2, 6), (0.02, 50, 50)):
                if rng.random() < frac:
                    p = int(rng.integers(100, len(s) - 160))
                    s = s[:p] + s[p + int(rng.integers(lo_len, hi_len + 1)):]
            if rng.random() < 0.5:
                s = revcomp_bytes(s)
            out.write(f"@t{ti}_r{i}\n{s.decode()}\n+\n{'I' * len(s)}\n")


def main_path_rng():
    """The generator in the state write_reads starts from: after the draws
    of phase 3's two job sets."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    make_pairs(rng, 48, 48)
    make_pairs(rng, 8, 32)
    return rng


def operon_sample(fq: Path, tpl: Path) -> None:
    """The operon phase's sample: N_READS_OPERON reads of write_reads' error
    model from 10 templates of OPERON_TEMPLATE_LEN bases, from its own
    generator (no earlier sample draws from it)."""
    import numpy as np

    write_reads(fq, tpl, np.random.default_rng(OPERON_SEED), N_READS_OPERON, OPERON_TEMPLATE_LEN)


def scale_sample(fq: Path, tpl: Path, n_reads: int = N_READS_SCALE,
                 n_templates: int = N_TEMPLATES_SCALE) -> None:
    """The scale phase's sample: n_reads reads of write_reads' error model
    (1.5% substitutions; 30% / 10% / 2% of reads with a 1-2 / 2-6 / 50 bp
    deletion, applied in that order; half reverse-complemented) from
    n_templates templates of TEMPLATE_LEN bases, half random and half a
    variant of one of them with 4-6 SNPs at least 60 bases from either end,
    in even abundance (read i from template i % n_templates).  Drawn from
    its own generator in batches of SCALE_BATCH reads, a read's
    substitutions as one draw a base, so 100,000 reads take seconds."""
    import numpy as np

    rng = np.random.default_rng(SCALE_SEED)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_random = n_templates // 2
    tpls = rng.choice(bases, (n_random, TEMPLATE_LEN))
    variants = tpls.copy()
    for v in variants:
        pos = rng.choice(np.arange(60, TEMPLATE_LEN - 60), int(rng.integers(4, 7)), replace=False)
        v[pos] = bases[(np.searchsorted(bases, v[pos]) + rng.integers(1, 4, len(pos))) % 4]
    tpls = np.concatenate([tpls, variants])
    with open(tpl, "w") as f:
        for i, t in enumerate(tpls):
            f.write(f">template{i}\n{t.tobytes().decode()}\n")
    # base codes 0-3, so that a substitution is an add of 1-3 mod 4
    codes = np.searchsorted(bases, tpls).astype(np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with gzip.open(fq, "wb", compresslevel=1) as out:
        for b0 in range(0, n_reads, SCALE_BATCH):
            n = min(SCALE_BATCH, n_reads - b0)
            ti = np.arange(b0, b0 + n) % n_templates
            shift = rng.integers(1, 4, (n, TEMPLATE_LEN), dtype=np.uint8)
            shift[rng.random((n, TEMPLATE_LEN)) >= 0.015] = 0
            seqs = bases[(codes[ti] + shift) % 4]
            # per deletion kind: whether a read has it, its length and its
            # place as a fraction of the room [100, len - 160) left then
            dels = [(rng.random(n) < frac, rng.integers(lo_len, hi_len + 1, n), rng.random(n))
                    for frac, lo_len, hi_len in ((0.30, 1, 2), (0.10, 2, 6), (0.02, 50, 50))]
            rc = rng.random(n) < 0.5
            chunk = []
            for r in range(n):
                s = seqs[r].tobytes()
                for has, length, at in dels:
                    if has[r]:
                        p = 100 + int(at[r] * (len(s) - 260))
                        s = s[:p] + s[p + int(length[r]):]
                if rc[r]:
                    s = s.translate(comp)[::-1]
                chunk.append(b"@t%d_r%d\n%s\n+\n%s\n" % (ti[r], b0 + r, s, b"I" * len(s)))
            out.write(b"".join(chunk))


def output_digests(out_dir: Path) -> dict[str, str]:
    return {rel: hashlib.sha256((out_dir / rel).read_bytes()).hexdigest() for rel in DIGESTS}


def small_sample_rng():
    """The generator in the state the small sample starts from: after
    the main sample's draws."""
    rng = main_path_rng()
    with tempfile.TemporaryDirectory() as d:
        write_reads(Path(d) / "reads.fq.gz", Path(d) / "templates.fa", rng)
    return rng


ROUTES = {"stage4": "mesh_stage4_pileups", "stage7": "stage7_nm_values"}


def cli_asv(out_dir: Path, fq: Path, *args: str) -> dict:
    """One `asv` through the CLI on the card into out_dir, with every count
    set to 0 just before it; what it counted, read just after: launches and
    plain-version calls of kernels 1, 2 and 4, the launches of kernels 1 and
    2 made inside each device route of parallel/mesh (ROUTES; the stage-4
    votes and stages 5-6 launch beside them), the device routes' stats, the
    per-job routes' seconds (the stages' "dp" parts) and the stage seconds."""
    from savont_tpu_torch import cli
    from savont_tpu_torch.ops import align_torch
    from savont_tpu_torch.ops import kmers_torch as kt
    from savont_tpu_torch.parallel import mesh as port_mesh
    from savont_tpu_torch.parallel.mesh import ROUTE_STATS, reset_route_stats
    from savont_tpu_torch.pipeline import stage1_kmers as s1
    from savont_tpu_torch.pipeline.asv import STAGE_SECONDS

    inside = {stage: dict.fromkeys(align_torch.LAUNCHES, 0) for stage in ROUTES}

    def counted(stage, route):
        def run(*a, **k):
            before = dict(align_torch.LAUNCHES)
            try:
                return route(*a, **k)
            finally:
                for key, n in align_torch.LAUNCHES.items():
                    inside[stage][key] += n - before[key]
        return run

    align_torch.reset_counters()
    kt.reset_counters()
    reset_route_stats()
    s1.reset_count_stats()
    routes = {stage: getattr(port_mesh, name) for stage, name in ROUTES.items()}
    for stage, name in ROUTES.items():
        setattr(port_mesh, name, counted(stage, routes[stage]))
    try:
        t0 = time.perf_counter()
        rc = cli.main(["--log-level", "warn", "asv", str(fq), "-o", str(out_dir),
                       "--device", "cuda", "-t", "4", *args])
        wall = time.perf_counter() - t0
    finally:
        for stage, name in ROUTES.items():
            setattr(port_mesh, name, routes[stage])
    if rc != 0:
        raise AssertionError(f"savont_tpu_torch asv {' '.join(args)} exited {rc}")
    return {"wall_s": wall, "launches": {**align_torch.LAUNCHES, **kt.LAUNCHES},
            "route_launches": inside,
            "plain_calls": {**align_torch.REFERENCE_CALLS, **kt.REFERENCE_CALLS},
            "routes": {k: dict(v) for k, v in ROUTE_STATS.items()},
            "per_job_route_s": {k: v for k, v in STAGE_SECONDS.items() if k.endswith(".dp")},
            "stage_s": {k: round(v, 3) for k, v in STAGE_SECONDS.items()},
            "stage1_count": {k: v for k, v in s1.COUNT_STATS.items() if v}}


SW_KERNELS = ("sw_forward_nm", "sw_forward_payload", "sw_walk")


def held(out_dir: Path, tpl: Path, digests: dict, r: dict, kernels=SW_KERNELS) -> int:
    """cli_asv's run r into out_dir held to its pinned digests, to NM=0 of
    every ASV against the templates, to a launch of each of `kernels` and
    to no call of a plain version.  Returns the number of ASVs."""
    from savont_tpu_torch.validate import validate_asvs

    tag = out_dir.name
    got = output_digests(out_dir)
    if got != digests:
        raise AssertionError(f"{tag}: outputs differ from the pinned digests of the host run: {got}")
    val = validate_asvs(str(out_dir / "final_asvs.fasta"), str(tpl))
    if not val or any(v.nm != 0 for v in val):
        raise AssertionError(f"{tag}: ASVs not all NM=0 against the templates: {val}")
    for k in kernels:
        if r["launches"][k] <= 0:
            raise AssertionError(f"{tag}: kernel {k} was not launched: {r['launches']}")
    if any(r["plain_calls"].values()):
        raise AssertionError(f"{tag}: plain versions ran during the card run: {r['plain_calls']}")
    return len(val)


def main_path(work: Path, rng) -> dict:
    def run(fq: Path, tag: str, *routes: str) -> dict:
        return cli_asv(work / tag, fq, *routes)

    # the default routes: the device routes of stages 4 and 7, at full width
    fq, tpl = work / "reads.fq.gz", work / "templates.fa"
    write_reads(fq, tpl, rng)
    warm = run(fq, "warmup")  # first run in the process: untimed
    mesh = run(fq, "mesh")
    n_asvs = held(work / "mesh", tpl, DIGESTS, mesh)
    s4, s7 = mesh["routes"]["stage4"], mesh["routes"]["stage7"]
    # stage 4 piles up at most 250 reads per consensus, stage 7 aligns every
    # read to its candidate ASVs
    if s4["calls"] < 1 or s7["calls"] < 1 or s4["jobs"] < N_READS // 2 or s7["jobs"] < N_READS // 2:
        raise AssertionError(f"the device routes did not carry the sample: {mesh['routes']}")
    check_asv_routes("mesh", mesh, N_READS)
    log(f"main path (device routes): {N_READS} reads, {n_asvs} ASVs all NM=0, outputs equal the "
        f"host run's pinned digests; savont_tpu_torch asv --device cuda {mesh['wall_s']:.2f} s warm "
        f"(first run {warm['wall_s']:.2f} s; wall, kernel build excluded); launches "
        f"{mesh['launches']}; plain calls {mesh['plain_calls']}")
    log(f"  stage seconds {mesh['stage_s']}; device routes ({1e3 * s4['seconds']:.1f} ms in "
        f"stage 4, {1e3 * s7['seconds']:.1f} ms in stage 7) {json.dumps(mesh['routes'])}; "
        f"per-job routes {mesh['per_job_route_s']}; {s4['overflow']} pairs overflowed "
        f"kernel 2 and were counted on the host")

    # a smaller sample through the per-job consumers, the routes' fallback
    # for inputs the flat planner declines (made to decline every input
    # here), held to its own digests (its directory's name is pinned in
    # DIGESTS_CLASSIFICATION through export)
    from savont_tpu_torch.parallel import mesh as port_mesh

    fq_s, tpl_s = work / "small" / "reads.fq.gz", work / "small" / "templates.fa"
    fq_s.parent.mkdir()
    write_reads(fq_s, tpl_s, rng, N_READS_SMALL)
    planner = port_mesh._plan_soa_indexed
    port_mesh._plan_soa_indexed = lambda *a, **k: None
    try:
        small = run(fq_s, "host")
    finally:
        port_mesh._plan_soa_indexed = planner
    n_small = held(work / "host", tpl_s, DIGESTS_SMALL, small)
    inside = small["route_launches"]
    if not (all(v["fallbacks"] == v["calls"] >= 1 for v in small["routes"].values())
            and inside["stage4"]["sw_forward_payload"] > 0 and inside["stage4"]["sw_walk"] > 0
            and inside["stage7"]["sw_forward_nm"] > 0):
        raise AssertionError(f"the per-job consumers did not carry every call: {small['routes']}, "
                             f"launches inside the routes {inside}")
    log(f"small sample (per-job consumers, the flat planner declining): {N_READS_SMALL} reads, "
        f"{n_small} ASVs all NM=0, outputs equal their pinned digests; {small['wall_s']:.2f} s; "
        f"launches {small['launches']}; routes {json.dumps(small['routes'])}")
    log(f"  stage seconds {small['stage_s']}; per-job routes {small['per_job_route_s']}")
    return {"launches": mesh["launches"], "port_s": mesh["wall_s"], "n_asvs": n_asvs,
            "routes": mesh["routes"]}


def write_hard_asvs(db_fasta: Path, out_dir: Path, seed: int = HARD_SEED) -> None:
    """N_HARD ASVs cut from seed-drawn references of the database: 0-30
    bases cut from either end, 0-6% substitutions, 0-12 foreign bases added
    at either end, every second one reverse-complemented; and a
    feature-table.tsv of two samples (so that classify's pooled writers
    run)."""
    import numpy as np

    from savont_tpu_torch.ops.encode import revcomp_bytes

    refs = [line.strip().encode() for line in open(db_fasta) if not line.startswith(">")]
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "final_asvs.fasta", "w") as fa, open(out_dir / "feature-table.tsv", "w") as ft:
        ft.write("#OTU ID\tsampleA\tsampleB\n")
        for i, r in enumerate(rng.choice(len(refs), N_HARD, replace=False)):
            ref = refs[int(r)]
            b = np.frombuffer(ref[int(rng.integers(0, 31)) : len(ref) - int(rng.integers(0, 31))],
                              dtype=np.uint8).copy()
            nsub = int(round(rng.uniform(0, 0.06) * len(b)))
            pos = rng.choice(len(b), nsub, replace=False)
            b[pos] = bases[(np.searchsorted(bases, b[pos]) + rng.integers(1, 4, nsub)) % 4]
            s = (rng.choice(bases, int(rng.integers(0, 13))).tobytes() + b.tobytes()
                 + rng.choice(bases, int(rng.integers(0, 13))).tobytes())
            if i % 2:
                s = revcomp_bytes(s)
            d = [int(x) for x in rng.integers(1, 200, 2)]
            name = f"final_consensus_{i}_depth_{sum(d)}"
            fa.write(f">{name}\n{s.decode()}\n")
            ft.write(f"{name}\t{d[0]}\t{d[1]}\n")


def classification_digests(work: Path) -> dict[str, str]:
    return {rel: hashlib.sha256((work / rel).read_bytes()).hexdigest()
            for rel in DIGESTS_CLASSIFICATION}


def sintax_bound(P: int, R: int, kmers: int, distinct: int, entries: int) -> dict:
    """Least time for kernel 3's function on a chunk of R rows holding
    `kmers` real k-mers in all (the padding of a layout is no part of it),
    against P pairs whose slots hold `distinct` distinct k-mers: the larger
    of its bytes (the k-mers, queries and ordinals read once, the keys
    written once) over the memory rate, and its shared-memory operations,
    one lookup per reference k-mer (an exact hash of the query k-mers
    answers in one probe) and one count increment per hit-list entry
    (`entries`, the sum over pairs and rows of the scores), over SMS x
    LDS_PER_CLOCK a clock at SM_CLOCK_HZ.  `design_loads` is what the
    kernel's own design makes, each k-mer binary-searched among the
    distinct query k-mers (kmers x ceil(log2 distinct)) plus the
    increments; it is not part of the bound."""
    import math

    ops = kmers + entries
    t_ops = ops / (SMS * LDS_PER_CLOCK * SM_CLOCK_HZ) * 1e3
    t_bytes = 4 * (kmers + P * 32 + R + P) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "design_loads": kmers * math.ceil(math.log2(max(distinct, 2))) + entries}


def sintax_work(index, kmers) -> tuple[int, int]:
    """The reference k-mers found among the query keys, and the hit-list
    entries they walk (the sum of the scores over pairs and rows)."""
    import torch

    if not index.keys.numel():
        return 0, 0
    pos = torch.searchsorted(index.keys, kmers).clamp(max=index.keys.numel() - 1)
    k = pos[index.keys[pos] == kmers]
    return int(k.numel()), int((index.off[k + 1] - index.off[k]).sum())


def check_sintax_edges() -> int:
    """Kernel 3 against its plain version on the card, exact, over
    sintax_edge_cases, each launched `chunk` rows at a time into one
    accumulator: the public entry (JAX layout, through the lower one) and
    the lower entry on the rows with their padding stripped and kept
    (kernel 6's layout), against the lower entry's plain version and the
    dense composition.  Returns the case count."""
    import torch

    from savont_tpu_torch.ops.sintax_torch import (
        QUERY_SENTINEL, index_on, keys_int64, kernel_kmers, query_index, sintax_scores,
        sintax_scores_dense, sintax_scores_rows_launch, sintax_scores_rows_reference, unpadded_rows,
    )

    cases = sintax_edge_cases()
    for case in cases:
        q_np = kernel_kmers(case["queries"])
        q = torch.from_numpy(q_np).cuda()
        index = index_on(*query_index(q_np, QUERY_SENTINEL), q.shape[0], "cuda")
        refk = torch.from_numpy(kernel_kmers(case["refk"])).cuda()
        ridx = torch.from_numpy(case["ridx"].astype("int32")).cuda()
        accs = {k: torch.zeros(q.shape[0], dtype=torch.int32, device="cuda")
                for k in ("public", "rows", "padded", "plain", "dense")}
        for r0 in range(0, refk.shape[0], case["chunk"]):
            part = (refk[r0 : r0 + case["chunk"]].contiguous(), ridx[r0 : r0 + case["chunk"]].contiguous())
            rows = (*unpadded_rows(part[0]), part[1])
            sintax_scores(q, *part, accs["public"])
            sintax_scores_rows_launch(index, *rows, accs["rows"])
            # kernel 6's layout: the sorted rows with their padding, each pad a miss
            sintax_scores_rows_launch(index, part[0].reshape(-1), torch.arange(
                part[0].shape[0] + 1, device="cuda") * part[0].shape[1], part[1], accs["padded"])
            sintax_scores_rows_reference(index, *rows, accs["plain"])
            sintax_scores_dense(q, *part, accs["dense"])
        torch.cuda.synchronize()
        want = keys_int64(accs["plain"])
        err = {k: max_abs_diff([(keys_int64(v), want)]) for k, v in accs.items()}
        if any(err.values()):
            raise AssertionError(f"sintax edge case {case['name']}: kernel 3 differs from its "
                                 f"plain version: {err}")
        D = index.keys.numel()
        if case["name"] == "many_keys" and D <= SINTAX_SMEM_KEYS:
            raise AssertionError(f"many_keys: {D} keys fit kernel 3's shared memory")
        log(f"  edge {case['name']}: {q.shape[0]} pairs ({D} distinct k-mers) x {refk.shape[0]} "
            f"rows of {refk.shape[1]}, chunks of {case['chunk']}, max score {int((want >> 26).max())}, "
            f"{int((want == 0).sum())} pairs at 0: kernel 3 (public, rows, padded rows) == plain "
            f"== dense (exact)")
    return len(cases)


def sintax_cell(asv_dir: Path, db_fasta: Path) -> dict:
    """Kernel 3 at a cell's shape: the query matrix of asv_dir's ASVs (x 100
    iterations) against the first CHUNK_ROWS references of the database, one
    launch as the sintax route makes it (the run's query index, ragged
    rows); against its plain version and the dense composition (exact),
    timed (queued and single) in the order library, plain, kernel, kernel,
    plain, library.  The library time is the dense composition's, one-shot
    PyTorch calls (torch.searchsorted, gather, sum, amax) on the rows padded
    to the longest."""
    import numpy as np
    import torch

    from savont_tpu_torch.io.fastx import read_fastx
    from savont_tpu_torch.ops.sintax_torch import (
        ROW_PAD, index_on, keys_int64, kernel_kmers, query_index, ragged_rows, sintax_scores_dense,
        sintax_scores_rows, sintax_scores_rows_launch, sintax_scores_rows_reference,
    )
    from savont_tpu_torch.pipeline import sintax as route
    from savont_tpu_torch.probes.roofline import QUEUED_RUNS, launch_ms

    asvs = [r.seq.upper() for r in read_fastx(str(asv_dir / "final_asvs.fasta"))]
    subs = route.query_matrix(asvs, 100)
    P = len(subs)
    index = index_on(*query_index(subs, route.QUERY_SENTINEL), P, "cuda")
    q = torch.from_numpy(kernel_kmers(subs)).cuda()
    rows = []
    for rec in read_fastx(str(db_fasta)):
        rows.append(np.unique(route.extract_kmers(rec.seq.upper())))
        if len(rows) == route.CHUNK_ROWS:
            break
    kmers_np, row_off_np = ragged_rows(rows)
    kmers, row_off = torch.from_numpy(kmers_np).cuda(), torch.from_numpy(row_off_np).cuda()
    R, L = len(rows), max(len(a) for a in rows)
    refk_np = np.full((R, L), ROW_PAD, dtype=np.int32)
    for i, a in enumerate(rows):
        refk_np[i, : len(a)] = a
    refk = torch.from_numpy(refk_np).cuda()
    ridx = torch.arange(R, dtype=torch.int32, device="cuda")

    def fresh():
        return torch.zeros(P, dtype=torch.int32, device="cuda")

    got = sintax_scores_rows(index, kmers, row_off, ridx, fresh())
    want = sintax_scores_rows_reference(index, kmers, row_off, ridx, fresh())
    dense = sintax_scores_dense(q, refk, ridx, fresh())
    torch.cuda.synchronize()
    err = max_abs_diff([(keys_int64(got), keys_int64(want)), (keys_int64(dense), keys_int64(want))])
    if err:
        raise AssertionError(f"kernel 3 differs from its plain version at {asv_dir.name}'s shape by {err}")
    acc = fresh()
    l1 = launch_ms(lambda: sintax_scores_dense(q, refk, ridx, acc), reps=1)
    p1 = launch_ms(lambda: sintax_scores_rows_reference(index, kmers, row_off, ridx, acc), reps=1)
    k1 = launch_ms(lambda: sintax_scores_rows_launch(index, kmers, row_off, ridx, acc), runs=QUEUED_RUNS)
    k2 = launch_ms(lambda: sintax_scores_rows_launch(index, kmers, row_off, ridx, acc), runs=QUEUED_RUNS)
    p2 = launch_ms(lambda: sintax_scores_rows_reference(index, kmers, row_off, ridx, acc), reps=1)
    single = launch_ms(lambda: sintax_scores_rows_launch(index, kmers, row_off, ridx, acc))
    l2 = launch_ms(lambda: sintax_scores_dense(q, refk, ridx, acc), reps=1)
    hits, entries = sintax_work(index, kmers)
    D = index.keys.numel()
    b = sintax_bound(P, R, kmers.numel(), D, entries)
    out = {"max_abs_err": err, "ms": min(k1, k2), "single_ms": single, "plain_ms": min(p1, p2),
           "library_ms": min(l1, l2), "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "shape": {"P": P, "R": R, "kmers": kmers.numel(), "L_max": L, "D": D, "hits": hits,
                     "entries": entries, "ops": b["ops"], "design_loads": b["design_loads"],
                     "upload_bytes": kmers_np.nbytes + row_off_np.nbytes + 4 * R}}
    log(f"  sintax_scores at {asv_dir.name}'s shape ({P} pairs, {D} distinct query k-mers; {R} "
        f"rows, {kmers.numel()} k-mers, {hits} found, {entries} hit-list entries walked): kernel "
        f"{out['ms']:.4f} ms queued ({QUEUED_RUNS} launches; {k1:.4f}, {k2:.4f}), {single:.4f} ms "
        f"single, {100 * b['bound_ms'] / out['ms']:.1f}% of bound; plain {out['plain_ms']:.2f} ms "
        f"({p1:.2f}, {p2:.2f}); dense composition {out['library_ms']:.2f} ms ({l1:.2f}, {l2:.2f}); "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: the k-mers, queries and ordinals read "
        f"and the keys written at {HBM_BYTES_PER_S / 1e12} TB/s, or {b['ops']} shared-memory "
        f"operations, a lookup a k-mer and an increment an entry, over {SMS} SMs x "
        f"{LDS_PER_CLOCK} a clock at {SM_CLOCK_HZ / 1e9} GHz; the design's binary searches make "
        f"{b['design_loads']}); exact; {nvidia_smi_line()}")
    return out


def classify_nm_cell(work: Path, asv_dir: Path, int32_ops_per_s: float) -> dict:
    """Kernel 1 (NM mode) at a classify cell's shapes: the ASVs of asv_dir
    against phase 6's database, their candidate pairs planned and launched
    by the classify route's own functions (candidate_pairs,
    classify_nm_slabs, classify_nm_launches) at its band.  Each launch is
    held against the plain version on the same card tensors (exact); the
    launches are timed as the best of two 5-launch means beside the plain
    version (plain, kernel, kernel, plain), with the bound (cells x
    OPS_PER_CELL over the measured int32 rate, or the bytes)."""
    import torch

    from savont_tpu_torch.db.registry import load_database
    from savont_tpu_torch.io.fastx import read_fastx
    from savont_tpu_torch.ops.align_batch import classify_nm_launches, classify_nm_slabs
    from savont_tpu_torch.ops.align_torch import sw_forward, sw_forward_reference
    from savont_tpu_torch.pipeline.classify import (
        CLASSIFY_BAND, _load_or_build_table, candidate_pairs,
    )

    db = load_database(work / "db" / "emu")
    refs = [r.seq.upper() for r in read_fastx(str(db.fasta_path))]
    table = _load_or_build_table(db.fasta_path, refs)
    asvs = [r.seq.upper() for r in read_fastx(str(asv_dir / "final_asvs.fasta"))]
    _cands, _dropped, qi, uref, ti = candidate_pairs(table, asvs)
    slabs = list(classify_nm_slabs(asvs, [refs[c] for c in uref.tolist()], qi, ti,
                                   CLASSIFY_BAND, torch.device("cuda")))
    launches = [tensors for _s, plan, dp in slabs
                for _sel, tensors in classify_nm_launches(plan, dp, CLASSIFY_BAND, "cuda")]
    err = max_abs_diff([(sw_forward(*t, CLASSIFY_BAND), sw_forward_reference(*t, CLASSIFY_BAND))
                        for t in launches])
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"kernel 1 (NM) differs from its plain version at the classify "
                             f"cell of {asv_dir.name} by {err}")

    def run():
        for tensors in launches:
            sw_forward(*tensors, CLASSIFY_BAND)

    def plain():
        for tensors in launches:
            sw_forward_reference(*tensors, CLASSIFY_BAND)

    p1 = cuda_ms(plain, 1, warm_up=False)
    ms = min(cuda_ms(run, 5), cuda_ms(run, 5))
    p2 = cuda_ms(plain, 1, warm_up=False)
    jobs = sum(len(plan[0]) for _s, plan, _dp in slabs)
    cells = sum(int(t[0].shape[0]) * int(t[0].shape[1]) * CLASSIFY_BAND for t in launches)
    t_ops = cells * OPS_PER_CELL["sw_forward_nm"] / int32_ops_per_s * 1e3
    in_bytes = sum(4 * (t[0].numel() + t[1].numel() + t[2].numel() + t[3].numel()) for t in launches)
    t_bytes = (in_bytes + 16 * jobs) / HBM_BYTES_PER_S * 1e3
    out = {"pairs": len(qi), "jobs": jobs, "launches": len(launches),
           "Lq": max(int(t[0].shape[1]) for t in launches), "band": CLASSIFY_BAND, "cells": cells,
           "max_abs_err": err, "ms": ms, "plain_ms": min(p1, p2), "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"kernel 1 (NM) at the classify cell of {asv_dir.name}: {out['pairs']} candidate pairs, "
        f"{jobs} jobs in {out['launches']} launch(es), Lq {out['Lq']}, band {CLASSIFY_BAND}, "
        f"{cells} cells: == plain (exact); {ms:.3f} ms (best of two 5-launch means), plain "
        f"{out['plain_ms']:.1f} ms ({p1:.1f}, {p2:.1f}), bound {out['bound_ms']:.3f} ms "
        f"({out['bound_by']}), {100 * out['bound_ms'] / ms:.1f}% of bound; {nvidia_smi_line()}")
    return out


def cli_counted(tag: str, *argv: str) -> dict:
    """One CLI run on the card with the counts of the classification routes
    set to 0 just before it; what it counted, read just after (kernel
    launches, the classify route's CLASSIFY_STATS, sintax's SCORE_STATS),
    and no plain version called."""
    from savont_tpu_torch import cli
    from savont_tpu_torch.ops import align_batch, align_torch, sintax_torch
    from savont_tpu_torch.pipeline import sintax as sintax_mod

    align_torch.reset_counters()
    sintax_torch.reset_counters()
    for d in (align_batch.CLASSIFY_STATS, sintax_mod.SCORE_STATS):
        for k in d:
            d[k] = type(d[k])()
    t0 = time.perf_counter()
    rc = cli.main(["--log-level", "warn", *argv])
    r = {"wall_s": time.perf_counter() - t0, "launches": dict(align_torch.LAUNCHES),
         "sintax_launches": dict(sintax_torch.LAUNCHES),
         "classify": dict(align_batch.CLASSIFY_STATS), "sintax": dict(sintax_mod.SCORE_STATS)}
    plain = {**align_torch.REFERENCE_CALLS, **sintax_torch.REFERENCE_CALLS}
    if rc != 0 or any(plain.values()):
        raise AssertionError(f"{tag}: exit {rc}, plain versions called {plain}")
    return r


def cli_classify(tag: str, out_dir: Path, db_dir: Path) -> dict:
    """`classify` of out_dir's ASVs against db_dir on the card (cli_counted):
    kernel 1 (NM) over the candidate jobs, kernels 1 (payload) + 2 over
    the written hits only, with the route's seconds by part."""
    from savont_tpu_torch.pipeline.classify import CLASSIFY_SECONDS

    r = cli_counted(tag, "classify", "-i", str(out_dir), "-d", str(db_dir), "--device", "cuda")
    c, ln = r["classify"], r["launches"]
    rows = (out_dir / "asv_mappings.tsv").read_text().splitlines()[1:]
    written = sum(row.split("\t")[2] != "NA" for row in rows)
    if not (c["calls"] == 1 and c["jobs"] >= 1 and ln["sw_forward_nm"] >= 1):
        raise AssertionError(f"{tag}: kernel 1 (NM) did not carry the candidate jobs: {r}")
    if c["start_jobs"] != written or ln["sw_forward_payload"] != ln["sw_walk"] or (
            written and ln["sw_walk"] < 1):
        raise AssertionError(f"{tag}: kernels 1 (payload) + 2 ran on {c['start_jobs']} jobs, "
                             f"classify wrote {written} hits: {r}")
    r["parts_s"] = dict(CLASSIFY_SECONDS)
    log(f"classify {tag}: {c['pairs']} candidate pairs, {c['jobs']} jobs through kernel 1 "
        f"(NM), {c['start_jobs']} written hits through kernels 1 (payload) + 2; launches "
        f"{ln}; route {c['seconds']:.3f} s ({c['plan_s']:.3f} s of it in the flat planner) "
        f"of {r['wall_s']:.3f} s wall; "
        f"seconds by part {json.dumps({k: round(v, 3) for k, v in CLASSIFY_SECONDS.items()})}; "
        f"{nvidia_smi_line()}")
    return r


def classification(work: Path, int32_ops_per_s: float) -> dict:
    """Phase 6: classify, sintax and export through
    savont_tpu_torch.cli.main on the card, on phase 5's work directory, held
    to DIGESTS_CLASSIFICATION, with the launches of each route counted from
    0 just before it; then kernel 3 on its edge cases and at the cell's
    shapes, and kernel 1 (NM) at the classify cell's shapes."""
    from savont_tpu_torch.db.synth import build_emu_slice

    out: dict = {}
    t0 = time.perf_counter()
    build_emu_slice(work / "templates.fa", work / "db", n_refs=DB_REFS, seed=DB_SEED, device="cuda")
    db_dir = work / "db" / "emu"
    log(f"database: build_emu_slice, {DB_REFS} references, {time.perf_counter() - t0:.2f} s")
    write_hard_asvs(db_dir / "species_taxid.fasta", work / "hard")
    out["classify_mesh"] = cli_classify("phase-5 ASVs", work / "mesh", db_dir)
    out["classify_hard"] = cli_classify(f"{N_HARD} hard ASVs", work / "hard", db_dir)
    sintax_args = ["-i", str(work / "mesh"), "-d", str(db_dir), "--device", "cuda"]
    r = cli_counted("sintax", "sintax", "-o", str(work / "sintax"), *sintax_args)
    sx, ln = r["sintax"], r["sintax_launches"]
    if ln["sintax_scores"] < 1 or ln["sintax_ref_kmers"] != ln["sintax_scores"] or \
            sx["kmer_rows_card"] != sx["refs"]:
        raise AssertionError(f"sintax: kernels 6 and 3 did not carry every chunk: {r}")
    log(f"sintax: {sx['refs']} kept references, all {sx['kmer_rows_card']} rows extracted on the "
        f"card, {ln['sintax_ref_kmers']} launches each of kernels 6 and 3; route "
        f"{sx['seconds']:.3f} s ({sx['kmers_s']:.3f} s of it reading and joining the references "
        f"on the host, {sx['flush_s']:.3f} s in the flushes) of {r['wall_s']:.3f} s wall; "
        f"{nvidia_smi_line()}")
    out["sintax"] = r
    # the same under --profile: the same outputs, profile.pstats and a trace
    prof = work / "profile"
    rp = cli_counted("sintax --profile", "--profile", str(prof), "sintax", "-o",
                     str(work / "sintax_profiled"), *sintax_args)
    for name in ("genus_abundance.tsv", "asv_mappings.tsv"):
        if (work / "sintax_profiled" / name).read_bytes() != (work / "sintax" / name).read_bytes():
            raise AssertionError(f"sintax under --profile wrote another {name}")
    if not ((prof / "profile.pstats").is_file() and (prof / "trace.json").is_file()):
        raise AssertionError(f"--profile wrote no profile.pstats / trace.json in {prof}")
    events = json.loads((prof / "trace.json").read_text()).get("traceEvents", [])
    on_card = [e for e in events if e.get("cat") == "kernel"]
    log(f"sintax --profile: {rp['wall_s']:.3f} s wall (route {rp['sintax']['seconds']:.3f} s); "
        f"profile.pstats and trace.json ({len(events)} events, {len(on_card)} device kernels, "
        f"{sum('sintax_rows_kernel' in e.get('name', '') for e in on_card)} of them kernel 3, "
        f"{sum('sintax_ref_kmers_kernel' in e.get('name', '') for e in on_card)} kernel 6) written")
    out["profile_kernels"] = len(on_card)
    cli_counted("export", "export", "-i", str(work / "mesh"), str(work / "host"), "-o",
                str(work / "export"), "--relabel", *EXPORT_LABELS)
    got = classification_digests(work)
    if got != DIGESTS_CLASSIFICATION:
        raise AssertionError(f"classification outputs differ from the pinned digests of the "
                             f"host runs: {got}")
    log(f"classification outputs ({len(got)} files: DB, classify x 2, sintax, export) equal the "
        f"host runs' pinned digests")
    n_edge = check_sintax_edges()
    log(f"  kernel 3: {n_edge} edge cases exact")
    n_ref = check_sintax_ref_kmers()
    log(f"  kernel 6: {n_ref} cases exact")
    from savont_tpu_torch.io.fastx import read_fastx
    from savont_tpu_torch.pipeline.sintax import CHUNK_ROWS

    refs = []
    for rec in read_fastx(str(db_dir / "species_taxid.fasta")):
        refs.append(rec.seq)
        if len(refs) == CHUNK_ROWS:
            break
    out["sintax_ref_kmers"] = sintax_ref_cell(refs, "the classification database")
    out["sintax_route"] = sintax_route_check(db_dir, work / "mesh" / "final_asvs.fasta")
    both = work / "mesh_hard"
    both.mkdir()
    (both / "final_asvs.fasta").write_bytes(b"".join(
        (work / d / "final_asvs.fasta").read_bytes() for d in ("mesh", "hard")))
    out["sintax_kernel"] = {tag: sintax_cell(work / tag, db_dir / "species_taxid.fasta")
                            for tag in SINTAX_SHAPES}
    out["classify_nm"] = {d: classify_nm_cell(work, work / d, int32_ops_per_s)
                          for d in ("mesh", "hard")}
    return out


def _palindrome(rng, k: int) -> bytes:
    """A masked palindrome of length k: its first k // 2 bases are the
    reverse complement of its last k // 2, the middle base any."""
    from savont_tpu_torch.ops.encode import revcomp_bytes

    half = rng.choice(list(b"ACGT"), k // 2).astype("uint8").tobytes()
    return half + bytes([int(rng.choice(list(b"ACGT")))]) + revcomp_bytes(half)


def kmer_edge_cases(k: int, seed: int = EDGE_SEED + 3) -> list[dict]:
    """Read batches for kernels 4 and 5 at k: {"name", "reads": bytes,
    "quals": phred arrays (uint8) or None, or a list with some None}."""
    import numpy as np

    rng = np.random.default_rng(seed + k)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)

    def rand(n: int) -> bytes:
        return rng.choice(acgt, n).tobytes()

    def q(n: int, v: int = 40):
        return np.full(n, v, dtype=np.uint8)

    def rq(n: int):
        return rng.integers(2, 41, n).astype(np.uint8)

    pal = rand(60) + _palindrome(rng, k) + rand(70) + _palindrome(rng, k) + rand(50)
    pal_run = b"".join(_palindrome(rng, k) for _ in range(20))
    low = q(800)
    for v, at in ((5, 100), (MIN_BQ - 1, 200), (MIN_BQ, 300), (0, 400)):
        low[at : at + 10] = v
    lens_q = [q(n) for n in (0, k - 1, k, k + 1)]
    lens_q[3][k // 2] = 3  # one position, its middle base low
    reads65 = [rand(int(n)) for n in rng.integers(100, 1600, 65)]
    tile_lens = (KMER_TILE + k - 1, KMER_TILE + k, 3 * KMER_TILE + k - 1, 12_000)
    # reads back to back from every byte offset mod 16 (the kernels stage
    # 16-byte vectors from the boundary below a tile), the last one ending
    # the buffer at a length that is not a multiple of 16
    offset_lens = range(k - 1, k + 33)
    # one position below, at and above a round of one position a thread
    thread_lens = [n + k - 1 for m in (1, 2) for n in (m * KMER_THREADS - 1, m * KMER_THREADS,
                                                        m * KMER_THREADS + 1)]
    # one position below, at and above a tile, with qualities all equal (the
    # gate off) and equal but for the last base (the gate on, every middle
    # base below MIN_BQ)
    tq = KMER_TILE + k - 1
    last_differs = [q(n, MIN_BQ - 15) for n in (tq, tq + 1)]
    for a in last_differs:
        a[-1] = 40
    cases = [
        ("lengths", [rand(n) for n in (0, k - 1, k, k + 1)], lens_q),
        ("palindrome", [pal], [q(len(pal))]),
        ("palindrome_run", [pal_run], [q(len(pal_run))]),
        ("homopolymer", [b"A" * 300, b"T" * 300, b"C" * 40 + b"G" * 40], None),
        ("low_mid_quality", [rand(800)], [low]),
        ("all_equal_quality", [rand(800), rand(500)], [q(800, 12), q(500, 40)]),
        ("no_quality", [rand(n) for n in (300, 900, 1450)], None),
        ("some_without_quality", [rand(n) for n in (400, 500, 600, 700, 800)],
         [rq(400), None, rq(600), None, rq(800)]),
        ("one_read", [rand(1450)], [rq(1450)]),
        ("65_reads", reads65, [rq(len(r)) for r in reads65]),
        ("operon_5000", [rand(5000)], [rq(5000)]),
        ("tile_edges", [rand(n) for n in tile_lens], [rq(n) for n in tile_lens]),
        ("offsets16", [rand(n) for n in offset_lens], [rq(n) for n in offset_lens]),
        ("thread_edges", [rand(n) for n in thread_lens], [rq(n) for n in thread_lens]),
        ("tile_quality", [rand(n) for n in (tq - 1, tq, tq, tq + 1, tq + 1)],
         [rq(tq - 1), q(tq, MIN_BQ - 15), last_differs[0], q(tq + 1, MIN_BQ - 15), last_differs[1]]),
    ]
    return [{"name": n, "reads": r, "quals": qs} for n, r, qs in cases]


def kmer_bound(name: str, bases: int, positions: int, reads: int, has_qual: bool,
               int32_ops_per_s: float, c: int = 11) -> dict:
    """Least time for kernel 4's or 5's function on a batch: the larger of
    its bytes (each base's code, and phred for kernel 4, read once; the two
    offset arrays; 8 + 1 B written a position) over HBM_BYTES_PER_S and its
    integer operations (KMER_OPS a position; kernel 5's syncmer_ops(c))
    over the card's measured int32 rate."""
    per_pos = KMER_OPS["split_kmers"] if name == "split_kmers" else syncmer_ops(c)
    nbytes = bases * (2 if name == "split_kmers" and has_qual else 1) + 16 * (reads + 1) + 9 * positions
    ops = per_pos * positions
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int32_ops_per_s * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _exact(tag: str, got, want) -> int:
    """0 when every pair of tensors is equal (tolerance 0); raises otherwise."""
    import torch

    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            n = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"{tag}: the kernel differs from its plain version at {n} "
                                 f"positions (shapes {tuple(a.shape)} / {tuple(b.shape)})")
    return 0


def check_kmer_edges() -> int:
    """Kernels 4 and 5 against their plain versions on the card, exact, on
    kmer_edge_cases at every k of KMER_KS and (k, c) of SYNC_KC; kernel 4's
    per-read lists (device_split_kmers) and the card's count
    (split_kmer_count) against the port's host split_kmer_mid and
    count_flagged_kmers too.  Returns the number of (case, k) pairs."""
    import numpy as np

    from savont_tpu_torch.ops import kmers_torch as kt
    from savont_tpu_torch.ops.encode import encode_seq
    from savont_tpu_torch.ops.kmers import count_flagged_kmers, split_kmer_mid
    from savont_tpu_torch.parallel.mesh import split_kmer_count

    n = 0
    for k in KMER_KS:
        for case in kmer_edge_cases(k):
            codes = [encode_seq(r) for r in case["reads"]]
            quals = case["quals"]
            batch = kt.read_batch(codes, quals, k, "cuda")
            got4 = kt.split_kmers_batch(batch, MIN_BQ)
            _exact(f"kernel 4, {case['name']}, k={k}", got4,
                   kt.split_kmers_batch_reference(batch, MIN_BQ))
            per_read = kt.device_split_kmers(codes, quals, k, MIN_BQ, "cuda")
            host = [split_kmer_mid(c, None if quals is None else quals[i], k, MIN_BQ)
                    for i, c in enumerate(codes)]
            if any(not np.array_equal(a, b) for a, b in zip(per_read, host)) or len(per_read) != len(host):
                raise AssertionError(f"device_split_kmers differs from split_kmer_mid: "
                                     f"{case['name']}, k={k}")
            got_t, want_t = split_kmer_count(codes, quals, k, MIN_BQ, "cuda"), count_flagged_kmers(host)
            if any(not np.array_equal(a, b) for a, b in zip(got_t, want_t)):
                raise AssertionError(f"split_kmer_count differs from count_flagged_kmers: "
                                     f"{case['name']}, k={k}")
            cs = [c for kk, c in SYNC_KC if kk == k]
            for c in cs:
                _exact(f"kernel 5, {case['name']}, k={k}, c={c}", kt.syncmer_batch(batch, c),
                       kt.syncmer_batch_reference(batch, c))
            n += 1
            log(f"  edge {case['name']}, k={k}: {len(codes)} reads, {batch.n_pos} positions, "
                f"{int(got4[1].sum())} valid, {len(got_t[0])} distinct: kernel 4 == plain == "
                f"split_kmer_mid, the card's count == count_flagged_kmers, kernel 5 == plain "
                f"at c {cs} (exact)")
    return n


def kmer_cell(work: Path, int32_ops_per_s: float) -> dict:
    """Kernels 4 and 5 at the kernel cell, N_KMER_READS of write_reads'
    reads: each against its plain version on the card (exact), timed
    queued (20 launches) and single with its plain version and bound; the
    compaction and the count's sort (torch.sort + unique_consecutive, a
    library call) timed apart; the card's split_kmer_count equal to the
    port's host scan + count (split_kmers_native, count_flagged_kmers)."""
    import numpy as np
    import torch

    from savont_tpu_torch.io.fastx import read_fastx_records
    from savont_tpu_torch.ops import kmers_torch as kt
    from savont_tpu_torch.ops.kmers import count_flagged_kmers
    from savont_tpu_torch.ops.kmers_native import split_kmers_native
    from savont_tpu_torch.parallel.mesh import count_flagged, split_kmer_count
    from savont_tpu_torch.pipeline.stage1_kmers import _batch_encode

    d = work / "kmer_cell"
    d.mkdir()
    write_reads(d / "reads.fq.gz", d / "templates.fa", np.random.default_rng(KMER_SEED), N_KMER_READS)
    recs = read_fastx_records(str(d / "reads.fq.gz"))
    codes, quals = _batch_encode([r.seq for r in recs], [r.qual for r in recs])
    k, c = KMER_KS[0], 11
    count_flagged_kmers(split_kmers_native(codes[:10], quals[:10], k, MIN_BQ))  # builds the library
    t0 = time.perf_counter()
    host = count_flagged_kmers(split_kmers_native(codes, quals, k, MIN_BQ), threads=4)
    host_s = time.perf_counter() - t0
    split_kmer_count(codes, quals, k, MIN_BQ, "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = split_kmer_count(codes, quals, k, MIN_BQ, "cuda")
    card_s = time.perf_counter() - t0
    if any(not np.array_equal(a, b) for a, b in zip(card, host)) or card[1].dtype != host[1].dtype:
        raise AssertionError("the card's split_kmer_count differs from the host count at the kernel cell")

    batch = kt.read_batch(codes, quals, k, "cuda")
    bases = int(batch.codes.numel())
    kt.reset_counters()
    keys, valid = kt.split_kmers_batch(batch, MIN_BQ)
    flags, kmers = kt.syncmer_batch(batch, c)
    launches = dict(kt.LAUNCHES)
    out = {"reads": len(codes), "bases": bases, "positions": batch.n_pos, "host_count_s": host_s,
           "card_count_s": card_s, "distinct": len(host[0]), "launches": launches}
    out["split_kmers"] = {
        "max_abs_err": _exact("kernel 4, kernel cell", (keys, valid),
                              kt.split_kmers_batch_reference(batch, MIN_BQ)),
        "plain_ms": cuda_ms(lambda: kt.split_kmers_batch_reference(batch, MIN_BQ), 3),
        "ms": cuda_ms(lambda: kt.split_kmers_launch(batch, MIN_BQ, keys, valid), 20),
        "single_ms": cuda_ms(lambda: kt.split_kmers_launch(batch, MIN_BQ, keys, valid), 1, False),
        **kmer_bound("split_kmers", bases, batch.n_pos, len(codes), True, int32_ops_per_s)}
    out["syncmers"] = {
        "c": c,
        "max_abs_err": _exact("kernel 5, kernel cell", (flags, kmers),
                              kt.syncmer_batch_reference(batch, c)),
        "plain_ms": cuda_ms(lambda: kt.syncmer_batch_reference(batch, c), 3),
        "ms": cuda_ms(lambda: kt.syncmer_launch(batch, c, flags, kmers), 20),
        "single_ms": cuda_ms(lambda: kt.syncmer_launch(batch, c, flags, kmers), 1, False),
        **kmer_bound("syncmers", bases, batch.n_pos, len(codes), False, int32_ops_per_s, c)}
    for name in ("split_kmers", "syncmers"):  # the outputs of the timed launches too
        got = (keys, valid) if name == "split_kmers" else (flags, kmers)
        want = (kt.split_kmers_batch_reference(batch, MIN_BQ) if name == "split_kmers"
                else kt.syncmer_batch_reference(batch, c))
        _exact(f"{name}, timed launches", got, want)
    v = valid.bool()
    flagged = keys[v]
    packed = ((flagged & kt.BARE) << 1) | (flagged < 0).long()
    out["compact_ms"] = cuda_ms(lambda: keys[v], 20)
    out["sort_ms"] = cuda_ms(lambda: torch.sort(packed), 20)
    out["sort_count_ms"] = cuda_ms(lambda: count_flagged(flagged), 20)
    out["flagged"] = int(flagged.numel())
    return out


def stage1_turns(fq: Path, order=STAGE1_ORDER, bloom: float = 0.0, want=None) -> tuple[list, tuple]:
    """The port's read_to_split_kmers on fq, on the host and on the card in
    turns (order), with -b `bloom` when it is above 0, each from a cold
    parse, with COUNT_STATS and the launches counted from 0 just before it;
    every table equal to `want`, or to the first turn's.  Returns the turns
    and that table."""
    import numpy as np

    from savont_tpu_torch.config import ClusterArgs
    from savont_tpu_torch.ops import kmers_torch as kt
    from savont_tpu_torch.pipeline import stage1_kmers as s1

    turns, tag = [], " -b" if bloom > 0 else ""
    for backend in order:
        s1._READ_CACHE.clear()
        s1._ENCODE_CACHE.clear()
        s1._READ_CACHE_BYTES = 0
        s1.reset_count_stats()
        kt.reset_counters()
        t0 = time.perf_counter()
        table = s1.read_to_split_kmers(ClusterArgs(input_files=[str(fq)], threads=4,
                                                   bloom_filter_size=bloom,
                                                   stage1_backend=backend, device="cuda"))
        wall = time.perf_counter() - t0
        want = want or table
        if any(not np.array_equal(a, b) for a, b in zip(table, want)):
            raise AssertionError(f"stage 1 on {backend}{tag} gives another table than the first turn's")
        n = 1 if backend == "mesh" else 0
        if kt.LAUNCHES["split_kmers"] != n or any(kt.REFERENCE_CALLS.values()):
            raise AssertionError(f"stage 1 on {backend}{tag}: launches {kt.LAUNCHES}, plain calls "
                                 f"{kt.REFERENCE_CALLS}")
        turns.append({"backend": backend, "bloom": bloom, "wall_s": wall,
                      "parts": {k: v for k, v in s1.COUNT_STATS.items() if v}})
        log(f"  stage 1, {backend}{tag}: {wall:.4f} s, {len(table[0])} k-mers retained; "
            f"{json.dumps(turns[-1]['parts'])}")
    return turns, want


def stage1_cell(work: Path) -> dict:
    """The stage-1 route at the main-path cell (phase 5's reads) in turns
    (stage1_turns), without -b and with it (STAGE1_BLOOM_ORDER: the card's
    per-read lists into the host count), every table equal; then one whole `asv --stage1-backend mesh` through the
    CLI, held to DIGESTS and NM=0, with every count set to 0 just before
    it."""
    from savont_tpu_torch import cli
    from savont_tpu_torch.ops import align_torch
    from savont_tpu_torch.ops import kmers_torch as kt
    from savont_tpu_torch.parallel.mesh import reset_route_stats
    from savont_tpu_torch.pipeline import stage1_kmers as s1
    from savont_tpu_torch.pipeline.asv import STAGE_SECONDS
    from savont_tpu_torch.validate import validate_asvs

    fq, tpl = work / "reads.fq.gz", work / "templates.fa"
    log(f"stage 1 at the main-path cell ({N_READS} reads), in turns:")
    turns, table = stage1_turns(fq)
    log(f"  the same with -b {STAGE1_BLOOM_SIZE}: the card's extraction into the host's "
        "counts, held to the same table")
    turns += stage1_turns(fq, STAGE1_BLOOM_ORDER, STAGE1_BLOOM_SIZE, table)[0]
    kt.reset_counters()
    align_torch.reset_counters()
    reset_route_stats()
    s1.reset_count_stats()
    t0 = time.perf_counter()
    rc = cli.main(["--log-level", "warn", "asv", str(fq), "-o", str(work / "stage1_mesh"),
                   "--device", "cuda", "-t", "4", "--stage1-backend", "mesh"])
    wall = time.perf_counter() - t0
    launches, plain = dict(kt.LAUNCHES), {**kt.REFERENCE_CALLS, **align_torch.REFERENCE_CALLS}
    if rc != 0:
        raise AssertionError(f"savont_tpu_torch asv --stage1-backend mesh exited {rc}")
    got = output_digests(work / "stage1_mesh")
    if got != DIGESTS:
        raise AssertionError(f"asv --stage1-backend mesh: outputs differ from the pinned digests: {got}")
    val = validate_asvs(str(work / "stage1_mesh" / "final_asvs.fasta"), str(tpl))
    if not val or any(v.nm != 0 for v in val):
        raise AssertionError(f"asv --stage1-backend mesh: ASVs not all NM=0: {val}")
    if launches["split_kmers"] < 1 or any(plain.values()):
        raise AssertionError(f"asv --stage1-backend mesh: launches {launches}, plain calls {plain}")
    log(f"  asv --stage1-backend mesh: {wall:.2f} s, {len(val)} ASVs all NM=0, outputs equal the "
        f"pinned digests; launches {launches}, {align_torch.LAUNCHES}; stage seconds "
        f"{ {k: round(v, 3) for k, v in STAGE_SECONDS.items()} }; stage 1's count "
        f"{json.dumps({k: v for k, v in s1.COUNT_STATS.items() if v})}")
    return {"turns": turns, "asv_launches": launches, "asv_wall_s": wall}


def stage1_kmers_phase(work: Path, int32_ops_per_s: float) -> dict:
    """Phase 7: kernels 4 and 5 on their edge cases, at the kernel cell, and
    the stage-1 route at the main-path cell."""
    n = check_kmer_edges()
    log(f"  kmer edge cases: {n} (case, k) pairs, k {KMER_KS}, (k, c) {SYNC_KC}: exact")
    phase_done("phase 7, edge cases")
    cell = kmer_cell(work, int32_ops_per_s)
    log("  kmer cell: " + json.dumps(cell))
    log(f"stage 1 at the kernel cell ({N_KMER_READS} reads), in turns:")
    cell["turns"] = stage1_turns(work / "kmer_cell" / "reads.fq.gz")[0]
    phase_done("phase 7, kernel cell")
    return {"cell": cell, **stage1_cell(work)}


def operon_kernels(int32_ops_per_s: float) -> dict:
    """Kernels 1 (both modes) and 2 at operon shapes: the planner's jobs at
    band 128 from OPERON_KERNEL_TEMPLATES random templates of
    OPERON_TEMPLATE_LEN bases, OPERON_KERNEL_READS reads each, against their
    plain versions on the card (tolerance 0: integers) and the job routes
    against the host oracle (check_kernels); each timed as QUEUED_RUNS
    launches queued back to back and one alone, the plain version once,
    with its bound (sw_bounds) and kernel 2's shared memory a warp and pairs
    a block at this ops_max."""
    import numpy as np

    from savont_tpu_torch.ops.build import build_kernels
    from savont_tpu_torch.probes.roofline import QUEUED_RUNS

    jobs = plan(make_pairs(np.random.default_rng(OPERON_KERNEL_SEED), OPERON_KERNEL_TEMPLATES,
                           OPERON_KERNEL_READS, OPERON_TEMPLATE_LEN), OPERON_BAND)
    res = check_kernels(jobs, OPERON_BAND, time_plain=True, queued=True)
    shape = res.pop("shape")
    ops_max = shape["Lq"] + shape["Lt"]
    wb = build_kernels().sw_walk_warp_bytes(OPERON_BAND, ops_max, MAXRUN)
    if wb != walk_warp_bytes(OPERON_BAND, ops_max):
        raise AssertionError(f"kernel 2's shared memory a warp at ops_max {ops_max}: the source "
                             f"says {wb} B, walk_warp_bytes {walk_warp_bytes(OPERON_BAND, ops_max)}")
    bounds = sw_bounds(shape, int32_ops_per_s)
    out = {name: {**r, **bounds[name]} for name, r in res.items()}
    out["shape"] = {**shape, "ops_max": ops_max, "walk_warp_bytes": wb,
                    "walk_warps_per_block": walk_warps_per_block(wb)}
    for name in SW_KERNELS:
        r = out[name]
        log(f"  {name} at operon shapes: {r['ms']:.4f} ms queued ({QUEUED_RUNS} launches), "
            f"{r['single_ms']:.4f} ms single, {100 * r['bound_ms'] / r['ms']:.1f}% of its "
            f"{r['bound_ms']:.4f} ms bound ({r['bound_by']}); plain {r['plain_ms']:.1f} ms; "
            f"exact")
    log(f"  operon shapes: {json.dumps(out['shape'])}; kernel 2 keeps {wb} B of shared memory "
        f"a pair, {out['shape']['walk_warps_per_block']} pairs a block")
    return out


def check_asv_routes(tag: str, r: dict, n_reads: int, min_launches: int = 1) -> None:
    """The device routes of cli_asv's run r: no fallback; stage 7 carrying
    at least half as many jobs as there are reads; each route every job its
    flat planner made, in at least min_launches launches of at most
    PAIRS_PER_LAUNCH jobs that add up to them, each launch of its kernels
    counted by their wrappers inside the route (stage 4: kernel 1 in
    payload mode and kernel 2; stage 7: kernel 1 in NM mode)."""
    from savont_tpu_torch.ops.align_torch import PAIRS_PER_LAUNCH

    s4, s7 = r["routes"]["stage4"], r["routes"]["stage7"]
    if s4["fallbacks"] or s7["fallbacks"]:
        raise AssertionError(f"{tag}: the flat planner declined work: {r['routes']}")
    if s7["jobs"] < n_reads // 2:
        raise AssertionError(f"{tag}: stage 7 carried {s7['jobs']} jobs, under {n_reads // 2}")
    for name, stage, kernels in (("stage 4", "stage4", ("sw_forward_payload", "sw_walk")),
                                 ("stage 7", "stage7", ("sw_forward_nm",))):
        st, ln = r["routes"][stage], r["route_launches"][stage]
        if not (st["calls"] >= 1 and st["jobs"] == st["planned"] > 0
                and sum(st["launch_jobs"]) == st["jobs"]
                and len(st["launch_jobs"]) >= min_launches
                and max(st["launch_jobs"]) <= PAIRS_PER_LAUNCH
                and all(ln[k] >= len(st["launch_jobs"]) for k in kernels)):
            raise AssertionError(f"{tag}: {name} did not carry every planned job through the "
                                 f"kernels in {min_launches} launches or more: {st}, "
                                 f"launches inside the route {ln}")


def operon_phase(work: Path, int32_ops_per_s: float) -> dict:
    """Phase "operon": kernels 1 and 2 at operon shapes (operon_kernels), then
    the operon sample through `asv --rrna-operon` on the card: once untimed
    and once timed on the default routes (stages 4p and 7 on the device),
    then once with --stage1-backend mesh (kernel 4 too); each held to
    DIGESTS_OPERON, NM=0, its kernels launched, no plain version, and its
    device routes (check_asv_routes)."""
    from savont_tpu_torch.ops.align_torch import PAYLOAD_BYTES

    kern = operon_kernels(int32_ops_per_s)
    phase_done("phase operon, kernels 1 and 2 at operon shapes")
    d = work / "operon"
    d.mkdir()
    fq, tpl = d / "reads.fq.gz", d / "templates.fa"
    operon_sample(fq, tpl)
    runs = {}
    for tag, extra, kernels in (("warmup", (), SW_KERNELS), ("mesh", (), SW_KERNELS),
                                ("stage1_mesh", ("--stage1-backend", "mesh"),
                                 SW_KERNELS + ("split_kmers",))):
        r = cli_asv(d / tag, fq, "--rrna-operon", *extra)
        r["n_asvs"] = held(d / tag, tpl, DIGESTS_OPERON, r, kernels)
        check_asv_routes(tag, r, N_READS_OPERON)
        s4, s7 = r["routes"]["stage4"], r["routes"]["stage7"]
        cut = [n * lq * OPERON_BAND for n, lq in zip(s4["launch_jobs"], s4["launch_lq"])]
        wb = walk_warp_bytes(OPERON_BAND, s4["ops_max"])
        log(f"operon {tag} (asv --rrna-operon{' ' + ' '.join(extra) if extra else ''}): "
            f"{N_READS_OPERON} reads, {r['n_asvs']} ASVs all NM=0, outputs equal DIGESTS_OPERON; "
            f"wall {r['wall_s']:.3f} s (kernel build excluded); stage seconds {r['stage_s']}")
        log(f"  stage 4 route {s4['seconds']:.4f} s; "
            f"{s4['jobs']} of {s4['planned']} planned jobs in {len(cut)} launches (cut: jobs "
            f"{s4['launch_jobs']}, padded Lq {s4['launch_lq']}, payload bytes {cut} against "
            f"PAYLOAD_BYTES {PAYLOAD_BYTES}); {s4['overflow']} pairs overflowed kernel 2 and were "
            f"counted on the host; kernel 2 at ops_max {s4['ops_max']}: {wb} B a pair, "
            f"{walk_warps_per_block(wb)} pairs a block")
        log(f"  stage 7 route {s7['seconds']:.4f} s; "
            f"{s7['jobs']} of {s7['planned']} planned jobs in {len(s7['launch_jobs'])} launches "
            f"(jobs {s7['launch_jobs']}, padded Lq {s7['launch_lq']})")
        log(f"  launches {r['launches']}; per-job routes (stage-4 votes, stages 5-6) "
            f"{r['per_job_route_s']}" + (f"; stage 1's count {json.dumps(r['stage1_count'])}"
                                         if r["stage1_count"] else ""))
        runs[tag] = r
    log(f"  card: {nvidia_smi_line()}")
    return {"kernels": kern, "runs": runs}


@contextmanager
def stage7_launch_kept(kept: list):
    """Inside the block, the stage-7 route's first launch of kernel 1 that
    carries a full PAIRS_PER_LAUNCH jobs keeps its inputs (q, t, lo, tlens)
    and band in `kept`; the launch itself is the route's, counted once by
    the wrapper as always."""
    from savont_tpu_torch.ops.align_torch import PAIRS_PER_LAUNCH
    from savont_tpu_torch.parallel import mesh

    real = mesh.sw_forward

    def keep(q, t, lo, tl, band, **kw):
        if not kept and not kw and q.shape[0] == PAIRS_PER_LAUNCH:
            kept.append(((q, t, lo, tl), band))
        return real(q, t, lo, tl, band, **kw)

    mesh.sw_forward = keep
    try:
        yield kept
    finally:
        mesh.sw_forward = real


def scale_nm_kernel(kept: list, int32_ops_per_s: float) -> dict:
    """Kernel 1 (NM mode) on one full stage-7 launch of the scale sample
    (stage7_launch_kept): against its plain version on the card (tolerance
    0), timed as QUEUED_RUNS launches queued back to back and one alone, the
    plain version once, with its bound (sw_bounds)."""
    import torch

    from savont_tpu_torch.ops.align_torch import sw_forward, sw_forward_reference
    from savont_tpu_torch.probes.roofline import QUEUED_RUNS, launch_ms

    if not kept:
        raise AssertionError("stage 7 made no launch of PAIRS_PER_LAUNCH jobs on the scale sample")
    (x, band), = kept
    err = max_abs_diff([(sw_forward(*x, band), sw_forward_reference(*x, band))])
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"kernel 1 (NM) differs from its plain version on a full stage-7 "
                             f"launch of the scale sample by {err}")
    plain_ms = cuda_ms(lambda: sw_forward_reference(*x, band), 1, warm_up=False)
    ms = launch_ms(lambda: sw_forward(*x, band), runs=QUEUED_RUNS)
    single = launch_ms(lambda: sw_forward(*x, band))
    B, Lq = x[0].shape
    shape = {"B": B, "Lq": Lq, "Lt": int(x[1].shape[1]), "band": band,
             "walk_steps": 0, "walk_max_steps": 0, "walk_rows": 0}
    b = sw_bounds(shape, int32_ops_per_s)["sw_forward_nm"]
    out = {"max_abs_err": err, "ms": ms, "single_ms": single, "plain_ms": plain_ms,
           "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "shape": {k: shape[k] for k in ("B", "Lq", "Lt", "band")}}
    log(f"  sw_forward_nm on a full stage-7 launch of the scale sample ({B} jobs, Lq {Lq}, band "
        f"{band}, {b['cells']} cells): == plain (exact); {ms:.4f} ms queued ({QUEUED_RUNS} "
        f"launches), {single:.4f} ms single, {100 * b['bound_ms'] / ms:.1f}% of its "
        f"{b['bound_ms']:.4f} ms bound ({b['bound_by']}); plain {plain_ms:.1f} ms; "
        f"{nvidia_smi_line()}")
    return out


def scale_phase(work: Path, int32_ops_per_s: float) -> dict:
    """Phase "scale": one PromethION 16S barcode's scale.  scale_sample's
    100,000 reads of 48 templates through `asv` on the card, on the default
    routes and with --stage1-backend mesh, each held to DIGESTS_SCALE, NM=0
    for all 48 ASVs, its kernels launched, no plain version, and its device
    routes (check_asv_routes: stages 4 and 7 in two launches or more);
    then build_emu_slice of the 48 templates at SCALE_DB_REFS references,
    `classify` of the scale ASVs and of write_hard_asvs' ASVs and `sintax`
    of the scale ASVs, held to DIGESTS_SCALE_CLASSIFICATION, sintax over at
    least ceil(SCALE_DB_REFS / CHUNK_ROWS) chunks of every reference; then
    kernel 1 (NM) on a full stage-7 launch of the sample (scale_nm_kernel)
    and kernel 3 on the scale ASVs' pairs, two pair tiles, against the
    first CHUNK_ROWS references (sintax_cell)."""
    import math

    import torch

    from savont_tpu_torch.db.synth import build_emu_slice
    from savont_tpu_torch.pipeline.sintax import CHUNK_ROWS

    t_phase = time.perf_counter()
    d = work / "scale"
    d.mkdir()
    fq, tpl = d / "reads.fq.gz", d / "templates.fa"
    t0 = time.perf_counter()
    scale_sample(fq, tpl)
    log(f"scale sample: {N_READS_SCALE} reads of {N_TEMPLATES_SCALE} templates, "
        f"{time.perf_counter() - t0:.2f} s to draw and write")
    runs, kept = {}, []
    for tag, extra, kernels in (("asv", (), SW_KERNELS),
                                ("stage1_mesh", ("--stage1-backend", "mesh"),
                                 SW_KERNELS + ("split_kmers",))):
        torch.cuda.reset_peak_memory_stats()
        # kernel 1 is timed below on a stage-7 launch kept from the mesh
        # run, whose peak memory is stage 1's count, long before stage 7
        with stage7_launch_kept(kept) if extra else nullcontext():
            r = cli_asv(d / tag, fq, *extra)
        r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        r["n_asvs"] = held(d / tag, tpl, DIGESTS_SCALE, r, kernels)
        if r["n_asvs"] != N_TEMPLATES_SCALE:
            raise AssertionError(f"scale {tag}: {r['n_asvs']} ASVs, not {N_TEMPLATES_SCALE}")
        check_asv_routes(tag, r, N_READS_SCALE, min_launches=2)
        s4, s7 = r["routes"]["stage4"], r["routes"]["stage7"]
        log(f"scale {tag} (asv{' ' + ' '.join(extra) if extra else ''}): {N_READS_SCALE} reads, "
            f"{r['n_asvs']} ASVs all NM=0, outputs equal DIGESTS_SCALE; wall {r['wall_s']:.3f} s "
            f"(kernel build excluded); stage seconds {r['stage_s']}; torch.cuda."
            f"max_memory_allocated {r['max_memory_allocated']} B")
        for name, st in (("stage 4", s4), ("stage 7", s7)):
            log(f"  {name} route {st['seconds']:.4f} s; "
                f"{st['jobs']} of {st['planned']} planned jobs in {len(st['launch_jobs'])} "
                f"launches (jobs {st['launch_jobs']}, padded Lq {st['launch_lq']})")
        log(f"  stage 4: {s4['overflow']} pairs overflowed kernel 2, ops_max {s4['ops_max']}")
        log(f"  launches {r['launches']}; per-job routes (stage-4 votes, stages 5-6) "
            f"{r['per_job_route_s']}" + (f"; stage 1's count {json.dumps(r['stage1_count'])}"
                                         if r["stage1_count"] else ""))
        runs[tag] = r
    phase_done("phase scale, asv")

    t0 = time.perf_counter()
    build_emu_slice(tpl, d / "db", n_refs=SCALE_DB_REFS, seed=DB_SEED, device="cuda")
    build_s = time.perf_counter() - t0
    db_dir = d / "db" / "emu"
    log(f"scale database: build_emu_slice of the {N_TEMPLATES_SCALE} templates, {SCALE_DB_REFS} "
        f"references, {build_s:.2f} s")
    write_hard_asvs(db_dir / "species_taxid.fasta", d / "hard")
    cls = {"build_s": build_s,
           "classify_asv": cli_classify("scale ASVs", d / "asv", db_dir),
           "classify_hard": cli_classify(f"{N_HARD} hard ASVs of the scale database", d / "hard",
                                         db_dir)}
    r = cli_counted("scale sintax", "sintax", "-i", str(d / "asv"), "-o", str(d / "sintax"), "-d",
                    str(db_dir), "--device", "cuda")
    sx, n_launch = r["sintax"], r["sintax_launches"]["sintax_scores"]
    if sx["refs"] != SCALE_DB_REFS or n_launch < math.ceil(SCALE_DB_REFS / CHUNK_ROWS) or \
            r["sintax_launches"]["sintax_ref_kmers"] != n_launch or \
            sx["kmer_rows_card"] != sx["refs"]:
        raise AssertionError(f"scale sintax: {sx['refs']} references in {n_launch} launches of "
                             f"kernels 6 and 3, not {SCALE_DB_REFS} in "
                             f"{math.ceil(SCALE_DB_REFS / CHUNK_ROWS)}, all rows on the card: {r}")
    log(f"scale sintax: {sx['refs']} references, all rows extracted on the card, in {n_launch} "
        f"launches each of kernels 6 and 3 (chunks of {CHUNK_ROWS}); route {sx['seconds']:.3f} s "
        f"({sx['kmers_s']:.3f} s of it reading and joining the references on the host, "
        f"{sx['flush_s']:.3f} s in the flushes) of {r['wall_s']:.3f} s wall")
    cls["sintax"] = r
    got = {rel: hashlib.sha256((d / rel).read_bytes()).hexdigest()
           for rel in DIGESTS_SCALE_CLASSIFICATION}
    if got != DIGESTS_SCALE_CLASSIFICATION:
        raise AssertionError(f"scale classification outputs differ from the pinned digests of the "
                             f"host runs: {got}")
    log(f"scale classification outputs ({len(got)} files: DB, classify x 2, sintax) equal the "
        f"host runs' pinned digests")
    phase_done("phase scale, classification")

    k1 = scale_nm_kernel(kept, int32_ops_per_s)
    k3 = sintax_cell(d / "asv", db_dir / "species_taxid.fasta")
    P = k3["shape"]["P"]
    if not SINTAX_PAIR_TILE < P <= 2 * SINTAX_PAIR_TILE:
        raise AssertionError(f"scale sintax: {P} pairs do not span two of kernel 3's pair tiles")
    seconds = time.perf_counter() - t_phase
    log(f"scale phase: {seconds:.1f} s; card: {nvidia_smi_line()}")
    return {"runs": runs, "classification": cls, "sw_forward_nm": k1, "sintax_scores": k3,
            "seconds": seconds}


def scale_alone(work: Path, int32_ops_per_s: float = 32.6e12) -> dict:
    """The scale phase alone, to iterate on it: the kernels built, then the
    phase in `work`, its bounds at `int32_ops_per_s` (phase 4 measures the
    rate; 32.6 T int32 ops/s is what it read on an H100 at 700 W)."""
    from savont_tpu_torch.ops.build import build_kernels

    build_kernels()
    return scale_phase(work, int32_ops_per_s)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(work: Path, job: str, world: int, env_of=None) -> list[dict]:
    """Run `world` ranks of `job` (this script with --rank-worker) together;
    each writes its result to work/ranks/<job>/out<rank>.json.  The first
    rank to fail, or the timeout, kills them all and raises with their
    logs' tails.  Returns the results, rank order, each with the rank's
    process wall."""
    import os

    run = work / "ranks" / job
    run.mkdir(parents=True)
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            logs.append(open(run / f"rank{r}.log", "w"))
            env = {**os.environ, **RANK_ENV, **(env_of(r) if env_of else {})}
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker", job, str(r),
                 str(world), str(work)], cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        walls = [0.0] * world
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.perf_counter() - t0 > RANKS_TIMEOUT_S:
                break
            time.sleep(0.05)
            for r, p in enumerate(procs):
                if p.poll() is not None and not walls[r]:
                    walls[r] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{job}: rank(s) {bad} failed (exit "
                             f"{[procs[r].returncode for r in bad]}):\n" + "\n".join(
                                 f"--- rank {r}:\n{(run / f'rank{r}.log').read_text()[-4000:]}"
                                 for r in bad))
    outs = []
    for r in range(world):
        out = json.loads((run / f"out{r}.json").read_text())
        out["process_s"] = walls[r] or time.perf_counter() - t0
        outs.append(out)
    return outs


def rank_worker(job: str, rank: int, world: int, work: Path) -> int:
    """One rank of phase 8.  "nccl_cli": `asv` through the CLI, which joins
    the group from SAVONT_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID (NCCL).
    "gloo" / "nccl": joins with init(), on a card shared by every rank over
    gloo or one card a rank over NCCL, then runs `asv` and `sintax` through
    the CLI, each into the rank's own directory, split_kmer_count over the
    ranks at the kernel cell (held to the one-card count) and
    sharded_classify_nm."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from savont_tpu_torch import cli
    from savont_tpu_torch.ops import align_torch, kmers_torch, sintax_torch
    from savont_tpu_torch.parallel import distributed, mesh
    from savont_tpu_torch.pipeline import sintax as sintax_mod

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    run = work / "ranks" / job
    out: dict = {"rank": rank}
    if job != "nccl_cli":
        distributed.init(world, rank, f"file://{run}/rendezvous", "cuda",
                         backend="gloo" if job == "gloo" else "nccl")
    for m in (align_torch, sintax_torch, kmers_torch):
        m.reset_counters()
    mesh.reset_route_stats()
    distributed.reset_collectives()
    t0 = time.perf_counter()
    rc = cli.main(["--log-level", "warn", "asv", str(work / "reads.fq.gz"), "-o",
                   str(run / f"asv{rank}"), "--device", "cuda", "-t", "4"])
    out["asv_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"asv exited {rc}")
    out.update(digests=output_digests(run / f"asv{rank}"), routes=mesh.ROUTE_STATS,
               asv_collectives=dict(distributed.COLLECTIVES),
               asv_launches=dict(align_torch.LAUNCHES))
    if job != "nccl_cli":
        distributed.reset_collectives()
        sintax_mod.SCORE_STATS["refs"] = 0
        t0 = time.perf_counter()
        rc = cli.main(["--log-level", "warn", "sintax", "-i", str(work / "mesh"), "-o",
                       str(run / f"sintax{rank}"), "-d", str(work / "db" / "emu"), "--device",
                       "cuda"])
        out["sintax_s"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"sintax exited {rc}")
        out.update(sintax_digests={name: hashlib.sha256(
            (run / f"sintax{rank}" / name).read_bytes()).hexdigest()
            for name in ("genus_abundance.tsv", "asv_mappings.tsv")},
            sintax_refs=sintax_mod.SCORE_STATS["refs"],
            sintax_collectives=dict(distributed.COLLECTIVES))
        # the multi-device steps no default path takes
        from savont_tpu_torch.io.fastx import read_fastx, read_fastx_records
        from savont_tpu_torch.pipeline.stage1_kmers import _batch_encode

        recs = read_fastx_records(str(work / "kmer_cell" / "reads.fq.gz"))
        codes, quals = _batch_encode([r.seq for r in recs], [r.qual for r in recs])
        distributed.reset_collectives()
        t0 = time.perf_counter()
        km, ct = mesh.split_kmer_count(codes, quals, KMER_KS[0], MIN_BQ, "cuda", group=True)
        out["count_s"] = time.perf_counter() - t0
        one_k, one_c = mesh.split_kmer_count(codes, quals, KMER_KS[0], MIN_BQ, "cuda")
        if not (np.array_equal(km, one_k) and np.array_equal(ct, one_c)):
            raise AssertionError("split_kmer_count over the ranks differs from the one-card count")
        out.update(distinct=len(km), count_collectives=dict(distributed.COLLECTIVES))
        queries = [r.seq for r in read_fastx(str(work / "mesh" / "final_asvs.fasta"))]
        refs = []
        for r in read_fastx(str(work / "db" / "emu" / "species_taxid.fasta")):
            refs.append(r.seq)
            if len(refs) == RANKS_CLASSIFY_REFS:
                break
        distributed.reset_collectives()
        t0 = time.perf_counter()
        nm, score = mesh.sharded_classify_nm(queries, refs, OPERON_BAND, "cuda")
        out["classify_nm_s"] = time.perf_counter() - t0
        np.savez(run / f"classify{rank}.npz", nm=nm, score=score)
        out["classify_collectives"] = dict(distributed.COLLECTIVES)
        distributed.shutdown()
    out.update(launches=dict(align_torch.LAUNCHES), sintax_launches=dict(sintax_torch.LAUNCHES),
               kmer_launches=dict(kmers_torch.LAUNCHES),
               plain_calls={**align_torch.REFERENCE_CALLS, **sintax_torch.REFERENCE_CALLS,
                            **kmers_torch.REFERENCE_CALLS})
    (run / f"out{rank}.json").write_text(json.dumps(out))
    if "jax" in sys.modules or "savont_tpu" in sys.modules:
        raise AssertionError("a rank imported jax or savont_tpu")
    return 0


def ranks_phase(work: Path, mp: dict, cls: dict) -> dict:
    """Phase 8: the port over ranks on the card, each run's outputs held to
    the pinned digests and its shares of the work to the one-rank run's
    (phases 5 and 6)."""
    import numpy as np
    import torch

    from savont_tpu_torch.parallel.mesh import sharded_classify_nm

    def held(tag: str, out: dict) -> None:
        if out["digests"] != DIGESTS:
            raise AssertionError(f"{tag}, rank {out['rank']}: asv outputs differ from the pinned "
                                 f"digests: {out['digests']}")
        for k in ("sw_forward_nm", "sw_forward_payload", "sw_walk"):
            if out["asv_launches"][k] <= 0:
                raise AssertionError(f"{tag}, rank {out['rank']}: kernel {k} was not launched by asv")
        if any(out["plain_calls"].values()) or any(v["fallbacks"] for v in out["routes"].values()):
            raise AssertionError(f"{tag}, rank {out['rank']}: plain versions {out['plain_calls']} "
                                 f"or fallbacks {out['routes']}")

    smi = nvidia_smi_line()
    runs: dict = {}
    # 1. one NCCL rank through the CLI, joined from the environment
    port = free_port()
    (one,) = start_ranks(work, "nccl_cli", 1, lambda r: {
        "SAVONT_COORDINATOR": f"127.0.0.1:{port}", "SAVONT_NUM_PROCESSES": "1",
        "SAVONT_PROCESS_ID": "0"})
    held("one NCCL rank", one)
    if {k: one["routes"][k]["jobs"] for k in ("stage4", "stage7")} != {
            k: mp["routes"][k]["jobs"] for k in ("stage4", "stage7")}:
        raise AssertionError(f"one NCCL rank ran other jobs than phase 5: {one['routes']}")
    col = one["asv_collectives"]
    if not (col.get("all_gather/nccl", {}).get("calls") and col.get("all_reduce/nccl", {}).get("calls")):
        raise AssertionError(f"one NCCL rank: stage 7's all_gather and stage 4's all_reduce did not "
                             f"run over NCCL: {col}")
    runs["nccl_1"] = one
    log(f"ranks: one NCCL rank through the CLI (SAVONT_COORDINATOR), asv {one['asv_s']:.2f} s "
        f"(process {one['process_s']:.2f} s), outputs equal DIGESTS; collectives {json.dumps(col)}")

    # 2. two ranks over gloo on the one card; 3. over NCCL, one card a rank
    worlds = [("gloo", RANKS)] + ([("nccl", torch.cuda.device_count())]
                                  if torch.cuda.device_count() >= 2 else [])
    one_rank_jobs = {k: mp["routes"][k]["jobs"] for k in ("stage4", "stage7")}
    one_rank_refs = cls["sintax"]["sintax"]["refs"]
    want_sintax = {name: DIGESTS_CLASSIFICATION[f"sintax/{name}"]
                   for name in ("genus_abundance.tsv", "asv_mappings.tsv")}
    queries = refs = None
    for job, world in worlds:
        outs = start_ranks(work, job, world)
        for out in outs:
            held(f"{world} ranks over {job}", out)
            if out["sintax_digests"] != want_sintax:
                raise AssertionError(f"{job}, rank {out['rank']}: sintax outputs differ from the "
                                     f"pinned digests: {out['sintax_digests']}")
            if out["sintax_launches"]["sintax_scores"] <= 0 or out["kmer_launches"]["split_kmers"] <= 0:
                raise AssertionError(f"{job}, rank {out['rank']}: kernels 3 / 4 not launched")
        shares = {k: [o["routes"][k]["jobs"] for o in outs] for k in one_rank_jobs}
        shares["sintax_refs"] = [o["sintax_refs"] for o in outs]
        for k, want in {**one_rank_jobs, "sintax_refs": one_rank_refs}.items():
            if sum(shares[k]) != want or min(shares[k]) <= 0:
                raise AssertionError(f"{job}: {k} shares {shares[k]} do not add up to the one-rank "
                                     f"run's {want}, or a rank did none")
        if max(shares["sintax_refs"]) > 0.6 * one_rank_refs:
            raise AssertionError(f"{job}: the references are not split evenly: {shares['sintax_refs']}")
        if queries is None:
            from savont_tpu_torch.io.fastx import read_fastx

            queries = [r.seq for r in read_fastx(str(work / "mesh" / "final_asvs.fasta"))]
            refs = [r.seq for _, r in zip(range(RANKS_CLASSIFY_REFS), read_fastx(
                str(work / "db" / "emu" / "species_taxid.fasta")))]
            nm1, score1 = sharded_classify_nm(queries, refs, OPERON_BAND, "cuda")
            if not (nm1 >= 0).any():
                raise AssertionError("sharded_classify_nm: no pair aligned")
        for r in range(world):
            got = np.load(work / "ranks" / job / f"classify{r}.npz")
            if not (np.array_equal(got["nm"], nm1) and np.array_equal(got["score"], score1)):
                raise AssertionError(f"{job}, rank {r}: sharded_classify_nm differs from one rank's")
        runs[f"{job}_{world}"] = outs
        log(f"ranks: {world} ranks over {job}: asv {[round(o['asv_s'], 2) for o in outs]} s, sintax "
            f"{[round(o['sintax_s'], 2) for o in outs]} s, every output equal to the pinned digests; "
            f"shares {json.dumps(shares)} (one rank: {json.dumps(one_rank_jobs)}, {one_rank_refs} "
            f"references); stage-1 count over ranks == one card "
            f"({outs[0]['distinct']} k-mers); classify NM {len(queries)} x {len(refs)} == one rank")
    if len(worlds) == 1:
        log(f"ranks: {torch.cuda.device_count()} card: the NCCL run of one card a rank needs two")

    def summary(o: dict) -> dict:
        keep = ("asv_s", "sintax_s", "count_s", "classify_nm_s", "process_s", "sintax_refs",
                "asv_collectives", "sintax_collectives", "count_collectives", "classify_collectives")
        return {"rank": o["rank"], **{k: o[k] for k in keep if k in o},
                "jobs": {k: o["routes"][k]["jobs"] for k in ("stage4", "stage7")}}

    line = {"ranks": {"card": smi, "cards": torch.cuda.device_count(),
                      "note": "ranks sharing one card over gloo check correctness, not speed",
                      "runs": {k: [summary(o) for o in (v if isinstance(v, list) else [v])]
                               for k, v in runs.items()}}}
    log(json.dumps(line))
    return line


def ranks_alone(work: Path) -> dict:
    """Phase 8 alone, to iterate on it: what it takes from phases 5-7 made
    afresh in `work` (phase 5's reads through the CLI on the default routes,
    phase 6's database and its sintax, phase 7's kernel-cell reads), then the
    phase."""
    import numpy as np

    from savont_tpu_torch import cli
    from savont_tpu_torch.db.synth import build_emu_slice
    from savont_tpu_torch.ops.build import build_kernels
    from savont_tpu_torch.parallel.mesh import ROUTE_STATS, reset_route_stats
    from savont_tpu_torch.pipeline import sintax as sintax_mod

    build_kernels()
    write_reads(work / "reads.fq.gz", work / "templates.fa", main_path_rng())
    reset_route_stats()
    if cli.main(["--log-level", "warn", "asv", str(work / "reads.fq.gz"), "-o", str(work / "mesh"),
                 "--device", "cuda", "-t", "4"]) != 0:
        raise AssertionError("asv failed")
    mp = {"routes": {k: dict(v) for k, v in ROUTE_STATS.items()}}
    build_emu_slice(work / "templates.fa", work / "db", n_refs=DB_REFS, seed=DB_SEED, device="cuda")
    sintax_mod.SCORE_STATS["refs"] = 0
    if cli.main(["--log-level", "warn", "sintax", "-i", str(work / "mesh"), "-o",
                 str(work / "sintax"), "-d", str(work / "db" / "emu"), "--device", "cuda"]) != 0:
        raise AssertionError("sintax failed")
    cls = {"sintax": {"sintax": {"refs": sintax_mod.SCORE_STATS["refs"]}}}
    (work / "kmer_cell").mkdir()
    write_reads(work / "kmer_cell" / "reads.fq.gz", work / "kmer_cell" / "templates.fa",
                np.random.default_rng(KMER_SEED), N_KMER_READS)
    return ranks_phase(work, mp, cls)


def operon_alone(work: Path, int32_ops_per_s: float = 32.6e12) -> dict:
    """The operon phase alone, to iterate on it: the kernels built, then the
    phase in `work`, its bounds at `int32_ops_per_s` (phase 4 measures the
    rate; 32.6 T int32 ops/s is what it read on an H100 at 700 W)."""
    from savont_tpu_torch.ops.build import build_kernels

    build_kernels()
    return operon_phase(work, int32_ops_per_s)


def main() -> int:
    if not (ROOT / "savont_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repo "
              "(savont_tpu_torch/ beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    from savont_tpu_torch.ops.native_build import get_lib

    oracle = get_lib()
    if oracle is None:
        raise AssertionError("the host C++ oracle (savont_tpu_torch/native/swalign.cpp) did not build")
    log(f"host C++ oracle loaded: {oracle._name}")
    phase_done("phase 1")

    # phase 2: build
    from savont_tpu_torch.ops.build import BUILD_INFO, build_kernels

    t0 = time.perf_counter()
    build_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s ({BUILD_INFO['path']})")
    for line in BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 3: kernels against their plain versions and the host oracle
    import numpy as np

    from savont_tpu_torch.probes import roofline

    rng = np.random.default_rng(SEED)
    jobs = plan(make_pairs(rng, 48, 48), BAND)
    if len(jobs) < N_PAIRS_MIN or not any(max_jump(j) > 2 for j in jobs):
        raise AssertionError(f"job set too small or without band jumps > 2: {len(jobs)} pairs")
    res = check_kernels(jobs, BAND, time_plain=True)
    # band 128 on 16S-length templates (the operon preset's band; its read
    # lengths are the operon phase's)
    res_128 = check_kernels(plan(make_pairs(rng, 8, 32), OPERON_BAND), OPERON_BAND,
                            time_plain=False)
    phase_done("phase 3, kernels 1 and 2 at the planner's shapes")
    n_edge = check_edge_shapes()
    log(f"  edge shapes: {n_edge} cases, bands {EDGE_BANDS}: kernels 1 (both modes) and 2 == "
        f"plain, and kernel 2 alone on the window, alignment and maxrun edges")
    phase_done("phase 3, edge shapes")
    roof_err = roofline.check()
    if any(roof_err.values()):
        raise AssertionError(f"roofline kernels differ from their plain versions: {roof_err}")
    log(f"  roofline kernels == plain (exact, {roofline.CHECK_ITERS} iterations): {roof_err}")
    from savont_tpu_torch.probes import bitcast, i16ops, roll

    bc = bitcast.check()
    if bc["max_abs_err"] or not (bc["even_ok"] and bc["formula_a_ok"]) or bc["formula_b_ok"]:
        raise AssertionError(f"bitcast probe: expected exact, formula A right, B wrong: {bc}")
    probe_err = {"probe_bitcast": bc["max_abs_err"],
                 **{f"probe_i16_{k}": v for k, v in i16ops.check().items()},
                 **{f"probe_roll_{k}": v for k, v in roll.check().items()}}
    if any(probe_err.values()):
        raise AssertionError(f"probe kernels differ from their plain versions: {probe_err}")
    log(f"  probe kernels == plain (exact): {probe_err}; bitcast word roll is the roll by 2 "
        f"{bc['even_ok']}, formula A is the roll by 1 {bc['formula_a_ok']}, formula B "
        f"{bc['formula_b_ok']}; roll: every mode at k {roll.KS}, N {roll.CHECK_STEPS}, 1 and 3 tiles")

    phase_done("phase 3")
    # phase 4: the probes' timed runs
    roofline.reset_counters()
    roof = roofline.measure()
    roof_launches = dict(roofline.LAUNCHES)
    # the outputs of the timed launches, held to the plain version's too
    roof_err = {k: max(v, roof[k]["max_abs_err"]) for k, v in roof_err.items()}
    if any(roof_err.values()):
        raise AssertionError(f"roofline kernels differ from their plain versions at "
                             f"{roofline.PLAIN_ITERS} iterations: {roof_err}")
    for name, n in roof_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the probe: {roof_launches}")
    for k in roofline.KINDS:
        r = roof[k]
        log(f"  roofline {k}: card {r['card']['tops']:.3f} T ops/s "
            f"({r['card']['tvalues']:.3f} T values/s), one SM {r['one_sm']['tops']:.4f} T ops/s; "
            f"{roofline.PLAIN_ITERS} iterations: kernel {r['ms']:.4f} ms queued "
            f"({roofline.QUEUED_RUNS} launches), {r['single_ms']:.4f} ms single, plain "
            f"{r['plain_ms']:.1f} ms")
    log(f"roofline: int32 max/add {roof['int32_tops']:.3f} T ops/s measured, "
        f"{roof['published_dispatch_tops']:.3f} T instructions/s published dispatch rate "
        f"({roof['sms']} SMs x {roofline.DISPATCH_LANES_PER_SM} x max SM clock); "
        f"launches {roof_launches}")

    for mod in (bitcast, i16ops, roll):
        mod.reset_counters()
    bitcast_m = bitcast.measure()
    probe = {"probe_bitcast": bitcast_m["card"]}
    i16 = i16ops.measure()
    rl = roll.measure()
    probe.update({f"probe_i16_{k}": i16[k]["card"] for k in i16ops.OPS})
    # the roll modes at their best k, card-sized
    roll_k = {m: roll.best(rl, m)[0] for m in roll.MODES}
    probe.update({f"probe_roll_{m}": rl["card"][m][k] for m, k in roll_k.items()})
    probe_launches = {**bitcast.LAUNCHES, **i16ops.LAUNCHES, **roll.LAUNCHES}
    # the outputs of the timed launches (2,048 tiles; 66 tiles x 2,000 steps)
    # and of the one-tile ones, held to the plain version's too
    timed_err = {"probe_bitcast": max(r["max_abs_err"] for r in bitcast_m.values()),
                 **{f"probe_i16_{k}": max(i16[k][w]["max_abs_err"] for w in ("tile", "card"))
                    for k in i16ops.OPS},
                 **{f"probe_roll_{m}": max(rl[w][m][k]["max_abs_err"] for w in ("tile", "card")
                                           for k in roll.KS) for m in roll.MODES}}
    probe_err = {k: max(v, timed_err[k]) for k, v in probe_err.items()}
    if any(probe_err.values()):
        raise AssertionError(f"probe kernels differ from their plain versions at the timed "
                             f"shapes: {probe_err}")
    for name, n in probe_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by its probe: {probe_launches}")
    log(f"  bitcast: {json.dumps(probe['probe_bitcast'])}")
    for k in i16ops.OPS:
        log(f"  i16 {k}: chain {i16[k]['chain']['tops']:.3f} T ops/s "
            f"({i16[k]['chain']['tvalues']:.3f} T values/s); elementwise, {i16ops.CARD_TILES} tiles: "
            f"{json.dumps(i16[k]['card'])}; one tile {i16[k]['tile']['ms']:.4f} ms")
    # every step runs its instruction per element (the compiler merged none),
    # so no time stands under the bound
    for m in roll.MODES:
        for k in roll.KS:
            loop, r = rl["step_loops"][f"{m}_k{k}"], rl["card"][m][k]
            if loop["chain"] < roll.TRIP_STEPS * k or r["ms"] < r["bound_ms"]:
                raise AssertionError(
                    f"roll {m}, k={k}: {loop['chain']} chain instructions a trip of "
                    f"{roll.TRIP_STEPS} steps of {k} elements, {r['ms']:.4f} ms queued against a "
                    f"{r['bound_ms']:.4f} ms bound")
    for where in ("tile", "card"):
        for k in roll.KS:
            log(f"  roll, {roll.STEPS} steps, {where}, k={k}: " + "; ".join(
                f"{m} {r['us_per_step']:.5f} us/step ({r['ms']:.4f} ms queued, {r['single_ms']:.4f} "
                f"ms single; floors: shuffle {r['shfl_floor_ms']:.4f}, shared memory "
                f"{r['smem_floor_ms']:.4f}, issue {r['issue_floor_ms']:.4f} ms at "
                f"{r['trip_instructions']} instructions a trip, {r['trip_chain']} of the chain)"
                for m, r in ((m, rl[where][m][k]) for m in roll.MODES))
                + "; roll over add: " + ", ".join(
                f"{m} {rl[where][m][k]['roll_cost_us']:.5f} us" for m in roll.MODES[1:]))
        add = rl[where]["add"][roll.KS[-1]]
        log(f"  roll, {where}: bound {add['bound_ms']:.4f} ms ({add['bound_by']}); best k "
            f"{roll_k}; torch.add(x, N), the closed form of add (it skips the steps), "
            f"{add['library_ms']:.4f} ms queued, {add['single_library_ms']:.4f} ms single; "
            f"torch.roll alone (no single call computes roll + N) {rl[where]['torch_roll_ms']:.4f} ms")
    log(f"  roll step loops (SASS): {json.dumps(rl['step_loops'])}")

    phase_done("phase 4")
    # phase 5: the main path; phase 6: classification, on its outputs
    work = Path(tempfile.mkdtemp(prefix="savont_chip_smoke_"))
    try:
        mp = main_path(work, rng)
        phase_done("phase 5")
        cls = classification(work, roof["int32_tops"] * 1e12)
        phase_done("phase 6")
        km = stage1_kmers_phase(work, roof["int32_tops"] * 1e12)
        phase_done("phase 7")
        op = operon_phase(work, roof["int32_tops"] * 1e12)
        phase_done("phase operon")
        sc = scale_phase(work, roof["int32_tops"] * 1e12)
        phase_done("phase scale")
        ranks_phase(work, mp, cls)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase_done("phase 8")
    bounds = sw_bounds(res["shape"], roof["int32_tops"] * 1e12)
    kernels = []
    for name, (src, rep) in KERNELS.items():
        if name.startswith("roofline_"):
            r = roof[name.removeprefix("roofline_")]
            entry = {"launches": roof_launches[name], "max_abs_err": roof_err[name.removeprefix("roofline_")],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"]}
        elif name.startswith("probe_"):
            r = probe[name]
            entry = {"launches": probe_launches[name], "max_abs_err": probe_err[name],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            if name.startswith("probe_roll_"):
                mode = name.removeprefix("probe_roll_")
                entry.update(k=roll_k[mode], ms_by_k={k: rl["card"][mode][k]["ms"] for k in roll.KS})
        elif name == "sintax_scores":
            # the route's shape (phase 5's ASVs) in the row, every shape beside it
            k3 = cls["sintax_kernel"]
            entry = {"launches": cls["sintax"]["sintax_launches"]["sintax_scores"],
                     **{k: k3["mesh"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "single_ms")},
                     "shapes": k3,
                     "scale": {"launches": sc["classification"]["sintax"]["sintax_launches"][name],
                               **sc[name]}}
        elif name == "sintax_ref_kmers":
            # the classification database's first chunk; launches: phase 6's
            # sintax run, and the scale run's beside them
            r = cls[name]
            entry = {"launches": cls["sintax"]["sintax_launches"][name],
                     **{k: r[k] for k in ("max_abs_err", "ms", "single_ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "shape")},
                     "scale": {"launches": sc["classification"]["sintax"]["sintax_launches"][name]}}
        elif name in ("split_kmers", "syncmers"):
            # launches: the asv --stage1-backend mesh run's, 0 for kernel 5,
            # which is on no path (as in the JAX package); the kernel cell's
            # one untimed call beside them.  No single PyTorch call computes
            # either; kernel 4's entry carries the count's sort beside it
            r = km["cell"][name]
            entry = {"launches": km["asv_launches"][name],
                     "cell_launches": km["cell"]["launches"][name],
                     **{k: r[k] for k in ("max_abs_err", "ms", "single_ms", "plain_ms", "bound_ms",
                                          "bound_by")}}
            if name == "split_kmers":
                entry.update({k: km["cell"][k] for k in ("compact_ms", "sort_ms", "sort_count_ms")})
        else:
            # the main path's shapes in the row; the operon phase's beside
            # them, with the launches of its timed run
            entry = {"launches": mp["launches"][name], "max_abs_err": res[name]["max_abs_err"],
                     "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
                     "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
                     "operon": {"launches": op["runs"]["mesh"]["launches"][name],
                                **{k: op["kernels"][name][k]
                                   for k in ("max_abs_err", "ms", "single_ms", "plain_ms",
                                             "bound_ms", "bound_by")},
                                "shape": op["kernels"]["shape"]}}
            if name == "sw_forward_nm":
                # the scale phase's full stage-7 launch, with the launches
                # of its default-route run
                entry["scale"] = {"launches": sc["runs"]["asv"]["launches"][name], **sc[name]}
        # no single PyTorch call computes a banded Smith-Waterman, its
        # traceback walk, or a dependent max/add chain; the probes time the
        # one call that computes their function where there is one
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "library_ms": None, **entry})
    log("kernel 1 (NM) at the classify cell: " + json.dumps(cls["classify_nm"]))
    log("sw_walk: " + json.dumps({k: v for k, v in res["sw_walk"].items() if k != "max_abs_err"}))
    log(f"bounds: {json.dumps(bounds)} (ops per cell {OPS_PER_CELL}, int32 rate "
        f"{roof['int32_tops']:.3f} T ops/s, {HBM_BYTES_PER_S / 1e12} TB/s)")
    bounds_128 = sw_bounds(res_128["shape"], roof["int32_tops"] * 1e12)
    log("band 128 on 1,450-bp templates: " + json.dumps({
        name: {**{k: v for k, v in res_128[name].items() if k.endswith("_ms") or k == "ms"}, **b}
        for name, b in bounds_128.items()}) + f" at {json.dumps(res_128['shape'])}")
    log("kernels 1 and 2 at operon shapes: " + json.dumps(op["kernels"]))
    log("kernels 1 (NM) and 3 at the scale phase's shapes: " + json.dumps(
        {name: sc[name] for name in ("sw_forward_nm", "sintax_scores")}))
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5])))
    sys.exit(main())
