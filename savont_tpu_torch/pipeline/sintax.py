"""`sintax` subcommand: k-mer bootstrap genus-level classification
(sintax.rs).  Phase 2, the scores of every (ASV, iteration) pair against
every reference, runs on the chosen device through kernel 3
(ops/sintax_torch.py): the references stream in chunks of rows, the keys
are max'ed on the device and fetched once; over the ranks of a process
group (parallel/distributed.py) each rank takes its share of the references
and one all_reduce joins the keys.  _host_scores, the host stream of the
reference, is kept as the test oracle."""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..config import SintaxArgs
from ..constants import ASV_FILE, SINTAX_K, SINTAX_SUBSAMPLE
from ..db import taxonomy as tax
from ..device import resolve_device
from ..io.fastx import read_fastx
from ..parallel import distributed
from ..ops.align_torch import events_ms, kernel_events
from ..ops.sintax_torch import (
    index_on, keys_int64, query_index, ragged_rows, sintax_scores_rows,
)
from ..tracing import Laps, span

log = logging.getLogger("savont")

CHUNK_ROWS = 4096  # references per launch of kernel 3
ORDINAL_MAX = 0x3FFFFFF  # the largest ordinal a key holds (its low 26 bits)
# the device scores' counters: calls, kept references scored on this rank
# (those with k-mers), wall seconds inside, and of them in the host's k-mer
# extraction of the references (kmers_s, a span "sintax:extract" a chunk of
# CHUNK_ROWS references: the FASTA stream, key and taxonomy lookups,
# parse_s; extract_kmers and np.unique, extract_s) and in the chunks'
# flushes (flush_s, span "sintax:flush": ragged rows, uploads, kernel-3
# launches), and device milliseconds of the launches (CUDA events read
# after the one fetch; 0.0 on the CPU)
SCORE_STATS = {"calls": 0, "refs": 0, "seconds": 0.0, "kmers_s": 0.0, "parse_s": 0.0,
               "extract_s": 0.0, "flush_s": 0.0, "kernel_ms": 0.0}

QUERY_SENTINEL = np.uint32(0xFFFFFFFE)
_BYTE_CODE = np.zeros(256, dtype=np.uint32)
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"TtUu", 3)):
    for _ch in _b:
        _BYTE_CODE[_ch] = _c


def extract_kmers(seq: bytes, k: int = SINTAX_K) -> np.ndarray:
    """Canonical k-mers as u32 (sintax.rs:37-55), vectorized."""
    codes = _BYTE_CODE[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    f = np.zeros(n, dtype=np.uint32)
    r = np.zeros(n, dtype=np.uint32)
    for j in range(k):
        f |= codes[j : j + n] << np.uint32(2 * (k - 1 - j))
        r |= (np.uint32(3) - codes[j : j + n]) << np.uint32(2 * j)
    return np.minimum(f, r)


class Xorshift:
    """Exact replica of the reference's deterministic RNG (sintax.rs:18-33)."""

    def __init__(self, seed: int):
        self.s = max(seed, 1) & 0xFFFFFFFFFFFFFFFF

    def next(self) -> int:
        s = self.s
        s ^= (s << 13) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 7
        s ^= (s << 17) & 0xFFFFFFFFFFFFFFFF
        self.s = s
        return s

    def next_usize(self, n: int) -> int:
        return self.next() % n


def query_matrix(seqs: list[bytes], n_iter: int) -> np.ndarray:
    """Phase 1: 32 k-mers per (ASV, iteration) pair subsampled with the
    seeded xorshift, in a dense (len(seqs) * n_iter, 32) uint32 matrix.
    Rows of k-mer-less ASVs hold the QUERY_SENTINEL (k=12 k-mers are below
    2^24, so it never matches)."""
    subs = np.full((len(seqs) * n_iter, SINTAX_SUBSAMPLE), QUERY_SENTINEL, dtype=np.uint32)
    for asv_i, seq in enumerate(seqs):
        kmers = extract_kmers(seq)
        if len(kmers) == 0:
            continue
        for iter_j in range(n_iter):
            rng = Xorshift(asv_i * n_iter + iter_j + 1)
            row = subs[asv_i * n_iter + iter_j]
            for s in range(SINTAX_SUBSAMPLE):
                row[s] = kmers[rng.next_usize(len(kmers))]
    return subs


def _host_scores(subs: np.ndarray, sentinel: np.uint32, db: tax.Database, n_pairs: int):
    """Phase 2 as the reference's host stream computes it, kept as the test
    oracle of _device_scores: stream the database once; per ref, dedup k-mers,
    bump (asv, iter) hit counts, keep the argmax ref's taxonomy per pair
    (strictly greater — ties keep the earliest ref, sintax.rs:219-273).
    The query map is a CSR structure (query_index, which the device route
    uploads too) so per-ref scoring is pure vector ops (real DBs have
    10^5-10^6 references)."""
    query_keys_sorted, csr_off, csr_pairs = query_index(subs, sentinel)

    best_scores = np.zeros(n_pairs, dtype=np.int32)
    best_ref = np.full(n_pairs, -1, dtype=np.int64)
    ref_entries: list[tax.TaxonomyEntry] = []
    n_refs = 0
    for rec in read_fastx(str(db.fasta_path)):
        n_refs += 1
        key = db.extract_key(rec.id)
        if key is None:
            continue
        entry = db.taxonomy.get(key)
        if entry is None:
            continue
        ref_kmers = np.unique(extract_kmers(rec.seq.upper()))
        if len(ref_kmers) == 0:
            continue
        pos = np.searchsorted(query_keys_sorted, ref_kmers)
        pos = np.minimum(pos, max(len(query_keys_sorted) - 1, 0))
        hit = query_keys_sorted[pos] == ref_kmers if len(query_keys_sorted) else np.zeros(0, bool)
        key_idx = pos[hit]
        if len(key_idx) == 0:
            continue
        # expand CSR ranges -> flat pair indices; count hits per pair
        lens = csr_off[key_idx + 1] - csr_off[key_idx]
        total = int(lens.sum())
        if total == 0:
            continue
        starts = np.repeat(csr_off[key_idx], lens)
        within = np.arange(total) - np.repeat(np.concatenate(([0], np.cumsum(lens)[:-1])), lens)
        pair_hits = csr_pairs[starts + within]
        counts = np.bincount(pair_hits, minlength=n_pairs).astype(np.int32)
        better = counts > best_scores
        if better.any():
            ref_entries.append(entry)
            best_scores = np.where(better, counts, best_scores)
            best_ref = np.where(better, len(ref_entries) - 1, best_ref)
        if n_refs % 10000 == 0:
            log.info("Processed %d reference sequences...", n_refs)
    best_tax: list[tax.TaxonomyEntry | None] = [
        ref_entries[r] if r >= 0 else None for r in best_ref
    ]
    return best_scores, best_tax


def _device_scores(subs: np.ndarray, db: tax.Database, n_pairs: int, device):
    """Phase 2 on `device`: the query index is built once and uploaded
    once; the references stream once, in chunks of CHUNK_ROWS rows of their
    sorted unique k-mers (back to back, no padding), through kernel 3, which
    max's each pair's packed key (score, earliest reference by record
    index) into one accumulator on the device; one fetch at the end.  Under
    a process group each rank extracts and scores every world-th record and
    the ranks' keys are max'ed with one all_reduce before the fetch (the
    reference's pmax over its mesh).  Equal to the host stream
    (_host_scores) and to the JAX package's mesh step, bit for bit."""
    stats = SCORE_STATS
    stats["calls"] += 1
    with span(None, stats, "seconds"):
        with kernel_events() as events:
            out = _scores_on(subs, db, n_pairs, resolve_device(device), stats)
        stats["kernel_ms"] += events_ms(events)  # after the one fetch: no wait
    return out


def _scores_on(subs, db, n_pairs, dev, stats):
    index = index_on(*query_index(subs, QUERY_SENTINEL), n_pairs, dev)
    acc = torch.zeros(n_pairs, dtype=torch.int32, device=dev)
    # every kept reference's taxonomy entry, by its record index, which is
    # its ordinal in the keys: the same on every rank, and in stream order,
    # so the earliest reference still wins a tie
    entries: dict[int, tax.TaxonomyEntry] = {}
    pend_k: list[np.ndarray] = []
    pend_r: list[int] = []
    n_ranks, my_rank = distributed.world(), distributed.rank()

    def extract(records) -> None:
        """The next chunk's references into pend_k / pend_r: up to CHUNK_ROWS
        of them, or to the end of the stream."""
        lap = Laps(stats)
        for n, rec in records:
            if n > ORDINAL_MAX:
                raise ValueError(f"sintax: the database holds more than {ORDINAL_MAX + 1} "
                                 "records, the most a score key's ordinal field can tell apart")
            key = db.extract_key(rec.id)
            if key is None:
                continue
            entry = db.taxonomy.get(key)
            if entry is None:
                continue
            entries[n] = entry
            # the rank's references: every n_ranks-th record (all of them
            # without a process group)
            if n % n_ranks == my_rank:
                lap("parse_s")
                ref_kmers = np.unique(extract_kmers(rec.seq.upper()))
                lap("extract_s")
                if len(ref_kmers):
                    pend_k.append(ref_kmers)
                    pend_r.append(n)
            if (n + 1) % 10000 == 0:
                log.info("Processed %d reference sequences...", n + 1)
            if len(pend_k) == CHUNK_ROWS:
                break
        lap("parse_s")

    def flush():
        kmers, row_off = ragged_rows(pend_k)
        ridx = np.asarray(pend_r, dtype=np.int32)
        sintax_scores_rows(index, torch.from_numpy(kmers).to(dev), torch.from_numpy(row_off).to(dev),
                           torch.from_numpy(ridx).to(dev), acc)
        stats["refs"] += len(pend_k)
        pend_k.clear()
        pend_r.clear()

    records = enumerate(read_fastx(str(db.fasta_path)))
    while True:
        with span("sintax:extract", stats, "kmers_s"):
            extract(records)
        if not pend_k:
            break
        with span("sintax:flush", stats, "flush_s"):
            flush()

    # the keys are unsigned 32-bit patterns (a score of 32 sets bit 31), so
    # the ranks' maximum is taken on them widened to int64
    best_key = distributed.all_reduce_(keys_int64(acc), "max").cpu().numpy()  # the one fetch
    best_scores = (best_key >> 26).astype(np.int32)
    ordinal = ORDINAL_MAX - (best_key & ORDINAL_MAX)
    best_tax = [entries[int(o)] if k > 0 else None for k, o in zip(best_key, ordinal)]
    log.info("SINTAX scores on %s: %d of %d kept refs on this rank", dev, stats["refs"],
             len(entries))
    return best_scores, best_tax


def sintax(args: SintaxArgs, db: tax.Database) -> None:
    input_fasta = Path(args.input_dir) / ASV_FILE
    if not input_fasta.exists():
        raise SystemExit(f"Input FASTA not found: {input_fasta}")
    sequences = [(f">{r.id}", r.seq.upper()) for r in read_fastx(str(input_fasta))]
    if not sequences:
        log.warning("No sequences in %s", input_fasta)
        return
    n_asvs = len(sequences)
    n_iter = args.n_iter
    n_pairs = n_asvs * n_iter
    asv_depths = tax.extract_depths_from_headers([h for h, _ in sequences])
    total_reads = sum(asv_depths)

    log.info("Building SINTAX query map (%d ASVs x %d iterations)", n_asvs, n_iter)
    subs = query_matrix([seq for _, seq in sequences], n_iter)
    best_scores, best_tax = _device_scores(subs, db, n_pairs, args.device)
    # Phase 3: per-rank votes -> bootstrap fractions
    all_hits: list[dict | None] = []
    for asv_i in range(n_asvs):
        base = asv_i * n_iter
        votes = {r: {} for r in ("species", "genus", "family", "order", "class_", "phylum", "superkingdom")}
        classified = 0
        for j in range(n_iter):
            e = best_tax[base + j]
            if e is not None and best_scores[base + j] > 0:
                classified += 1
                for rank in votes:
                    v = getattr(e, rank)
                    votes[rank][v] = votes[rank].get(v, 0) + 1
        if classified == 0:
            all_hits.append(None)
            continue

        def top(rank):
            if not votes[rank]:
                return "", 0.0
            name, count = max(votes[rank].items(), key=lambda x: x[1])
            return name, count / n_iter

        header = sequences[asv_i][0].lstrip(">").split()[0]
        hit = {"asv_header": header, "depth": asv_depths[asv_i],
               "abundance": asv_depths[asv_i] / total_reads if total_reads else 0.0}
        for rank in votes:
            name, boot = top(rank)
            hit[rank] = name
            hit[rank + "_boot"] = boot
        all_hits.append(hit)

    # sort by abundance desc (None -> 0)
    order = sorted(range(n_asvs), key=lambda i: -(all_hits[i]["abundance"] if all_hits[i] else 0.0))
    all_hits = [all_hits[i] for i in order]
    seq_order = [sequences[i] for i in order]
    depth_order = [asv_depths[i] for i in order]

    def to_classification(i: int) -> tax.AsvClassification:
        h = all_hits[i]
        header = seq_order[i][0].lstrip(">").split()[0]
        if h is None:
            return tax.AsvClassification(
                asv_id=header, asv_header=header,
                abundance=depth_order[i] / max(total_reads, 1),
            )
        unc = f"UNCLASSIFIED-({h['asv_header']})" if args.detailed_unclassified else "UNCLASSIFIED"
        ap = lambda rank: h[rank] if h[rank + "_boot"] >= args.min_bootstrap else unc
        ta = tax.TaxonomyAssignment(
            species=unc,  # sintax is genus-level max
            genus=ap("genus"), family=ap("family"), order=ap("order"),
            class_=ap("class_"), phylum=ap("phylum"), superkingdom=ap("superkingdom"),
        )
        return tax.AsvClassification(
            asv_id=h["asv_header"], asv_header=h["asv_header"],
            abundance=h["abundance"], taxonomy=ta,
        )

    classifications = [to_classification(i) for i in range(n_asvs)]
    out_dir = Path(args.output_dir) if args.output_dir else Path(args.input_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tax.write_genus_abundance(classifications, out_dir / "genus_abundance.tsv")

    with open(out_dir / "asv_mappings.tsv", "w") as f:
        f.write(
            "asv_header\tdepth\tspecies_bootstrap\tgenus_bootstrap\tfamily_bootstrap\t"
            "order_bootstrap\tclass_bootstrap\tphylum_bootstrap\tsuperkingdom_bootstrap\t"
            "species\tgenus\tfamily\torder\tclass\tphylum\tsuperkingdom\n"
        )
        ranks = ["species", "genus", "family", "order", "class_", "phylum", "superkingdom"]
        for h in all_hits:
            if h is None:
                continue
            ap = lambda rank: h[rank] if h[rank + "_boot"] >= args.min_bootstrap else "UNCLASSIFIED"
            boots = "\t".join(f"{h[r + '_boot']:.3f}" for r in ranks)
            names = "\t".join(["UNCLASSIFIED"] + [ap(r) for r in ranks[1:]])
            f.write(f"{h['asv_header']}\t{h['depth']}\t{boots}\t{names}\n")

    classified = sum(1 for h in all_hits if h is not None)
    log.info("SINTAX complete: %d/%d ASVs classified", classified, n_asvs)
