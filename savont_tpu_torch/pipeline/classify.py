"""`classify` subcommand: align ASVs to a reference database, EM over
tax_ids, Yarza-threshold rank assignment (classify.rs).

The reference maps each ASV against a minimap2 index of the whole DB; here
a minimizer hit-count prefilter selects candidate references per ASV and
the classify route aligns every (ASV, candidate) pair of the run in one
call on the chosen device (ops/align_batch.align_pairs_nm_indexed: kernel 1
in NM mode over every pair, kernels 1 + 2 for the starts of the written
hits).  The DB minimizer table is a flat sorted (hash, id) array, cached
next to the DB FASTA under the JAX package's name and arrays, so either
package reads the other's cache.
"""
from __future__ import annotations

import logging
import math
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..config import ClassifyArgs
from ..constants import ASV_FILE, CLASSIFY_EM_MAX_ITERATIONS
from ..db import taxonomy as tax
from ..io.fastx import read_fastx
from ..ops.align import _window_minimizers, ascii_to_align_codes
from ..ops.align_batch import align_pairs_nm_indexed
from ..ops.em import em_abundances, groups_to_rows
from ..ops.encode import U64

log = logging.getLogger("savont")

# Candidate selection has NO cardinality cap (the reference aligns every ASV
# against the whole DB and keeps ALL min-NM ties, classify.rs:152-189; a
# top-K cap could silently drop a tie in SILVA-scale DBs with thousands of
# near-identical refs).  Instead refs are kept by minimizer hit count
# relative to the best candidate: any ref tying at min NM has near-equal
# identity to the query, so its shared-minimizer count is close to the
# best's.  The fraction floor is deliberately LOW (0.1) — a ref sharing
# well under half the best's minimizers can still tie at min NM when the
# best's extra hits sit in a conserved block — and MIN_CAND_HITS mirrors
# minimap2's map-ont min chain count (the reference's whole-DB mapping is
# itself seed-gated: a ref with <3 shared seeds gets no minimap2 hit
# either).  Dropped-by-floor counts are logged; no silent caps.
MIN_CAND_HITS = 3
CAND_HIT_FRACTION = 0.1
# classify's band: the one a fresh `python -m savont_tpu classify` process
# aligns at (ops/align.DEFAULT_BAND before any asv run narrows it), passed
# explicitly so that an asv run earlier in the same process cannot change it
CLASSIFY_BAND = 128
# wall seconds of the last classify call by part: the DB FASTA read, the
# minimizer table (built, or loaded from its cache), the candidates, the
# classify route (align_batch.CLASSIFY_STATS splits it further), the EM
# with the rank assignment, and the writers
CLASSIFY_SECONDS = {"load": 0.0, "table": 0.0, "candidates": 0.0, "route": 0.0, "em": 0.0,
                    "write": 0.0}


class DbMinimizerTable:
    """Flat sorted minimizer table over database sequences."""

    def __init__(self, seqs: list[bytes], w: int = 10, k: int = 15):
        from ..ops.align import _window_minimizers_numpy
        from ..ops.kmers_native import get_scan_lib, window_minimizers_native

        self.w, self.k = w, k
        # one native batch scan over the whole DB (a SILVA-scale DB is
        # 100k+ refs; per-ref calls were 100k+ ctypes round trips).
        # Deliberately uncached: DB refs are one-shot here and would evict
        # the read-minimizer working set.
        codes = [ascii_to_align_codes(s) for s in seqs]
        if codes and get_scan_lib() is not None:
            per_ref = window_minimizers_native(codes, k, w)
        else:
            per_ref = [_window_minimizers_numpy(c, w, k) for c in codes]
        hashes = [m[0] for m in per_ref]
        ids = [np.full(len(m[0]), i, dtype=np.int32) for i, m in enumerate(per_ref)]
        self.hashes = np.concatenate(hashes) if hashes else np.zeros(0, U64)
        self.ids = np.concatenate(ids) if ids else np.zeros(0, np.int32)
        order = np.argsort(self.hashes, kind="stable")
        self.hashes = self.hashes[order]
        self.ids = self.ids[order]

    def candidates(self, query: bytes) -> tuple[np.ndarray, int]:
        """All refs with minimizer hit count >= max(MIN_CAND_HITS,
        CAND_HIT_FRACTION * best), best-first; second value is how many
        hit refs were dropped by the floor (logged — no silent caps)."""
        h, _, _ = _window_minimizers(ascii_to_align_codes(query), self.w, self.k)
        if len(h) == 0 or len(self.hashes) == 0:
            return np.zeros(0, np.int32), 0
        left = np.searchsorted(self.hashes, h, side="left")
        right = np.searchsorted(self.hashes, h, side="right")
        hit_ids = np.concatenate([self.ids[l:r] for l, r in zip(left, right)]) if len(h) else np.zeros(0, np.int32)
        if len(hit_ids) == 0:
            return hit_ids, 0
        uniq, cnt = np.unique(hit_ids, return_counts=True)
        best = int(cnt.max())
        floor = max(MIN_CAND_HITS, math.ceil(best * CAND_HIT_FRACTION))
        keep = cnt >= floor
        if not keep.any():  # low-complexity query: keep the best-count refs
            keep = cnt == best
        order = np.argsort(-cnt[keep], kind="stable")
        return uniq[keep][order], int((~keep).sum())


def _load_or_build_table(fasta_path, seqs: list[bytes]) -> DbMinimizerTable:
    """Disk-cached DB minimizer table (<fasta>.savont_idx.npz)."""
    import os

    cache = str(fasta_path) + ".savont_idx.npz"
    try:
        if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(fasta_path):
            data = np.load(cache)
            t = DbMinimizerTable.__new__(DbMinimizerTable)
            t.w, t.k = int(data["w"]), int(data["k"])
            t.hashes, t.ids = data["hashes"], data["ids"]
            log.info("Loaded cached DB minimizer table: %s", cache)
            return t
    except Exception as e:  # noqa: BLE001 - corrupt cache -> rebuild
        log.warning("DB index cache unreadable (%s); rebuilding", e)
    t = DbMinimizerTable(seqs)
    try:
        np.savez(cache, w=t.w, k=t.k, hashes=t.hashes, ids=t.ids)
        log.info("Cached DB minimizer table to %s", cache)
    except OSError:
        pass  # read-only DB dir: skip caching
    return t


def run_em_algorithm(
    mappings: list[tuple[int, int, int]],  # (asv_idx, tax_index, depth)
    num_taxa: int,
    total_reads: int,
    convergence_threshold: float,
) -> np.ndarray:
    """EM over unique tax_ids weighted by ASV depth (classify.rs:24-117).

    Vectorized bincount form (ops/em.py).  Each ASV is a group; its mapped
    tax indices are the members.  Per-member depths within a group are
    identical in practice (one depth per ASV), matching the reference's
    per-ASV weighting — asserted below so a future change can't silently
    alter semantics."""
    by_asv: dict[int, list[tuple[int, int]]] = defaultdict(list)
    for asv_idx, tax_idx, depth in mappings:
        by_asv[asv_idx].append((tax_idx, depth))
    for maps in by_asv.values():
        assert len({d for _, d in maps}) <= 1, "per-ASV depths must agree"
    gids, iids, weights = groups_to_rows(
        ([t for t, _ in maps], maps[0][1]) for maps in by_asv.values()
    )
    abund = em_abundances(
        gids, iids, weights, num_taxa, float(total_reads), convergence_threshold, CLASSIFY_EM_MAX_ITERATIONS
    )
    abund[abund < convergence_threshold] = 0.0  # min-abundance zeroing
    return abund


def read_feature_table(ft_path: Path, headers: list[str]):
    """classify.rs:196-227 — (sample_names, per-ASV per-sample depths)."""
    if not ft_path.exists():
        return None
    lines = ft_path.read_text().splitlines()
    header_line = next((l for l in lines if l.startswith("#OTU ID")), None)
    if header_line is None:
        return None
    sample_names = header_line.split("\t")[1:]
    if not sample_names:
        return None
    n = len(sample_names)
    otu: dict[str, list[int]] = {}
    for line in lines:
        if not line or line.startswith("#"):
            continue
        fields = line.split("\t")
        depths = []
        for i in range(1, n + 1):
            try:
                depths.append(int(fields[i]))
            except (IndexError, ValueError):
                depths.append(0)
        otu[fields[0]] = depths
    per_asv = []
    for h in headers:
        token = h.lstrip(">").split()[0] if h.split() else ""
        per_asv.append(otu.get(token, [0] * n))
    return sample_names, per_asv


def _write_pooled(classifications, per_asv, sample_names, path, genus_level: bool) -> None:
    """Wide per-sample abundance tables (classify.rs:230-325)."""
    n = len(sample_names)
    totals = [sum(s[k] for s in per_asv) for k in range(n)]
    agg: dict[str, tuple[tax.TaxonomyAssignment, list[float]]] = {}
    for c in classifications:
        if c.taxonomy is None:
            continue
        t = c.taxonomy
        if genus_level:
            key = "|".join([t.genus, t.family, t.order, t.class_, t.phylum, t.clade])
        else:
            key = "|".join([t.species, t.genus, t.family, t.order, t.class_, t.phylum, t.clade, t.superkingdom])
        try:
            asv_idx = int(c.asv_id.replace("ASV_", ""))
        except ValueError:
            asv_idx = 0
        entry = agg.setdefault(key, (t, [0.0] * n))
        for k in range(n):
            d = per_asv[asv_idx][k] if asv_idx < len(per_asv) else 0
            if totals[k] > 0:
                entry[1][k] += d / totals[k]
    rows = sorted(agg.values(), key=lambda x: -sum(x[1]))
    with open(path, "w") as f:
        if genus_level:
            f.write("genus\tfamily\torder\tclass\tphylum\tclade\tsuperkingdom")
        else:
            f.write("species\tgenus\tfamily\torder\tclass\tphylum\tclade\tsuperkingdom")
        for s in sample_names:
            f.write(f"\t{s}")
        f.write("\n")
        for t, ab in rows:
            if genus_level:
                f.write(f"{t.genus}\t{t.family}\t{t.order}\t{t.class_}\t{t.phylum}\t{t.clade}\t{t.superkingdom}")
            else:
                f.write(f"{t.species}\t{t.genus}\t{t.family}\t{t.order}\t{t.class_}\t{t.phylum}\t{t.clade}\t{t.superkingdom}")
            for a in ab:
                f.write(f"\t{a:.6f}")
            f.write("\n")


def candidate_pairs(table: DbMinimizerTable, seqs: list[bytes]):
    """What classify aligns: per ASV its candidate references, how many hit
    references the prefilter's floor dropped in all, and every (ASV,
    candidate) pair as indices qi into seqs and ti into uref, the sorted
    distinct candidates."""
    cand_lists = []
    total_dropped = 0
    for seq in seqs:
        cands, dropped = table.candidates(seq)
        total_dropped += dropped
        cand_lists.append(cands)
    qi = np.repeat(np.arange(len(seqs), dtype=np.int64),
                   [len(c) for c in cand_lists]).astype(np.int64)
    ci = np.concatenate(cand_lists).astype(np.int64) if cand_lists else np.zeros(0, np.int64)
    uref, ti = np.unique(ci, return_inverse=True)
    return cand_lists, total_dropped, qi, uref, ti


def classify(args: ClassifyArgs, db: tax.Database) -> None:
    input_fasta = Path(args.input_dir) / ASV_FILE
    if not input_fasta.exists():
        raise SystemExit(f"Input FASTA not found: {input_fasta}")

    asvs = [(f">{r.id}", r.seq.upper()) for r in read_fastx(str(input_fasta))]
    log.info("Loaded %d consensus sequences", len(asvs))

    ft = read_feature_table(Path(args.input_dir) / "feature-table.tsv", [h for h, _ in asvs])
    if ft is None:
        depths = tax.extract_depths_from_headers([h for h, _ in asvs])
        sample_names, per_asv = ["sample"], [[d] for d in depths]
    else:
        sample_names, per_asv = ft
    asv_depths = [sum(s) for s in per_asv]
    total_reads = sum(asv_depths)

    # DB load + prefilter + batched alignment.  The minimizer table is
    # cached next to the DB FASTA (the reference caches a .mmi minimap2
    # index the same way, classify.rs:127-145).
    secs = CLASSIFY_SECONDS
    t = time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t
        now = time.perf_counter()
        secs[part] = now - t
        t = now

    db_records = [(r.id, r.seq.upper()) for r in read_fastx(str(db.fasta_path))]
    log.info("Loaded %d database sequences", len(db_records))
    lap("load")
    table = _load_or_build_table(db.fasta_path, [s for _, s in db_records])
    lap("table")

    # candidates per ASV, then every (ASV, candidate) pair in one call of
    # the classify route; the pairs are independent, so this equals one call
    # per ASV
    cand_lists, total_dropped, qi, uref, ti = candidate_pairs(table, [s for _, s in asvs])
    lap("candidates")
    results = align_pairs_nm_indexed(
        [seq for _, seq in asvs], [db_records[c][1] for c in uref.tolist()], qi, ti,
        CLASSIFY_BAND, device=args.device, groups=qi,
    )
    lap("route")

    # (asv_idx, tax_key, identity, nm, depth, asv_header, ref_header)
    all_mappings: list[tuple] = []
    off = 0
    for asv_idx, (header, _seq) in enumerate(asvs):
        cands = cand_lists[asv_idx]
        res = results[off : off + len(cands)]
        off += len(cands)
        hits = [(int(c), m) for c, m in zip(cands, res) if m is not None]
        if not hits:
            continue
        hits.sort(key=lambda x: -x[1].score)
        min_nm = hits[0][1].nm
        asv_header = header.lstrip(">")
        for c, m in hits:
            if m.nm != min_nm:
                continue
            alen = m.query_end - m.query_start
            identity = 100.0 * (1.0 - m.nm / alen) if alen > 0 else 0.0
            key = db.extract_key(db_records[c][0])
            if key is not None and key in db.taxonomy:
                all_mappings.append((asv_idx, key, identity, m.nm, asv_depths[asv_idx], asv_header, db_records[c][0]))

    log.info(
        "Collected %d mappings from %d ASVs (%d low-hit refs below the candidate floor)",
        len(all_mappings), len(asvs), total_dropped,
    )

    tax_to_idx: dict[str, int] = {}
    for _, key, *_ in all_mappings:
        if key not in tax_to_idx:
            tax_to_idx[key] = len(tax_to_idx)
    idx_to_tax = [k for k, _ in sorted(tax_to_idx.items(), key=lambda x: x[1])]

    em_mappings = [(m[0], tax_to_idx[m[1]], m[4]) for m in all_mappings]
    conv = 0.1 / total_reads if total_reads else 0.1
    abund = run_em_algorithm(em_mappings, max(len(idx_to_tax), 1), max(total_reads, 1), conv)

    classifications: list[tax.AsvClassification] = []
    secondary: list[tax.AsvClassification] = []
    for asv_idx, (header, _) in enumerate(asvs):
        asv_id = f"ASV_{asv_idx}"
        asv_header = header.lstrip(">").split()[0]
        my = [m for m in all_mappings if m[0] == asv_idx]
        if my:
            for m in sorted(my, key=lambda m: -abund[tax_to_idx[m[1]]]):
                entry = db.taxonomy[m[1]]
                ta = tax.assign_taxonomy(entry, m[2], args.species_threshold, args.genus_threshold, asv_header, args.detailed_unclassified)
                secondary.append(
                    tax.AsvClassification(
                        asv_id=asv_id, asv_header=asv_header,
                        abundance=asv_depths[asv_idx] / total_reads if total_reads else 0.0,
                        best_hit_tax_id=m[1], identity=m[2], nm=m[3], taxonomy=ta,
                        hit_reference_id=m[6],
                    )
                )
            best = max(my, key=lambda m: abund[tax_to_idx[m[1]]])
            entry = db.taxonomy[best[1]]
            ta = tax.assign_taxonomy(entry, best[2], args.species_threshold, args.genus_threshold, asv_header, args.detailed_unclassified)
            classifications.append(
                tax.AsvClassification(
                    asv_id=asv_id, asv_header=asv_header,
                    abundance=asv_depths[asv_idx] / total_reads if total_reads else 0.0,
                    best_hit_tax_id=best[1], identity=best[2], nm=best[3], taxonomy=ta,
                    hit_reference_id=best[6],
                )
            )
        else:
            classifications.append(
                tax.AsvClassification(
                    asv_id=asv_id, asv_header=asv_header,
                    abundance=asv_depths[asv_idx] / total_reads if total_reads else 0.0,
                )
            )

    classifications.sort(key=lambda c: -c.abundance)
    lap("em")
    out_dir = Path(args.output_dir) if args.output_dir else Path(args.input_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if len(sample_names) > 1:
        _write_pooled(classifications, per_asv, sample_names, out_dir / "species_abundance.tsv", genus_level=False)
        _write_pooled(classifications, per_asv, sample_names, out_dir / "genus_abundance.tsv", genus_level=True)
    else:
        tax.write_species_abundance(classifications, out_dir / "species_abundance.tsv")
        tax.write_genus_abundance(classifications, out_dir / "genus_abundance.tsv")
    tax.write_asv_mappings(secondary, out_dir / "asv_mappings.tsv")
    lap("write")
    n_cls = sum(1 for c in classifications if c.taxonomy is not None)
    log.info("Classification complete: %d/%d ASVs classified", n_cls, len(classifications))
