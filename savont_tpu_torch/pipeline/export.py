"""`export` subcommand: QIIME2 export + multi-run dereplication (merge.rs)."""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..config import ExportArgs
from ..constants import ASV_FILE
from ..io.fastx import read_fastx
from ..ops.encode import revcomp_bytes

log = logging.getLogger("savont")

QIIME_ORDER = ["superkingdom", "phylum", "class", "order", "family", "genus", "species"]


def djb2_hash(seq: bytes) -> int:
    """merge.rs:11-17."""
    h = 5381
    for b in seq.upper():
        h = (h * 33 + b) & 0xFFFFFFFFFFFFFFFF
    return h


def seq_hash(seq: bytes) -> str:
    """RC-canonical djb2 hex key (merge.rs:19-24)."""
    fwd = djb2_hash(seq)
    rev = djb2_hash(revcomp_bytes(seq))
    return f"{min(fwd, rev):016x}"


def depth_from_header_total(header: str) -> int:
    """merge.rs:77-81."""
    first = header.split()[0] if header.split() else ""
    token = first.split("_")[-1] if first else "0"
    total = 0
    for s in token.split("-"):
        try:
            total += int(s)
        except ValueError:
            pass
    return total


def sample_name_from_dir(d: Path) -> str:
    ft = d / "feature-table.tsv"
    if ft.exists():
        for line in ft.read_text().splitlines():
            if line.startswith("#OTU ID"):
                fields = line.split("\t")
                if len(fields) > 1:
                    return fields[1]
    return d.name or "sample"


def feature_table_from_dir(d: Path):
    """merge.rs:47-75."""
    ft = d / "feature-table.tsv"
    if not ft.exists():
        return None
    lines = ft.read_text().splitlines()
    header_line = next((l for l in lines if l.startswith("#OTU ID")), None)
    if header_line is None:
        return None
    sample_names = header_line.split("\t")[1:]
    if not sample_names:
        return None
    n = len(sample_names)
    depths = {}
    for line in lines:
        if not line or line.startswith("#"):
            continue
        fields = line.split("\t")
        per = []
        for i in range(1, n + 1):
            try:
                per.append(int(fields[i]))
            except (IndexError, ValueError):
                per.append(0)
        depths[fields[0]] = per
    return sample_names, depths


def read_asv_mapping_keys(path: Path) -> list[tuple[str, str]]:
    """merge.rs:89-119 — (asv_header, qiime lineage) pairs."""
    lines = path.read_text().splitlines()
    if not lines:
        return []
    cols = lines[0].split("\t")
    idxs = [cols.index(n) if n in cols else None for n in QIIME_ORDER]
    out = []
    for line in lines[1:]:
        if not line:
            continue
        fields = line.split("\t")
        lineage = ";".join(fields[i] for i in idxs if i is not None and i < len(fields))
        out.append((fields[0], lineage))
    return out


def fuzzy_merge_table(table: dict[str, tuple[bytes, list[int]]], hash_to_lineage: dict[str, str]) -> int:
    """merge.rs:229-336 — absorb ASVs into >=-length ASVs within 10 bp that
    contain ALL of the shorter one's minimizers.  Shortest-first."""
    MAX_LEN_DIFF = 10
    from ..ops.kmers import minimizer_sketch_batch

    hs = list(table)
    batch = minimizer_sketch_batch(
        [np.frombuffer(table[h][0], dtype=np.uint8) for h in hs], 28, 31
    )
    minimizers = {h: np.unique(v) for h, (v, _) in zip(hs, batch)}
    inverted: dict[int, set[str]] = {}
    for h, kms in minimizers.items():
        for km in kms:
            inverted.setdefault(int(km), set()).add(h)

    sorted_hashes = sorted(table, key=lambda h: len(table[h][0]))
    absorbed: set[str] = set()
    for h in sorted_hashes:
        if h in absorbed:
            continue
        kms = minimizers[h]
        if len(kms) == 0:
            continue
        seq_len = len(table[h][0])
        cands: set[str] | None = None
        for km in kms:
            s = inverted.get(int(km))
            if not s:
                cands = set()
                break
            cands = set(s) if cands is None else cands & s
            if not cands:
                break
        cands = cands or set()
        cands.discard(h)
        cands = {
            c for c in cands
            if c not in absorbed
            and len(table[c][0]) >= seq_len
            and len(table[c][0]) - seq_len <= MAX_LEN_DIFF
        }
        if not cands:
            continue
        best = max(cands, key=lambda c: (sum(table[c][1]), c))
        for k in range(len(table[best][1])):
            table[best][1][k] += table[h][1][k]
        if best not in hash_to_lineage and h in hash_to_lineage:
            hash_to_lineage[best] = hash_to_lineage[h]
        for km in kms:
            inverted.get(int(km), set()).discard(h)
        absorbed.add(h)

    for h in absorbed:
        table.pop(h, None)
        hash_to_lineage.pop(h, None)
    if absorbed:
        log.info("Fuzzy merge absorbed %d near-identical ASVs", len(absorbed))
    return len(absorbed)


def export(args: ExportArgs) -> None:
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # pass 1: column structure
    dir_col_offsets, dir_col_counts, sample_names = [], [], []
    for d in args.input_dirs:
        dp = Path(d)
        dir_col_offsets.append(len(sample_names))
        ft = feature_table_from_dir(dp)
        if ft is not None:
            names, _ = ft
            dir_col_counts.append(len(names))
            sample_names.extend(names)
        else:
            dir_col_counts.append(1)
            sample_names.append(sample_name_from_dir(dp))

    total_cols = len(sample_names)
    asv_table: dict[str, tuple[bytes, list[int]]] = {}
    hash_to_lineage: dict[str, str] = {}

    # pass 2: depths + lineages
    for dir_idx, d in enumerate(args.input_dirs):
        dp = Path(d)
        col_start = dir_col_offsets[dir_idx]
        n_cols = dir_col_counts[dir_idx]
        ft = feature_table_from_dir(dp)
        ft_depths = ft[1] if ft else {}
        token_to_hash: dict[str, str] = {}
        fasta = dp / ASV_FILE
        if not fasta.exists():
            log.error("Could not read %s", fasta)
            continue
        for rec in read_fastx(str(fasta)):
            token = rec.id.split()[0] if rec.id.split() else ""
            h = seq_hash(rec.seq)
            token_to_hash[token] = h
            per = ft_depths.get(token, [depth_from_header_total(rec.id)])
            entry = asv_table.setdefault(h, (rec.seq, [0] * total_cols))
            for k, depth in enumerate(per[:n_cols]):
                entry[1][col_start + k] += depth
        mp = dp / "asv_mappings.tsv"
        if mp.exists():
            for token, lineage in read_asv_mapping_keys(mp):
                h = token_to_hash.get(token)
                if h is not None and h not in hash_to_lineage:
                    hash_to_lineage[h] = lineage

    log.info("Loaded %d dirs (%d sample columns), %d unique ASVs", len(args.input_dirs), total_cols, len(asv_table))

    if args.relabel is not None:
        if len(args.relabel) != total_cols:
            raise SystemExit(
                f"--relabel: {len(args.relabel)} label(s) for {total_cols} column(s); counts must match"
            )
        sample_names = list(args.relabel)

    dups = sorted({n for n in sample_names if sample_names.count(n) > 1})
    if dups:
        log.warning("DUPLICATE SAMPLE NAMES DETECTED: %s — use --relabel", dups)

    if not args.no_fuzzy:
        fuzzy_merge_table(asv_table, hash_to_lineage)

    # writers (BTreeMap order = sorted hash keys)
    with open(out_dir / "merged_feature_table.tsv", "w") as f:
        f.write("#OTU ID" + "".join(f"\t{s}" for s in sample_names) + "\n")
        for h in sorted(asv_table):
            f.write(h + "".join(f"\t{c}" for c in asv_table[h][1]) + "\n")

    with open(out_dir / "merged_rep_seqs.fasta", "w") as f:
        for h in sorted(asv_table):
            f.write(f">{h}\n{asv_table[h][0].decode()}\n")

    with open(out_dir / "merged_asv_taxonomy.tsv", "w") as f:
        f.write("Feature ID\tTaxon\n")
        for h in sorted(asv_table):
            f.write(f"{h}\t{hash_to_lineage.get(h, 'Unclassified')}\n")

    lineage_counts: dict[str, list[int]] = {}
    for h in sorted(asv_table):
        lineage = hash_to_lineage.get(h, "Unclassified")
        e = lineage_counts.setdefault(lineage, [0] * total_cols)
        for k, c in enumerate(asv_table[h][1]):
            e[k] += c
    if lineage_counts:
        with open(out_dir / "merged_taxon_counts.tsv", "w") as f:
            f.write("taxon" + "".join(f"\t{s}" for s in sample_names) + "\n")
            for lineage in sorted(lineage_counts):
                f.write(lineage + "".join(f"\t{c}" for c in lineage_counts[lineage]) + "\n")

    # QIIME2 import recipe (merge.rs:503-522)
    log.info(
        "To import into QIIME2:\n"
        "\n"
        "# Feature table\n"
        "biom convert -i %(out)s/merged_feature_table.tsv -o feature-table.biom "
        "--table-type='OTU table' --to-hdf5\n"
        "qiime tools import --type 'FeatureTable[Frequency]' "
        "--input-path feature-table.biom --output-path feature-table.qza\n"
        "\n"
        "# Representative sequences\n"
        "qiime tools import --type 'FeatureData[Sequence]' \\\n"
        "  --input-path %(out)s/merged_rep_seqs.fasta --output-path rep-seqs.qza\n"
        "\n"
        "# If `savont classify / sintax` was run: ASV-level taxonomy "
        "(use with feature-table.qza for taxa barplot)\n"
        "qiime tools import --type 'FeatureData[Taxonomy]' "
        "--input-format HeaderlessTSVTaxonomyFormat \\\n"
        "  --input-path %(out)s/merged_asv_taxonomy.tsv --output-path taxonomy.qza\n"
        "\n"
        "# If `savont classify / sintax` was run: Taxonomy bar plot\n"
        "qiime taxa barplot --i-table feature-table.qza --i-taxonomy taxonomy.qza \\\n"
        "  --o-visualization taxa-bar-plots.qzv",
        {"out": out_dir},
    )
    log.info("Export complete: outputs in %s", out_dir)
