"""Output writers: FASTA, feature table, cluster TSVs (alignment.rs:792-853,
main.rs:376-395)."""
from __future__ import annotations


from ..core import ConsensusSequence, TwinRead


_F64_CACHE: dict[float, str] = {}


def rust_f64(v) -> str:
    """Rust f64 Display parity: shortest-roundtrip like Python repr, but
    integral values print without the trailing .0 (100.0 -> "100").
    Memoized: est_id values repeat across reads and repr(float) is ~1.3 us
    a call (the cluster TSV writers call this once per read per file)."""
    v = float(v)
    s = _F64_CACHE.get(v)
    if s is None:
        if len(_F64_CACHE) > 65536:
            _F64_CACHE.clear()
        s = repr(v)
        if s.endswith(".0"):
            s = s[:-2]
        _F64_CACHE[v] = s
    return s


def consensus_header(prefix: str, i: int, c: ConsensusSequence) -> str:
    if c.per_sample_depths:
        depth_field = "-".join(str(d) for d in c.per_sample_depths)
    else:
        depth_field = str(c.depth + c.appended_depth)
    return (
        f"{prefix}_consensus_{i}_depth_{depth_field} debug_id:{c.id} "
        f"chimera_score:{c.chimera_score or 0} "
        f"unambiguous_read_assignments:{c.unambig_best_read_map_count or 0} "
        f"ambig_read_assignments:{c.ambig_read_map_count or 0} "
        f"num_align_leq_10_mismatches:{c.num_map_leq_10nm or 0}"
    )


def write_consensus_fasta(consensuses: list[ConsensusSequence], path, prefix: str) -> None:
    with open(path, "w") as f:
        for i, c in enumerate(consensuses):
            # peek: writers must not cache decompression mid-pipeline (the
            # HPC form may still change; the reference clones first)
            seq = c.peek_decompressed()
            f.write(f">{consensus_header(prefix, i, c)}\n")
            f.write(seq.tobytes().decode())
            f.write("\n")


def sample_names_from_inputs(input_files: list[str]) -> list[str]:
    """Feature-table column names from input paths (main.rs:152-156).

    Rust ``Path::file_stem`` strips ONLY the last extension:
    ``x.trimmed.fq.gz`` -> ``x.trimmed.fq`` (Python ``Path.stem`` matches),
    with ``unwrap_or("sample")`` for pathological empty names."""
    from pathlib import Path

    return [Path(f).stem or "sample" for f in input_files]


def write_feature_table(consensuses: list[ConsensusSequence], path, sample_names: list[str]) -> None:
    with open(path, "w") as f:
        f.write("#OTU ID\t" + "\t".join(sample_names) + "\n")
        for i, c in enumerate(consensuses):
            if not c.per_sample_depths:
                depth = c.depth + c.appended_depth
                f.write(f"final_consensus_{i}_depth_{depth}\t{depth}\n")
            else:
                ds = [str(d) for d in c.per_sample_depths]
                f.write(f"final_consensus_{i}_depth_{'-'.join(ds)}\t" + "\t".join(ds) + "\n")


def write_clusters_tsv(
    consensuses: list[ConsensusSequence], twin_reads: list[TwinRead], path, prefix: str
) -> None:
    with open(path, "w") as f:
        for c in consensuses:
            if not c.cluster:
                continue
            rep = c.cluster[0]
            members = "\n".join(
                f"{twin_reads[x].id} {rust_f64(twin_reads[x].est_id if twin_reads[x].est_id is not None else 100.0)}"
                for x in c.cluster
            )
            f.write(f"{prefix}_cluster_{c.id}\tsize_{len(c.cluster)}\trepresentative_{rep}\tmembers\n{members}\n")
