"""The sample a configuration describes, made from the run's seed.

A frozen copy of the repository's synthetic ONT barcode (chip_smoke.py's
scale_sample, whose error model is write_reads'): n_templates templates of
template_len random bases, the first half random and the second half a
variant of each with 4-6 SNPs at least 60 bases from either end, in even
abundance (read i from template i % n_templates); each read gets
substitutions at substitution_rate, then one deletion of each kind in
`deletions` ([share of reads, shortest, longest]) in that order, placed in
[100, len - 160), and is reverse-complemented with probability 1/2.  The
seed changes the draws, never the shape: read and template counts, lengths,
abundance and error rates are the configuration's.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
BATCH = 10_000  # reads drawn at once
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(s: bytes) -> bytes:
    return s.translate(COMP)[::-1]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use of one run seed."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), stream]))


@dataclass
class Sample:
    fastq: Path
    templates_fasta: Path
    templates: list[bytes]       # template j, as written to templates_fasta
    read_names: list[str]
    read_template: np.ndarray    # the template each read was drawn from
    n_random: int                # templates [0, n_random) are random, the rest their variants


def make_sample(cfg: dict, seed: int, out: Path) -> Sample:
    rng = rng_for(seed, 0)
    n_reads, n_tpl, tlen = cfg["n_reads"], cfg["n_templates"], cfg["template_len"]
    n_random = n_tpl // 2
    tpls = rng.choice(BASES, (n_random, tlen))
    variants = tpls.copy()
    lo, hi = cfg["variant_snps"]
    for v in variants:
        pos = rng.choice(np.arange(60, tlen - 60), int(rng.integers(lo, hi + 1)), replace=False)
        v[pos] = BASES[(np.searchsorted(BASES, v[pos]) + rng.integers(1, 4, len(pos))) % 4]
    tpls = np.concatenate([tpls, variants])
    templates = [t.tobytes() for t in tpls]
    out.mkdir(parents=True, exist_ok=True)
    tpl_path, fq = out / "templates.fa", out / "reads.fq.gz"
    with open(tpl_path, "w") as f:
        for i, t in enumerate(templates):
            f.write(f">template{i}\n{t.decode()}\n")
    codes = np.searchsorted(BASES, tpls).astype(np.uint8)
    names: list[str] = []
    read_template = np.arange(n_reads) % n_tpl
    with gzip.open(fq, "wb", compresslevel=1) as fout:
        for b0 in range(0, n_reads, BATCH):
            n = min(BATCH, n_reads - b0)
            ti = read_template[b0:b0 + n]
            shift = rng.integers(1, 4, (n, tlen), dtype=np.uint8)
            shift[rng.random((n, tlen)) >= cfg["substitution_rate"]] = 0
            seqs = BASES[(codes[ti] + shift) % 4]
            dels = [(rng.random(n) < frac, rng.integers(lo_len, hi_len + 1, n), rng.random(n))
                    for frac, lo_len, hi_len in cfg["deletions"]]
            rc = rng.random(n) < 0.5
            chunk = []
            for r in range(n):
                s = seqs[r].tobytes()
                for has, length, at in dels:
                    if has[r]:
                        p = 100 + int(at[r] * (len(s) - 260))
                        s = s[:p] + s[p + int(length[r]):]
                if rc[r]:
                    s = revcomp(s)
                name = f"t{ti[r]}_r{b0 + r}"
                names.append(name)
                chunk.append(b"@%s\n%s\n+\n%s\n" % (name.encode(), s, b"I" * len(s)))
            fout.write(b"".join(chunk))
    return Sample(fq, tpl_path, templates, names, read_template, n_random)


def write_asv_dir(sample: Sample, out: Path) -> Path:
    """The input of classify and sintax, made from the sample alone: each
    template as an ASV, with its read count as its depth, in the files
    `asv` writes (final_asvs.fasta, feature-table.tsv)."""
    depths = np.bincount(sample.read_template, minlength=len(sample.templates))
    out.mkdir(parents=True, exist_ok=True)
    names = [f"final_consensus_{j}_depth_{d}" for j, d in enumerate(depths)]
    with open(out / "final_asvs.fasta", "w") as f:
        f.writelines(f">{n}\n{t.decode()}\n" for n, t in zip(names, sample.templates))
    with open(out / "feature-table.tsv", "w") as f:
        f.write("#OTU ID\tsample\n")
        f.writelines(f"{n}\t{d}\n" for n, d in zip(names, depths))
    return out
