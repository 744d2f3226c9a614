"""The check of one `asv` call's outputs against the sample's ground truth.

The reference answer of a sample is known from how it was made: one ASV
for each template, right by refio.containing (the template or a piece of it
of at least 99% of its length, either strand, no edit), each read counted for
its own template, and each template's depth equal to its reads.  Numbers:
- asv_set_errors: ASVs right for no template, extra ASVs of one template
  and templates with no ASV (exact: limit 0);
- reads_misassigned: the share of reads whose own template's ASV is not
  among their best-NM candidates in temp/read_to_asv_mappings.tsv (reads
  missing from it count);
- depth_gap: the widest |feature-table depth - reads| / reads over the
  templates.
Missing outputs read as the worst values.
"""
from __future__ import annotations

import re
from collections import Counter
from pathlib import Path

import numpy as np

from ..refio import containing, feature_depths, read_fasta

# each number's limit: see PERF.md, section 2, for the readings they were set from
LIMITS = {"asv_set_errors": 0.0, "reads_misassigned": 0.05, "depth_gap": 0.25}
DEBUG_ID = re.compile(r"debug_id:(\d+)")


def judge(out: Path, setup) -> dict[str, float]:
    s = setup.sample
    n_tpl = len(s.templates)
    worst = {"asv_set_errors": float(n_tpl), "reads_misassigned": 1.0, "depth_gap": 1.0}
    files = [out / "final_asvs.fasta", out / "feature-table.tsv", out / "temp" / "read_to_asv_mappings.tsv"]
    if not all(f.exists() for f in files):
        return worst
    asv_tpl: dict[str, int] = {}   # ASV id -> template
    name_tpl: dict[str, int] = {}  # ASV name -> template
    errors, matched = 0, Counter()
    for head, seq in read_fasta(files[0]):
        hits = containing(seq, s.templates)
        if len(hits) != 1:
            errors += 1
            continue
        j = hits[0]
        matched[j] += 1
        name_tpl[head.split()[0]] = j
        m = DEBUG_ID.search(head)
        if m:
            asv_tpl[m.group(1)] = j
    errors += sum(c - 1 for c in matched.values()) + (n_tpl - len(matched))

    best: dict[str, tuple[int, set]] = {}
    with open(files[2]) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            read, asv, nm = parts[0], parts[1].removeprefix("asv:"), int(parts[-1])
            j = asv_tpl.get(asv, -1)
            cur = best.get(read)
            if cur is None or nm < cur[0]:
                best[read] = (nm, {j})
            elif nm == cur[0]:
                cur[1].add(j)
    wrong = sum(1 for name, j in zip(s.read_names, s.read_template.tolist())
                if j not in best.get(name, (0, ()))[1])

    reads = np.bincount(s.read_template, minlength=n_tpl).astype(float)
    depth = np.zeros(n_tpl)
    for name, d in feature_depths(files[1]).items():
        if name in name_tpl:
            depth[name_tpl[name]] += d
    return {"asv_set_errors": float(errors), "reads_misassigned": wrong / len(s.read_names),
            "depth_gap": float(np.max(np.abs(depth - reads) / reads))}


def control(setup, out: Path) -> None:
    """The reference's answer with one guarantee of the configuration
    broken, written in the program's formats: the variants not resolved
    (each variant's reads counted for its parent template, as a 99%-identity
    OTU clustering would give)."""
    s = setup.sample
    parent = np.arange(len(s.templates)) % s.n_random
    reads = np.bincount(parent[s.read_template], minlength=s.n_random)
    (out / "temp").mkdir(parents=True, exist_ok=True)
    with open(out / "final_asvs.fasta", "w") as fa, open(out / "feature-table.tsv", "w") as ft:
        ft.write("#OTU ID\treads\n")
        for j in range(s.n_random):
            name = f"final_consensus_{j}_depth_{reads[j]}"
            fa.write(f">{name} debug_id:{j}\n{s.templates[j].decode()}\n")
            ft.write(f"{name}\t{reads[j]}\n")
    with open(out / "temp" / "read_to_asv_mappings.tsv", "w") as f:
        f.writelines(f"{name}\tasv:{parent[j]}\t0\t0\n"
                     for name, j in zip(s.read_names, s.read_template.tolist()))
