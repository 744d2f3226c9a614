"""Seed-pinned planner jobs shared by the savont_tpu_torch tests.

Each job set holds corridors whose largest per-row advance is 1, exactly 2
(small deletions), and above 2 (a structural deletion), on both strands,
plus an unrelated pair.  Inputs are made with numpy from a fixed seed and
need no external data.

Also the converters that hand both packages identical inputs on the device
routes of stages 4 and 7: the reference's flat plan (numpy) packed into its
(rows, slots) panels the way its parallel/mesh.py packs them, and those
panels as the flat-row tensors the port's functions take; and
steady_reference_native, which every port test that compares against a
reference host path runs first (through clear_caches or directly)."""
import fcntl
import gzip
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from savont_tpu.ops.align import TargetIndex
from savont_tpu.ops.align_batch import plan_jobs
from savont_tpu.ops.encode import revcomp_bytes

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(rng, n: int) -> bytes:
    return rng.choice(BASES, n).astype(np.uint8).tobytes()


def substitute(rng, seq: bytes, rate: float) -> bytearray:
    q = bytearray(seq)
    for p in rng.choice(len(q), int(rate * len(q)), replace=False):
        q[p] = b"ACGT"[rng.integers(4)]
    return q


def max_advance(job) -> int:
    return int(np.diff(job.lo).max()) if len(job.lo) > 1 else 0


def mixed_jobs(seed: int, band: int, n: int = 12, lmin: int = 300, lmax: int = 600):
    """Jobs of kinds cycling: substitutions only, 2-6 bp deletions, one
    60 bp deletion, unrelated query; odd trials reverse-complemented
    (savont_tpu's planner over mixed_pairs)."""
    jobs = []
    for q, t in mixed_pairs(seed, n, lmin, lmax):
        jobs.extend(plan_jobs(TargetIndex([t]), q, band=band, min_anchors=2))
    return jobs


def mixed_pairs(seed: int, n: int = 12, lmin: int = 300, lmax: int = 600) -> list[tuple[bytes, bytes]]:
    """The (query, target) pairs behind mixed_jobs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for trial in range(n):
        t = rand_seq(rng, int(rng.integers(lmin, lmax)))
        q = substitute(rng, t, 0.04)
        kind = trial % 4
        if kind == 1:
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(30, len(q) - 40))
                del q[p : p + int(rng.integers(2, 7))]
        elif kind == 2:
            del q[len(q) // 2 : len(q) // 2 + 60]
        elif kind == 3:
            q = bytearray(rand_seq(rng, len(t)))
        q = bytes(q)
        if trial % 2:
            q = revcomp_bytes(q)
        pairs.append((q, t))
    return pairs


def substitution_jobs(seed: int, band: int, n: int, length: int):
    """Substitution-only jobs: corridors advance by at most 1 per row."""
    rng = np.random.default_rng(seed)
    jobs = []
    while len(jobs) < n:
        t = rand_seq(rng, length)
        q = bytes(substitute(rng, t, 0.03))
        jobs.extend(plan_jobs(TargetIndex([t]), q, band=band, min_anchors=2))
    return jobs[:n]


def indexed_pairs(seed: int, n_queries: int = 10, n_targets: int = 3, length: int = 320):
    """Unique query and target pools with index arrays, as the device routes
    hold them: targets are variants of one template (a few SNPs apart),
    queries are reads of them (4% substitutions; every fourth with a 3 bp
    deletion, one with a 60 bp deletion, which gives a corridor jump above
    2), odd ones reverse-complemented; each query is paired with its own
    target and the next one.  Returns (queries, targets, job_uq, job_ti)."""
    rng = np.random.default_rng(seed)
    base = bytearray(rand_seq(rng, length))
    targets = []
    for k in range(n_targets):
        t = bytearray(base)
        for p in range(25 + 11 * k, length - 20, 70):
            t[p] = b"ACGT"[(b"ACGT".index(bytes([t[p]])) + 1 + k) % 4]
        targets.append(bytes(t))
    queries, job_uq, job_ti = [], [], []
    for i in range(n_queries):
        q = substitute(rng, targets[i % n_targets], 0.04)
        if i % 4 == 1:
            p = int(rng.integers(40, length - 60))
            del q[p : p + 3]
        if i == 2:
            del q[length // 2 : length // 2 + 60]
        q = bytes(q)
        queries.append(revcomp_bytes(q) if i % 2 else q)
        for a in sorted({i % n_targets, (i + 1) % n_targets}):
            job_uq.append(i)
            job_ti.append(a)
    return queries, targets, np.asarray(job_uq, np.int64), np.asarray(job_ti, np.int64)


def _scatter_rows(dst, rows_flat, width, lens, src_off, src, col0):
    """The reference's panel scatter (parallel/mesh.py `_scatter`)."""
    total = int(lens.sum())
    within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
    dst.reshape(-1)[np.repeat(rows_flat * width, lens) + col0 + within] = \
        src[np.repeat(src_off, lens) + within]


def slot_layout(owner: np.ndarray):
    """(order, rows_flat, C): plan jobs sorted by owner (stable), each
    owner's jobs in consecutive slots of its row, as the reference lays
    its panels out."""
    order = np.argsort(owner, kind="stable")
    ow = owner[order]
    slot = np.arange(len(ow)) - np.searchsorted(ow, ow, side="left")
    C = int(slot.max()) + 1 if len(ow) else 1
    return order, ow * C + slot, C


def lo_panel_of(plan, order, rows_flat, n_rows, Lq):
    """The reference's (rows, Lq+1) corridor panel: column 0 = column 1, the
    last value forward-filled over the padding."""
    lo_flat, lo_off_j, q_lens_j = plan[10], plan[11], plan[6]
    lo_panel = np.zeros((n_rows, Lq + 1), dtype=np.int32)
    _scatter_rows(lo_panel, rows_flat, Lq + 1, q_lens_j[order].astype(np.int64),
                  lo_off_j[order], lo_flat.astype(np.int32), 1)
    lo_panel[rows_flat, 0] = lo_panel[rows_flat, 1]
    np.maximum.accumulate(lo_panel, axis=1, out=lo_panel)
    return lo_panel


def stage7_panels(plan, pair_read, pair_asv, n_reads, tgt_bytes, smooth=True):
    """The reference's stage-7 candidate panels from its flat plan, packed as
    the JAX mesh packs them (one device, one chunk, the unpacked
    layout): q (R, C, Lq) pad 5, lo (R, C, Lq+1) smoothed, slot_tid /
    slot_asv (R, C) with -1 for empty slots, the target pool, and rows_flat
    / order, the panel row of each plan job."""
    from savont_tpu.ops.align import smooth_lo
    from savont_tpu.parallel.mesh import _build_target_pool

    owner_j, tid_j, q_cat, q_off_j, q_lens_j = plan[0], plan[3], plan[4], plan[5], plan[6]
    order, rows_flat, C = slot_layout(pair_read[owner_j])
    R, Lq = n_reads, int(q_lens_j.max())
    q_panel = np.full((R * C, Lq), 5, dtype=np.int32)
    _scatter_rows(q_panel, rows_flat, Lq, q_lens_j[order].astype(np.int64), q_off_j[order],
                  q_cat.astype(np.int32), 0)
    lo_panel = lo_panel_of(plan, order, rows_flat, R * C, Lq)
    if smooth:
        lo_panel = smooth_lo(lo_panel)
    slot_tid = np.full(R * C, -1, dtype=np.int32)
    slot_asv = np.full(R * C, -1, dtype=np.int32)
    slot_tid[rows_flat] = tid_j[order]
    slot_asv[rows_flat] = pair_asv[owner_j[order]]
    t_pool, tlens_pool = _build_target_pool(tgt_bytes)
    return {
        "q": q_panel.reshape(R, C, Lq), "lo": lo_panel.reshape(R, C, Lq + 1),
        "slot_tid": slot_tid.reshape(R, C), "slot_asv": slot_asv.reshape(R, C),
        "t_pool": t_pool, "tlens_pool": tlens_pool, "rows_flat": rows_flat, "order": order,
    }


def panel_rows(panels, names=("q", "lo")):
    """The occupied rows of (rows, slots, ...) panels as flat-row int32
    tensors for the port, in the panels' slot order, with each row's target
    gathered from the pool: dict of the named panels, t and tlens."""
    rf = panels["rows_flat"]
    out = {}
    for name in names:
        a = panels[name]
        out[name] = torch.from_numpy(
            np.ascontiguousarray(a.reshape(-1, a.shape[-1])[rf].astype(np.int32)))
    tid = panels["slot_tid"].reshape(-1)[rf]
    out["t"] = torch.from_numpy(np.ascontiguousarray(panels["t_pool"][tid].astype(np.int32)))
    out["tlens"] = torch.from_numpy(panels["tlens_pool"][tid].astype(np.int32))
    return out


def stage4_panels(plan, payload, roff, tgt_bytes, use_hp):
    """The reference's stage-4 pair panels from its flat plan, packed as
    mesh_stage4_pileups packs them: per (pair, slot) row the oriented
    raw-byte codes (pad 5), quality levels, clamped homopolymer run lengths,
    the raw corridor, the target id and the flat consensus offset."""
    from savont_tpu.parallel.mesh import _build_target_pool, _ext_codes
    from savont_tpu.pipeline.pileup import qlevel

    owner_j, st_j, tid_j, q_lens_j = plan[0], plan[2], plan[3], plan[6]
    order, rows_flat, C = slot_layout(owner_j)
    Pn, Lq = len(payload), int(q_lens_j.max())
    q_panel = np.full((Pn * C, Lq), 5, dtype=np.int32)
    lvl_panel = np.zeros((Pn * C, Lq), dtype=np.int32)
    hp_panel = np.zeros((Pn * C, Lq if use_hp else 1), dtype=np.int32)
    tid_panel = np.full(Pn * C, -1, dtype=np.int32)
    off_panel = np.zeros(Pn * C, dtype=np.int32)
    for idx, k in enumerate(order.tolist()):
        row = int(rows_flat[idx])
        seq, qual, hp = payload[int(owner_j[k])]
        if int(st_j[k]) == -1:
            seq, qual, hp = revcomp_bytes(seq), qual[::-1], (hp[::-1] if hp is not None else None)
        n = len(seq)
        q_panel[row, :n] = _ext_codes(seq)
        lvl_panel[row, :n] = qlevel(qual)
        if use_hp:
            hp_panel[row, :n] = np.minimum(hp, 63)
        tid_panel[row] = int(tid_j[k])
        off_panel[row] = int(roff[int(tid_j[k])])
    t_pool, tlens_pool = _build_target_pool(tgt_bytes)
    for i, tb in enumerate(tgt_bytes):
        t_pool[i, : len(tb)] = _ext_codes(tb)
    return {
        "q": q_panel, "lvl": lvl_panel, "hp": hp_panel,
        "lo": lo_panel_of(plan, order, rows_flat, Pn * C, Lq),
        "slot_tid": tid_panel, "off": off_panel, "t_pool": t_pool, "tlens_pool": tlens_pool,
        "rows_flat": rows_flat, "order": order, "C": C,
    }


# ── the reference's native libraries ──────────────────────────────────────
#
# savont_tpu builds its host libraries in place, native/<name>.so, with
# `g++ -o` and no lock across processes, and a library that fails to load
# once stays unloaded for the rest of the process (ops/native_build.py
# get_lib's _TRIED, build_extra's _EXTRA_CACHE and each caller's own flag):
# a test worker that loads a file another worker's g++ is still writing
# takes the NumPy fallback for every later call.  steady_reference_native()
# makes sure every library is whole and loaded before a port test compares
# against a reference host path.

ROOT = Path(__file__).resolve().parent.parent
REF_NATIVE_BUILD = ROOT / "build" / "reference_native"  # lock and temporary builds


def reference_native_flags() -> dict[str, tuple[list[str], list[str]]]:
    """Every library savont_tpu builds in native/: name -> (the flags before
    -shared, the flags after the output), as its callers pass them
    (ops/native_build.py _build and the build_extra calls)."""
    import sysconfig

    return {
        "swalign": (["-fopenmp"], []),
        "kmerscan": ([], ["-fopenmp"]),
        "sortcount": ([], ["-fopenmp"]),
        "pileup": ([], ["-fopenmp"]),
        "fastx": ([], ["-lz"]),
        "pyhelpers": ([f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}"], []),
    }


def _reference_loaders() -> dict:
    """name -> (module, attribute of the loaded library, attribute of its
    tried flag, loader): where savont_tpu keeps each library once loaded."""
    import savont_tpu.io.fastx as fastx
    import savont_tpu.ops.kmers_native as kn
    import savont_tpu.ops.native_build as nb
    import savont_tpu.pipeline.pileup as pileup

    return {
        "swalign": (nb, "_LIB", "_TRIED", nb.get_lib),
        "kmerscan": (kn, "_LIB", "_TRIED", kn.get_scan_lib),
        "sortcount": (kn, "_SC_LIB", "_SC_TRIED", kn.get_sortcount_lib),
        "pileup": (pileup, "_PILEUP_LIB", "_PILEUP_TRIED", pileup._get_pileup_lib),
        "fastx": (fastx, "_NATIVE", "_NATIVE_TRIED", fastx._native_lib),
        "pyhelpers": (kn, "_PYH", "_PYH_TRIED", kn._pyhelpers),
    }


@contextmanager
def _build_lock():
    REF_NATIVE_BUILD.mkdir(parents=True, exist_ok=True)
    with open(REF_NATIVE_BUILD / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _file_state(path: Path):
    try:
        st = path.stat()
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_size, st.st_mtime_ns


def _loads(path: Path) -> bool:
    """The library loads, tried in a child process (a file cut short can
    fault the process that maps it)."""
    r = subprocess.run([sys.executable, "-c", "import ctypes, sys; ctypes.CDLL(sys.argv[1])",
                        str(path)], capture_output=True, timeout=60)
    return r.returncode == 0


def build_reference_library(name: str, out: Path) -> None:
    """g++ native/<name>.cpp into `out` as savont_tpu builds it, through a
    temporary file beside `out`'s lock directory, renamed into place."""
    from savont_tpu.ops.native_build import _vector_width_flags

    pre, post = reference_native_flags()[name]
    REF_NATIVE_BUILD.mkdir(parents=True, exist_ok=True)
    tmp = REF_NATIVE_BUILD / f"{name}.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-march=native", *_vector_width_flags(), *pre, "-shared", "-fPIC",
           str(ROOT / "native" / f"{name}.cpp"), "-o", str(tmp), *post]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building savont_tpu's native {name} failed: {r.stderr[-500:]}")
    os.replace(tmp, out)


# files already checked whole in this process: path -> _file_state
_WHOLE: dict[Path, tuple] = {}


def whole_library(src: Path, so: Path, build, settle: float = 0.25, patience: float = 3.0,
                  deadline: float = 300.0) -> None:
    """Return once `so` is a library that loads and is not older than `src`.
    A missing or stale file is built (`build(so)`); a file that changes is
    waited on until it has kept still for `settle` seconds; one that keeps
    still but does not load is waited on for `patience` seconds more (another
    process's compiler may be about to write it again), then built anew.
    Raises after `deadline` seconds."""
    t_end = time.monotonic() + deadline
    while time.monotonic() < t_end:
        st = _file_state(so)
        if st is None or st[2] < src.stat().st_mtime_ns:
            build(so)
            continue
        if _WHOLE.get(so) == st:
            return
        time.sleep(settle)
        if _file_state(so) != st:
            continue
        if _loads(so):
            _WHOLE[so] = st
            return
        waited = time.monotonic() + patience
        while time.monotonic() < waited and _file_state(so) == st:
            time.sleep(settle)
        if _file_state(so) == st:
            build(so)
    raise RuntimeError(f"{so} did not become a whole library in {deadline} s")


def steady_reference_native(names=None) -> None:
    """Make savont_tpu's native libraries (all of them, or `names`) whole
    and loaded in this process: under a lock across processes, build each
    missing or stale one through a temporary file, wait out any other
    writer, and check that it loads; then clear the reference's record of
    a failed load (its _TRIED flags and build_extra's cached None) and load
    each through its own loader.  Raises where one still does not load: a
    comparison must not run quietly against the NumPy fallback."""
    import savont_tpu.ops.native_build as nb

    if os.environ.get("SAVONT_NO_NATIVE"):
        raise RuntimeError("SAVONT_NO_NATIVE is set: savont_tpu would take its NumPy fallback")
    names = list(names or reference_native_flags())
    with _build_lock():
        for name in names:
            whole_library(ROOT / "native" / f"{name}.cpp", ROOT / "native" / f"{name}.so",
                          lambda out, name=name: build_reference_library(name, out))
    loaders = _reference_loaders()
    for name in names:
        mod, lib_attr, tried_attr, load = loaders[name]
        if getattr(mod, lib_attr) is None:
            setattr(mod, tried_attr, False)
            if nb._EXTRA_CACHE.get(name, "") is None:
                del nb._EXTRA_CACHE[name]
        if load() is None:
            raise RuntimeError(f"savont_tpu's native {name} did not load: the comparison would "
                               "run against its NumPy fallback")


@pytest.fixture(autouse=True, scope="module")
def reference_native():
    """steady_reference_native() before a module's tests, for the modules
    that reach savont_tpu's host paths without clear_caches (import it into
    the test module to use it)."""
    steady_reference_native()


def clear_caches() -> None:
    """Empty the module-level state of both packages that a pipeline run
    fills (parsed reads and their encodes, the planner's code and minimizer
    memos, the planner-code registry), so two runs in one process start
    alike; and make savont_tpu's native libraries whole and loaded
    (steady_reference_native), so that its host paths are the native ones."""
    steady_reference_native()
    import savont_tpu.ops.align
    import savont_tpu.ops.align_batch
    import savont_tpu.ops.encode
    import savont_tpu.pipeline.stage1_kmers
    import savont_tpu_torch.ops.align
    import savont_tpu_torch.ops.align_batch
    import savont_tpu_torch.ops.encode
    import savont_tpu_torch.pipeline.stage1_kmers

    for pkg in (savont_tpu, savont_tpu_torch):
        s1 = pkg.pipeline.stage1_kmers
        s1._READ_CACHE.clear()
        s1._ENCODE_CACHE.clear()
        s1._READ_CACHE_BYTES = 0
        for cache in (pkg.ops.align._MINI_CACHE, pkg.ops.align._IDMINI_CACHE,
                      pkg.ops.align_batch._QCODE_CACHE, pkg.ops.align_batch._IDCODE_CACHE,
                      pkg.ops.encode._CODES_REG):
            cache.clear()


# ── classification inputs (classify / sintax / export) ─────────────────────


EMU_HEADER = ("tax_id\tspecies\tgenus\tfamily\torder\tclass\tphylum\tclade\tsuperkingdom\t"
              "subspecies\tspecies subgroup\tspecies group\n")


def write_emu_db(db_dir, refs) -> None:
    """An EMU-format database (species_taxid.fasta, taxonomy.tsv and the
    .savont_db marker) from refs: (tax_id, species, genus, family, seq)."""
    from pathlib import Path

    db_dir = Path(db_dir)
    db_dir.mkdir(parents=True, exist_ok=True)
    with open(db_dir / "species_taxid.fasta", "w") as f:
        for k, (tid, _sp, _g, _fam, seq) in enumerate(refs):
            f.write(f">{tid}:emu_db:{k}\n{seq.decode()}\n")
    with open(db_dir / "taxonomy.tsv", "w") as f:
        f.write(EMU_HEADER)
        for tid, sp, g, fam, _seq in refs:
            f.write(f"{tid}\t{sp}\t{g}\t{fam}\tOrd\tCls\tPhy\tClade\tBacteria\t\t\t\n")
    (db_dir / ".savont_db").write_text("emu-1")


SILVA_FASTA = "SILVA_138.2_SSURef_NR99_tax_silva_trunc.fasta.gz"
SILVA_TAXMAP = "taxmap_slv_ssu_ref_nr_138.2.txt"
SILVA_ORPHAN = "ZZ999999"  # the accession of write_silva_db's record that TAXMAP lacks


def write_silva_db(db_dir, refs, seed: int = 0) -> None:
    """A SILVA-format database (silva-138.2: FASTA.gz, TAXMAP and the
    .savont_db marker) from refs (tax_id, species, genus, family, seq), in
    the shapes of SILVA SSU Ref NR99: RNA letters in lines of 60 under gzip,
    headers `ACCESSION.start.stop path;organism`, TAXMAP lines of accession,
    start, stop, the path ending in ';', organism and taxid.  Besides: refs
    1 and 2 share an accession (two operons of one genome, both named by
    the later TAXMAP line), every fifth ref from the fifth holds an IUPAC
    byte, and a last record, of 500 random bases, has an accession
    (SILVA_ORPHAN) that TAXMAP lacks."""
    rng = np.random.default_rng(seed)
    db_dir = Path(db_dir)
    db_dir.mkdir(parents=True, exist_ok=True)
    accs = [f"AB{100000 + k}" for k in range(len(refs))]
    if len(accs) > 2:
        accs[2] = accs[1]
    fasta, taxmap = [], ["primaryAccession\tstart\tstop\tpath\torganism_name\ttaxid\n"]
    rows = [(a, *r) for a, r in zip(accs, refs)]
    rows.append((SILVA_ORPHAN, "0", "Orphan sp.", "Orphan", "OrphanFam", rand_seq(rng, 500)))
    for k, (acc, tid, sp, genus, fam, seq) in enumerate(rows):
        seq = bytearray(seq)
        if k % 5 == 4 and seq:
            seq[int(rng.integers(len(seq)))] = int(rng.choice(list(b"NRYKMSWBDHV")))
        rna = bytes(seq).replace(b"T", b"U")
        path = f"Bacteria;Phy;Cls;Ord;{fam};{genus}"
        start = 1 + 7000 * k
        stop = start + len(rna) - 1
        fasta.append(f">{acc}.{start}.{stop} {path};{sp}\n".encode()
                     + b"".join(rna[i:i + 60] + b"\n" for i in range(0, len(rna), 60)))
        if acc != SILVA_ORPHAN:
            taxmap.append(f"{acc}\t{start}\t{stop}\t{path};\t{sp}\t{tid}\n")
    with gzip.open(db_dir / SILVA_FASTA, "wb", compresslevel=1) as f:
        f.write(b"".join(fasta))
    (db_dir / SILVA_TAXMAP).write_text("".join(taxmap))
    (db_dir / ".savont_db").write_text("silva-138.2")


def graded_refs(seed: int, n_bases: int = 10, per_base: int = 10, length: int = 1500):
    """n_bases random templates, each with per_base references at growing
    substitution rates (0 to 20%): the first six of a template share its
    genus, the rest form a second genus of its family.  Returns the refs of
    write_emu_db."""
    rng = np.random.default_rng(seed)
    rates = [0.0, 0.003, 0.01, 0.02, 0.03, 0.05, 0.07, 0.10, 0.15, 0.20]
    refs = []
    for b in range(n_bases):
        base = rand_seq(rng, int(rng.integers(length - 60, length + 60)))
        for j in range(per_base):
            seq = bytes(substitute(rng, base, rates[j % len(rates)]))
            genus = f"Genus{b}" if j < 6 else f"Genus{b}b"
            refs.append((str(1000 + b * per_base + j), f"Species {b}.{j}", genus, f"Fam{b // 2}", seq))
    return refs


def foreign_ends(rng, seq: bytes, lead: int, trail: int, rate: float, rc: bool) -> bytes:
    """seq with `rate` substitutions between `lead` and `trail` random bases,
    reverse-complemented when rc."""
    s = rand_seq(rng, lead) + bytes(substitute(rng, seq, rate)) + rand_seq(rng, trail)
    return revcomp_bytes(s) if rc else s


def write_asv_dir(d, seqs, samples: list[str] | None = None, depths=None):
    """An asv output directory: final_asvs.fasta with headers
    final_consensus_<i>_depth_<total>, and a feature-table.tsv of `samples`
    (default one, named after the directory) with depths[i] per ASV (default
    10 * (i + 1) in the one sample)."""
    from pathlib import Path

    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    samples = samples or [d.name]
    depths = depths or [[10 * (i + 1)] for i in range(len(seqs))]
    with open(d / "final_asvs.fasta", "w") as f, open(d / "feature-table.tsv", "w") as t:
        t.write("#OTU ID\t" + "\t".join(samples) + "\n")
        for i, (seq, dep) in enumerate(zip(seqs, depths)):
            name = f"final_consensus_{i}_depth_{sum(dep)}"
            f.write(f">{name}\n{seq.decode()}\n")
            t.write(name + "".join(f"\t{x}" for x in dep) + "\n")
    return d


def read_outputs(d, names) -> dict:
    from pathlib import Path

    return {n: (Path(d) / n).read_bytes() for n in names}
