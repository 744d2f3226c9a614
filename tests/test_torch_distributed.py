"""The port over several ranks (parallel/distributed.py), on the CPU.

Each run starts its ranks as processes of this file, `python
test_torch_distributed.py <job> <rank> <world> <init> <in.pkl> <out.pkl>`,
joined over gloo with `--device cpu`; they import neither jax nor
savont_tpu (each asserts so at exit), and this module imports both only
inside its test functions.  A run kills every rank on the first failure or
at its timeout.  What the ranks give is held, at tolerance 0, to the one-rank
route of the port in this process and to the JAX package: the stage-7 route
on tests/_dist_stage7_worker.make_pairs() and on a set where a rank gets no
pair; the stage-4 count matrices; a whole `asv`; `sintax` with a tie across
ranks and a score-32 key; the stage-1 count and classify's NM matrices over
ranks; the collective helpers; process start-up from the environment."""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 120
OUTPUTS = ("final_asvs.fasta", "feature-table.tsv", "temp/read_to_asv_mappings.tsv")
SINTAX_OUTPUTS = ("genus_abundance.tsv", "asv_mappings.tsv")
BAND7 = 64


# ── the ranks' side: jobs run inside a process group ───────────────────────


def _stats():
    from savont_tpu_torch.parallel import distributed, mesh

    return {"routes": {k: dict(v) for k, v in mesh.ROUTE_STATS.items()},
            "collectives": {k: dict(v) for k, v in distributed.COLLECTIVES.items()}}


def _job_stage7(inp):
    from savont_tpu_torch.parallel import mesh

    out = []
    for case in inp["cases"]:
        mesh.reset_route_stats()
        nm_vals = mesh.stage7_nm_values(*case, band=BAND7, device="cpu")
        out.append({"nm": nm_vals, **_stats()})
    return out


def _job_asv(inp):
    """run_cluster into the rank's own directory, with every stage-4 count
    matrix captured; or, with "cli", the CLI, which joins the group from the
    environment."""
    from savont_tpu_torch import cli
    from savont_tpu_torch.config import ClusterArgs
    from savont_tpu_torch.parallel import distributed, mesh
    from savont_tpu_torch.pipeline.asv import run_cluster

    out_dir = f"{inp['out']}/rank{os.environ.get('SAVONT_PROCESS_ID', distributed.rank())}"
    mats = []
    real = mesh.mesh_stage4_pileups

    def capture(twin_reads, consensuses, args):
        pms = real(twin_reads, consensuses, args)
        mats.append([(pm.bq, pm.dels, pm.ins_q, pm.hp_hist) for pm in pms])
        return pms

    mesh.mesh_stage4_pileups = capture
    mesh.reset_route_stats()
    try:
        if inp.get("cli"):
            rc = cli.main(["--log-level", "warn", "asv", inp["fq"], "-o", out_dir, "--device",
                           "cpu", "-t", "2", "--min-cluster-size", "5"])
            assert rc == 0 and not distributed.active()
        else:
            run_cluster(ClusterArgs(input_files=[inp["fq"]], output_dir=out_dir, threads=2,
                                    min_cluster_size=5, use_hpc=inp.get("use_hpc", False),
                                    device="cpu"))
    finally:
        mesh.mesh_stage4_pileups = real
    return {"dir": out_dir, "mats": mats, **_stats()}


def _job_sintax(inp):
    from savont_tpu_torch.config import SintaxArgs
    from savont_tpu_torch.db import registry
    from savont_tpu_torch.parallel import distributed
    from savont_tpu_torch.pipeline import sintax

    out_dir = f"{inp['out']}/rank{distributed.rank()}"
    sintax.sintax(SintaxArgs(input_dir=inp["in"], output_dir=out_dir, db=inp["db"], n_iter=50,
                             device="cpu"), registry.load_database(Path(inp["db"])))
    return {"dir": out_dir, "refs": sintax.SCORE_STATS["refs"], **_stats()}


def _job_kmers(inp):
    from savont_tpu_torch.parallel import mesh

    stats = {k: 0 for k in ("positions", "flagged", "distinct")}
    out = {"count": mesh.split_kmer_count(inp["codes"], inp["quals"], 17, 25, "cpu", stats,
                                          group=True), "stats": stats}
    if "queries" in inp:
        out["classify"] = mesh.sharded_classify_nm(inp["queries"], inp["refs"], 128, "cpu")
    return {**out, **_stats()}


def _job_helpers(inp):
    """The collective helpers on the cases of _helper_cases, in a group that
    maybe_init_from_env joins from torchrun's variables."""
    import torch

    from savont_tpu_torch.parallel import distributed

    assert distributed.maybe_init_from_env("cpu") and distributed.active()
    r, w = distributed.rank(), distributed.world()
    out = {"rank": r, "world": w, "gather": [], "reduce": [], "a2a": [], "strided": []}
    for dtype, sizes, width in _helper_cases(w):
        t = _rank_rows(r, sizes[r], width, dtype)
        out["gather"].append(distributed.all_gather_rows(t, sizes).numpy())
    for dtype in (torch.int32, torch.int64, torch.float32):
        for op in ("sum", "max"):
            t = _rank_rows(r, 5, 3, dtype)
            out["reduce"].append((op, distributed.all_reduce_(t, op).numpy()))
    for dtype, sizes, width in _helper_cases(w):
        send = [(s + r + d) % 4 for d, s in enumerate(sizes)]  # uneven, some 0
        t = _rank_rows(r, sum(send), width, dtype)
        got, recv_sizes = distributed.all_to_all_rows(t, send)
        out["a2a"].append((send, got.numpy(), recv_sizes))
    # a tensor the transport has to copy (a strided view) and write back,
    # the staging path a card tensor takes under gloo
    base = _rank_rows(r, 6, 4, torch.int64)
    view = base[:, 1]
    distributed.all_reduce_(view, "sum")
    out["strided"].append(base.numpy())
    gathered = distributed.all_gather_rows(base[::2, :2], [3] * w)
    out["strided"].append(gathered.numpy())
    out["collectives"] = {k: dict(v) for k, v in distributed.COLLECTIVES.items()}
    return out


def _helper_cases(world: int):
    """(dtype, rows a rank, row width): every dtype the routes reduce or
    gather, uneven sizes, a rank with none, and all ranks with none."""
    import torch

    uneven = [3 + 2 * r for r in range(world)]
    one_empty = [0] + [4] * (world - 1)
    return [(torch.int32, uneven, 2), (torch.int64, one_empty, 3), (torch.float32, uneven, 1),
            (torch.int64, [0] * world, 2)]


def _rank_rows(r: int, n: int, width: int, dtype):
    import torch

    vals = torch.arange(n * width, dtype=torch.float64).reshape(n, width) * 1.5 + 100 * r - 7
    return vals.to(dtype)


JOBS = {"stage7": _job_stage7, "asv": _job_asv, "sintax": _job_sintax, "kmers": _job_kmers,
        "helpers": _job_helpers}


def _worker(job: str, rank: int, world: int, init: str, src: str, dst: str) -> None:
    sys.path.insert(0, str(ROOT))
    from savont_tpu_torch.parallel import distributed

    with open(src, "rb") as f:
        inp = pickle.load(f)
    if init.startswith("file://"):
        distributed.init(world, rank, init, "cpu", timeout_s=60)
    try:
        out = JOBS[job](inp)
    finally:
        distributed.shutdown()
    leaked = {"jax", "savont_tpu"} & {m.split(".")[0] for m in sys.modules}
    assert not leaked, f"a rank imported {leaked}"
    with open(dst, "wb") as f:
        pickle.dump(out, f)


# ── the test's side ─────────────────────────────────────────────────────────


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path: Path, job: str, world: int, inp, env_of=None, init: str = "file"):
    """Start `world` ranks of `job` together and return their results, rank
    order.  env_of(rank) adds variables to a rank's environment; init
    "file" joins them through a file in tmp_path, "env" leaves the joining
    to the job.  Every rank is killed on the first failure or at
    RUN_TIMEOUT_S."""
    run = tmp_path / f"{job}_w{world}_{time.monotonic_ns()}"
    run.mkdir()
    src = run / "in.pkl"
    with open(src, "wb") as f:
        pickle.dump(inp, f)
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("SAVONT_") and k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    base["OMP_NUM_THREADS"] = "2"
    init_arg = f"file://{run}/rendezvous" if init == "file" else "env"
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(run / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, job, str(r), str(world), init_arg, str(src),
                 str(run / f"out{r}.pkl")],
                cwd=ROOT, env={**base, **(env_of(r) if env_of else {})}, stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RUN_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n"
                          f"{(run / f'rank{r}.log').read_text()[-3000:]}" for r in bad)
        raise AssertionError(f"{job} over {world} ranks failed:\n{tails}")
    outs = []
    for r in range(world):
        with open(run / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _indexed(pairs, rr, ca):
    """make_pairs' (read, ASV) pairs as the port's indexed form: the reads
    and the ASVs once each, and per pair their indices."""
    reads, asvs = {}, {}
    for (read, asv), r, a in zip(pairs, rr.tolist(), ca.tolist()):
        reads[r], asvs[a] = read, asv
    return [reads[i] for i in range(len(reads))], [asvs[i] for i in range(len(asvs))]


def _stage7_cases():
    """make_pairs() (as tests/test_distributed.py runs it); a single pair,
    so that every rank but the first gets no job; no pair at all."""
    from _dist_stage7_worker import make_pairs

    pairs, rr, ca, _n_reads, n_asvs = make_pairs()
    reads, asvs = _indexed(pairs, rr, ca)
    one = (reads[:1], asvs[:1], np.array([0]), np.array([0]))
    none = (reads[:1], asvs[:1], np.zeros(0, np.int64), np.zeros(0, np.int64))
    return [(reads, asvs, rr, ca), one, none], (pairs, rr, ca, _n_reads, n_asvs)


@pytest.mark.parametrize("world", [2, 3])
def test_stage7_over_ranks_equals_one_rank_and_the_jax_mesh(tmp_path, world):
    import jax

    from savont_tpu.parallel.mesh import make_mesh
    from savont_tpu.parallel.mesh import mesh_stage7_tie_break as jax_stage7
    from savont_tpu_torch.parallel import mesh

    cases, ref_args = _stage7_cases()
    outs = _run_ranks(tmp_path, "stage7", world, {"cases": cases})
    for ci, case in enumerate(cases):
        mesh.reset_route_stats()
        nm1 = mesh.stage7_nm_values(*case, band=BAND7, device="cpu")
        jobs1 = mesh.ROUTE_STATS["stage7"]["jobs"]
        for out in outs:
            got = out[ci]
            assert np.array_equal(got["nm"], nm1) and got["nm"].dtype == nm1.dtype
            assert got["routes"]["stage7"]["fallbacks"] == 0
        shares = [out[ci]["routes"]["stage7"]["jobs"] for out in outs]
        assert sum(shares) == jobs1, (shares, jobs1)
        if ci == 0:
            assert all(s > 0 for s in shares), shares  # no rank did all the work
            gathers = [k for k in outs[0][ci]["collectives"] if k.startswith("all_gather/")]
            assert gathers == ["all_gather/gloo"]
        if ci == 1:
            assert shares[0] == jobs1 > 0 and not any(shares[1:])
    # the JAX package's route on its 8-device mesh picks the same winners
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    best, _abund, count = jax_stage7(*ref_args, band=BAND7, mesh=make_mesh(8))
    want = np.array([-1 if b is None else b.nm for b in best], dtype=np.int64)
    nm = outs[0][0]["nm"]
    assert np.array_equal(nm, want)
    # the assigned reads: those with at least one aligned candidate
    assert len(np.unique(ref_args[1][nm >= 0])) == count


def _jax_host_pileups(fq, out_dir, use_hpc):
    """The JAX package's host run over fq, with every host pileup captured
    (the oracle of tests/test_stage4_mesh.py)."""
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline import pileup as pileup_mod
    from savont_tpu.pipeline.asv import run_cluster

    mats = []
    real = pileup_mod.generate_consensus_pileups

    def capture(twin_reads, consensuses, args):
        pms = real(twin_reads, consensuses, args)
        mats.append([(pm.bq, pm.dels, pm.ins_q, pm.hp_hist) for pm in pms])
        return pms

    pileup_mod.generate_consensus_pileups = capture
    try:
        run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(out_dir), threads=2,
                                min_cluster_size=5, use_hpc=use_hpc))
    finally:
        pileup_mod.generate_consensus_pileups = real
    return mats


def _same_mats(a, b) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(
            all((u is None and v is None) or np.array_equal(u, v) for u, v in zip(pm, qm))
            for pm, qm in zip(x, y))
        for x, y in zip(a, b))


@pytest.mark.parametrize("use_hpc", [False, True])
def test_stage4_over_ranks_equals_one_rank_and_the_jax_host(tmp_path, use_hpc):
    from _torch_jobs import clear_caches
    from test_stage4_mesh import _workload

    fq = _workload(tmp_path, seed=29, hp=use_hpc)
    outs = _run_ranks(tmp_path, "asv", 2, {"fq": str(fq), "out": str(tmp_path / "ranks"),
                                           "use_hpc": use_hpc})
    clear_caches()
    want = _jax_host_pileups(fq, tmp_path / "jax", use_hpc)
    clear_caches()
    one = _job_asv({"fq": str(fq), "out": str(tmp_path / "one"), "use_hpc": use_hpc})
    assert want and all(m for m in want)
    assert _same_mats(one["mats"], want), "one rank's pileups differ from the host's"
    for out in outs:
        assert _same_mats(out["mats"], want), "a rank's pileups differ from the host's and one rank's"
        assert out["routes"]["stage4"]["fallbacks"] == 0
        assert out["collectives"]["all_reduce/gloo"]["calls"] >= 4 * len(want)
    shares = [out["routes"]["stage4"]["jobs"] for out in outs]
    assert all(s > 0 for s in shares), shares  # no rank did all the work
    assert sum(shares) == one["routes"]["stage4"]["jobs"], shares



def _asv_fixture(tmp_path) -> Path:
    """The 72 reads of tests/test_distributed.py's whole-pipeline test: two
    templates 4 SNPs apart, 36 reads each, half reverse-complemented."""
    import gzip

    from savont_tpu.ops.encode import revcomp_bytes

    rng = np.random.default_rng(41)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    t1 = bytearray(rng.choice(bases, 1200).tobytes())
    t2 = bytearray(t1)
    for p in (140, 420, 760, 1100):
        t2[p] = b"ACGT"[(b"ACGT".index(bytes([t2[p]])) + 1) % 4]
    reads = []
    for tpl in (bytes(t1), bytes(t2)):
        for i in range(36):
            b = bytearray(tpl)
            for p in rng.choice(len(b), 2, replace=False):
                b[p] = b"ACGT"[rng.integers(4)]
            r = bytes(b)
            reads.append(revcomp_bytes(r) if i % 2 else r)
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.decode()}\n+\n{'Z' * len(r)}\n")
    return fq


def test_whole_asv_over_ranks_through_the_cli_equals_the_jax_host_run(tmp_path):
    """Two ranks of `asv --device cpu` through the CLI, joined by
    SAVONT_COORDINATOR on a free port: each rank's outputs byte-identical to
    the JAX package's host run, and the two ranks' route jobs adding up to
    the one-process run's."""
    from savont_tpu.config import ClusterArgs
    from savont_tpu.pipeline.asv import run_cluster

    from _torch_jobs import clear_caches

    fq = _asv_fixture(tmp_path)
    coord = f"127.0.0.1:{_free_port()}"
    env_of = lambda r: {"SAVONT_COORDINATOR": coord, "SAVONT_NUM_PROCESSES": "2",
                        "SAVONT_PROCESS_ID": str(r)}
    outs = _run_ranks(tmp_path, "asv", 2, {"fq": str(fq), "out": str(tmp_path / "ranks"),
                                           "cli": True}, env_of, init="env")
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(tmp_path / "jax"), threads=2,
                            min_cluster_size=5))
    clear_caches()
    one = _job_asv({"fq": str(fq), "out": str(tmp_path / "one")})
    for rel in OUTPUTS:
        want = (tmp_path / "jax" / rel).read_bytes()
        assert want and (Path(one["dir"]) / rel).read_bytes() == want, rel
        for out in outs:
            assert (Path(out["dir"]) / rel).read_bytes() == want, f"{rel} differs on {out['dir']}"
    for route in ("stage4", "stage7"):
        shares = [out["routes"][route]["jobs"] for out in outs]
        assert all(s > 0 for s in shares) and sum(shares) == one["routes"][route]["jobs"], \
            (route, shares, one["routes"][route])
        assert not any(out["routes"][route]["fallbacks"] for out in outs)
    for out in outs:
        assert {"all_gather/gloo", "all_reduce/gloo"} <= set(out["collectives"])
    assert not one["collectives"]


def _sintax_db(tmp_path):
    """Records in an order that puts the edges of the stream across the two
    ranks (record r is rank r % 2's): a reference of 9 bases (no k-mer) and
    one of a missing taxon first, so that kept counts differ from record
    indices; twins of one sequence under two genera at records 3 and 4
    (ranks 1 and 0: the earlier one, on rank 1, must win their ties); a
    reference holding a 14-base ASV's three k-mers (a score of 32, bit 31 of
    the key); graded references after them.  Returns (db dir, ASVs)."""
    from savont_tpu_torch.ops.encode import revcomp_bytes

    from _torch_jobs import graded_refs, rand_seq, substitute, write_emu_db

    rng = np.random.default_rng(91)
    graded = graded_refs(91, n_bases=2, length=900)
    twin = graded[3][4]
    short = rand_seq(rng, 14)
    refs = [("2003", "Tiny", "TinyGenus", "Fam9", rand_seq(rng, 9)),
            ("2005", "Lone", "LoneGenus", "Fam9", rand_seq(rng, 700)),
            ("2004", "Holder", "HolderGenus", "Fam9", rand_seq(rng, 300) + short),
            ("2001", "Twin A", "TwinGenus", "Fam9", twin),
            ("2002", "Twin B", "OtherGenus", "Fam9", twin)] + graded
    write_emu_db(tmp_path / "db", refs)
    # record 1's taxon is missing from the taxonomy
    tax = (tmp_path / "db" / "taxonomy.tsv").read_text().splitlines(keepends=True)
    (tmp_path / "db" / "taxonomy.tsv").write_text("".join(t for t in tax if not t.startswith("2005\t")))
    asvs = [bytes(substitute(rng, twin, 0.02)), short, graded[12][4],
            revcomp_bytes(bytes(substitute(rng, graded[15][4], 0.05))), rand_seq(rng, 10)]
    return tmp_path / "db", asvs


def test_sintax_over_ranks_equals_the_jax_host(tmp_path):
    from savont_tpu.config import SintaxArgs as JaxSintaxArgs
    from savont_tpu.db import registry as jax_registry
    from savont_tpu.pipeline import sintax as jax_sintax
    from savont_tpu_torch.config import SintaxArgs
    from savont_tpu_torch.db import registry
    from savont_tpu_torch.pipeline import sintax as port_sintax

    from _torch_jobs import write_asv_dir

    db_dir, asvs = _sintax_db(tmp_path)
    in_dir = write_asv_dir(tmp_path / "run", asvs)
    outs = _run_ranks(tmp_path, "sintax", 2, {"in": str(in_dir), "db": str(db_dir),
                                              "out": str(tmp_path / "ranks")})
    jax_sintax.sintax(JaxSintaxArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "jax"),
                                    db=str(db_dir), n_iter=50), jax_registry.load_database(db_dir))
    port_sintax.SCORE_STATS["refs"] = 0
    port_sintax.sintax(SintaxArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "one"),
                                  db=str(db_dir), n_iter=50, device="cpu"),
                       registry.load_database(db_dir))
    want = {rel: (tmp_path / "jax" / rel).read_bytes() for rel in SINTAX_OUTPUTS}
    text = want["asv_mappings.tsv"].decode()
    assert "TwinGenus" in text and "OtherGenus" not in text and "HolderGenus" in text
    for d in [tmp_path / "one"] + [Path(out["dir"]) for out in outs]:
        assert {rel: (d / rel).read_bytes() for rel in SINTAX_OUTPUTS} == want, d
    # the score-32 pair's key has bit 31 set
    db = registry.load_database(db_dir)
    subs = port_sintax.query_matrix(asvs, 50)
    scores, _tax = port_sintax._device_scores(subs, db, len(subs), "cpu")
    assert scores.max() == 32
    refs = [out["refs"] for out in outs]
    assert all(r > 0 for r in refs) and sum(refs) == port_sintax.SCORE_STATS["refs"] // 2, refs
    for out in outs:
        assert out["collectives"]["all_reduce/gloo"]["calls"] == 1


def test_sintax_refuses_more_records_than_ordinals(tmp_path, monkeypatch):
    """A reference's ordinal is its record index: past the key's 26 bits the
    route raises instead of mixing references up."""
    from savont_tpu_torch.db import registry
    from savont_tpu_torch.pipeline import sintax as port_sintax

    db_dir, asvs = _sintax_db(tmp_path)
    monkeypatch.setattr(port_sintax, "ORDINAL_MAX", 6)
    subs = port_sintax.query_matrix(asvs, 4)
    with pytest.raises(ValueError, match="more than 7 records"):
        port_sintax._device_scores(subs, registry.load_database(db_dir), len(subs), "cpu")


def _kmer_reads():
    """Reads, exact copies and reverse complements (counts above 1 on both
    strands) with random qualities; tests/test_torch_kmers.py's count
    reads."""
    rng = np.random.default_rng(5)
    base = [rng.integers(0, 4, int(rng.integers(60, 600))).astype(np.uint8) for _ in range(9)]
    codes = base + [b.copy() for b in base[:5]] + [(3 - b[::-1]).astype(np.uint8) for b in base[2:7]]
    codes += [(3 - base[3][::-1]).astype(np.uint8)]
    quals = [rng.integers(10, 45, len(c)).astype(np.uint8) for c in codes]
    return codes, quals


def _fold(flagged_unique: np.ndarray, n: np.ndarray):
    """sharded_split_kmer_count's (flagged k-mers, counts) as the port's
    (bare k-mers, counts[n, 2])."""
    bare = flagged_unique & np.uint64(0x7FFFFFFFFFFFFFFF)
    kmers, inv = np.unique(bare, return_inverse=True)
    counts = np.zeros((len(kmers), 2), np.uint32)
    np.add.at(counts, (inv, (flagged_unique >> np.uint64(63)).astype(np.int64)), n.astype(np.uint32))
    return kmers, counts


def _classify_inputs():
    """3 ASVs against 7 references of two graded templates (odd, so the
    ranks' shares differ), both strands."""
    from savont_tpu_torch.ops.encode import revcomp_bytes

    from _torch_jobs import graded_refs, substitute

    refs = [r[4] for r in graded_refs(93, n_bases=2, per_base=4, length=400)][:7]
    rng = np.random.default_rng(93)
    queries = [bytes(substitute(rng, refs[0], 0.01)), revcomp_bytes(refs[5]),
               bytes(substitute(rng, refs[2], 0.04))]
    return queries, refs


@pytest.mark.parametrize("world", [2, 3])
def test_stage1_count_and_classify_nm_over_ranks(tmp_path, world):
    """split_kmer_count(group=True) over the ranks equals the one-rank count
    and the JAX package's sharded_split_kmer_count; over two ranks
    sharded_classify_nm equals one rank's matrices and, pair by pair, the
    JAX package's host align_pairs_nm."""
    import jax

    from savont_tpu.ops import align_batch as jax_batch
    from savont_tpu.parallel.mesh import make_mesh, sharded_split_kmer_count
    from savont_tpu_torch.parallel.mesh import sharded_classify_nm, split_kmer_count

    codes, quals = _kmer_reads()
    inp = {"codes": codes, "quals": quals}
    if world == 2:
        inp["queries"], inp["refs"] = _classify_inputs()
    outs = _run_ranks(tmp_path, "kmers", world, inp)
    one_k, one_c = split_kmer_count(codes, quals, 17, 25, "cpu")
    assert len(one_k) > 1000
    for out in outs:
        km, ct = out["count"]
        assert km.dtype == one_k.dtype and ct.dtype == one_c.dtype
        assert np.array_equal(km, one_k) and np.array_equal(ct, one_c)
        assert out["collectives"]["all_to_all/gloo"]["calls"] == 2
    flagged = [out["stats"]["flagged"] for out in outs]
    assert all(f > 0 for f in flagged) and sum(flagged) == int(one_c.astype(np.int64).sum())
    if len(jax.devices()) >= 8:
        jk, jc = _fold(*sharded_split_kmer_count(make_mesh(8), codes, quals, 17, 25))
        assert np.array_equal(one_k, jk) and np.array_equal(one_c, jc)
    if world != 2:
        return
    queries, refs = inp["queries"], inp["refs"]
    nm1, score1 = sharded_classify_nm(queries, refs, 128, "cpu")
    assert nm1.shape == score1.shape == (len(queries), len(refs)) and nm1.dtype == np.int32
    for out in outs:
        nm, score = out["classify"]
        assert np.array_equal(nm, nm1) and np.array_equal(score, score1)
    pairs = [(q, r) for q in queries for r in refs]
    host = jax_batch.align_pairs_nm(pairs, band=128)
    want_nm = np.array([-1 if m is None else m.nm for m in host]).reshape(nm1.shape)
    want_score = np.array([0 if m is None else m.score for m in host]).reshape(nm1.shape)
    aligned = nm1 >= 0
    assert aligned.sum() >= len(queries) and (~aligned).any()
    assert np.array_equal(nm1[aligned], want_nm[aligned])
    assert np.array_equal(score1[aligned], want_score[aligned])


def test_collective_helpers_over_torchrun_variables(tmp_path):
    """SAVONT_DISTRIBUTED=auto with torchrun's variables joins a group of
    their size; the helpers give every rank the same rows, sums, maxima and
    exchanges, for int32, int64 and float32, uneven and zero sizes, and
    write back through a tensor they had to copy."""
    import torch

    world, port = 3, _free_port()
    env_of = lambda r: {"SAVONT_DISTRIBUTED": "auto", "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(port), "WORLD_SIZE": str(world), "RANK": str(r)}
    outs = _run_ranks(tmp_path, "helpers", world, {}, env_of, init="env")
    assert [(o["rank"], o["world"]) for o in outs] == [(r, world) for r in range(world)]
    for i, (dtype, sizes, width) in enumerate(_helper_cases(world)):
        want = torch.cat([_rank_rows(r, sizes[r], width, dtype) for r in range(world)]).numpy()
        for o in outs:
            assert o["gather"][i].dtype == want.dtype and np.array_equal(o["gather"][i], want)
    for i, (dtype, op) in enumerate((d, op) for d in (torch.int32, torch.int64, torch.float32)
                                    for op in ("sum", "max")):
        rows = torch.stack([_rank_rows(r, 5, 3, dtype) for r in range(world)])
        want = (rows.sum(0) if op == "sum" else rows.max(0).values).numpy()
        for o in outs:
            assert o["reduce"][i][0] == op and np.array_equal(o["reduce"][i][1], want)
    for i, (dtype, sizes, width) in enumerate(_helper_cases(world)):
        sends = [[(s + r + d) % 4 for d, s in enumerate(sizes)] for r in range(world)]
        rows = [_rank_rows(r, sum(sends[r]), width, dtype) for r in range(world)]
        for d, o in enumerate(outs):
            parts = [rows[r][sum(sends[r][:d]):sum(sends[r][:d + 1])] for r in range(world)]
            assert o["a2a"][i][2] == [sends[r][d] for r in range(world)]
            assert np.array_equal(o["a2a"][i][1], torch.cat(parts).numpy())
    col = sum(_rank_rows(r, 6, 4, torch.int64)[:, 1] for r in range(world)).numpy()
    for o in outs:
        base = _rank_rows(o["rank"], 6, 4, torch.int64).numpy()
        base[:, 1] = col
        assert np.array_equal(o["strided"][0], base)
        assert o["strided"][1].shape == (3 * world, 2)
        assert set(o["collectives"]) == {"all_gather/gloo", "all_reduce/gloo", "all_to_all/gloo"}


# ── start-up, in this process ──────────────────────────────────────────────


@pytest.fixture
def clean_env(monkeypatch):
    for v in ("SAVONT_COORDINATOR", "SAVONT_NUM_PROCESSES", "SAVONT_PROCESS_ID",
              "SAVONT_DISTRIBUTED"):
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_no_variables_is_a_no_op(clean_env):
    from savont_tpu_torch.parallel import distributed

    assert distributed.maybe_init_from_env("cpu") is False
    assert not distributed.active() and distributed.rank() == 0 and distributed.world() == 1
    assert distributed.is_primary()
    import torch

    t = torch.arange(4)
    assert distributed.all_gather_rows(t, [4]) is t and distributed.all_reduce_(t, "max") is t
    assert distributed.all_to_all_rows(t, [4]) == (t, [4])


@pytest.mark.parametrize("present", [(0,), (1,), (2,), (0, 1), (0, 2), (1, 2)])
def test_partial_variables_exit_naming_the_missing(clean_env, present):
    from savont_tpu_torch.parallel import distributed

    values = ("127.0.0.1:1", "2", "0")
    for i in present:
        clean_env.setenv(distributed.ENV_VARS[i], values[i])
    with pytest.raises(SystemExit, match="partial") as e:
        distributed.maybe_init_from_env("cpu")
    missing = [v for i, v in enumerate(distributed.ENV_VARS) if i not in present]
    assert all(v in str(e.value) for v in missing)
    assert not any(distributed.ENV_VARS[i] in str(e.value) for i in present)
    assert not distributed.active()


def test_auto_without_torchrun_variables_exits(clean_env):
    from savont_tpu_torch.parallel import distributed

    clean_env.setenv("SAVONT_DISTRIBUTED", "auto")
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        clean_env.delenv(v, raising=False)
    with pytest.raises(SystemExit, match="WORLD_SIZE"):
        distributed.maybe_init_from_env("cpu")


def test_nccl_takes_one_card_a_rank(monkeypatch):
    """Under NCCL a node with more ranks than cards exits; each rank makes
    LOCAL_RANK % cards current; gloo shares a card."""
    import torch

    from savont_tpu_torch.parallel import distributed

    taken = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", taken.append)
    for v in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(SystemExit, match="3 ranks on this node and 2 CUDA card"):
        distributed._take_card(2, 3, "nccl")
    distributed._take_card(2, 3, "gloo")
    distributed._take_card(1, 2, "nccl")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    distributed._take_card(5, 8, "nccl")  # four nodes of two cards
    assert taken == [0, 1, 1]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        distributed._take_card(0, 1, "gloo")


@pytest.mark.parametrize("weights, parts, group, want", [
    ([1] * 10, 3, None, [0, 4, 7, 10]),
    ([1] * 2, 3, None, [0, 1, 2, 2]),            # more ranks than items
    ([], 2, None, [0, 0, 0]),
    ([5, 1, 1, 1], 2, None, [0, 1, 4]),
    ([1] * 10, 3, [0, 0, 1, 1, 1, 2, 2, 3, 3, 3], [0, 5, 7, 10]),  # no cut inside a group
    ([1] * 4, 2, [0, 0, 0, 0], [0, 4, 4]),       # one group: one rank takes it
    ([3, 3], 1, [0, 1], [0, 2]),
])
def test_shares(weights, parts, group, want):
    from savont_tpu_torch.parallel.distributed import shares

    got = shares(np.array(weights), parts, None if group is None else np.array(group))
    assert got.tolist() == want


def test_ranks_started_together_build_the_kernels_once(tmp_path):
    """build_kernels takes a file lock a library: two processes that find no
    library at the same moment compile it once (the compiler and the loader
    stubbed)."""
    code = (
        "import sys, time, ctypes\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from savont_tpu_torch.ops import build\n"
        f"d = Path({str(tmp_path)!r})\n"
        "build.BUILD_DIR = d / 'build'\n"
        "def compile_(srcs, so):\n"
        "    with open(d / 'compiles', 'a') as f:\n"
        "        f.write('x')\n"
        "    time.sleep(1.0)\n"
        "    so.write_bytes(b'lib')\n"
        "    return ''\n"
        "build._compile = compile_\n"
        "build._bind = lambda lib: None\n"
        "ctypes.CDLL = lambda path: path\n"
        "while not (d / 'go').exists():\n"
        "    time.sleep(0.01)\n"
        "assert Path(build.build_kernels()).read_bytes() == b'lib'\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    time.sleep(0.5)
    (tmp_path / "go").touch()
    for p in procs:
        _, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
    assert (tmp_path / "compiles").read_text() == "x"
    assert len(list((tmp_path / "build").glob("libsavont_kernels_*.so"))) == 1

if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
