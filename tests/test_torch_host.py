"""The port's own host layer against savont_tpu's: the planner, the DP
consumers (run on the CPU through the plain versions of the kernels), the
host oracle, and the native build, which writes under build/ and leaves the
repository's native/ alone.

Tolerance: 0.  Planner fields, scores, coordinates, NM and CIGARs are
integers, so every comparison is exact."""
import multiprocessing
from pathlib import Path

import numpy as np
import pytest

import savont_tpu.ops.align_batch as host_ab
from savont_tpu.ops.align import TargetIndex as HostIndex
from savont_tpu_torch.ops import align_batch as port_ab
from savont_tpu_torch.ops import host_dp, native_build
from savont_tpu_torch.ops.align import TargetIndex as PortIndex

from _torch_jobs import clear_caches, mixed_pairs, steady_reference_native

ROOT = Path(__file__).resolve().parent.parent
BAND = 48


def _job_fields(jobs):
    return [
        (j.qcodes.tobytes(), j.tcodes.tobytes(), np.asarray(j.lo, np.int32).tobytes(),
         j.target_id, j.strand, j.fwd_qlen)
        for j in jobs
    ]


def _mapping(m):
    if m is None:
        return None
    return (m.target_id, m.strand, m.query_start, m.query_end, m.target_start, m.target_end,
            m.nm, m.score, np.asarray(m.cigar, np.uint32).tobytes(), m.mapq, m.is_primary)


@pytest.mark.parametrize("planner", ["plan_jobs", "plan_jobs_batch", "_plan_pairs"])
def test_planner_matches_savont_tpu(planner):
    """The port's planner gives the same AlignJobs (query and target codes,
    corridor, target id, strand, forward length) in the same order."""
    pairs = mixed_pairs(seed=71, n=8)
    clear_caches()
    if planner == "plan_jobs":
        host = [j for q, t in pairs for j in host_ab.plan_jobs(HostIndex([t]), q, band=BAND, min_anchors=2)]
        port = [j for q, t in pairs for j in port_ab.plan_jobs(PortIndex([t]), q, band=BAND, min_anchors=2)]
    elif planner == "plan_jobs_batch":
        targets = [t for _, t in pairs]
        queries = [q for q, _ in pairs]
        host, host_own = host_ab.plan_jobs_batch(HostIndex(targets), queries, band=BAND, min_anchors=2)
        port, port_own = port_ab.plan_jobs_batch(PortIndex(targets), queries, band=BAND, min_anchors=2)
        assert host_own == port_own
    else:
        host, host_own = host_ab._plan_pairs(pairs, BAND)
        port, port_own = port_ab._plan_pairs(pairs, BAND)
        assert host_own == port_own
    assert len(host) >= len(pairs) // 2
    assert _job_fields(host) == _job_fields(port)


@pytest.mark.parametrize(
    "consumer", ["align_pairs", "align_pairs_indexed", "align_pairs_nm",
                 "align_pairs_nm_values_indexed", "map_batch"],
)
def test_consumers_match_savont_tpu_host(consumer):
    """Each consumer on the port's CPU device against savont_tpu's host
    version (the C++ struct-of-arrays path).  The NM consumers report
    starts 0 by contract (the Pallas NM route's), so only their score, NM,
    strand and target end are compared."""
    pairs = mixed_pairs(seed=73, n=6)
    queries = [q for q, _ in pairs]
    targets = [t for _, t in pairs]
    qi = np.array([0, 1, 2, 3, 4, 5, 0, 2], dtype=np.int64)
    ti = np.array([0, 1, 2, 3, 4, 5, 1, 2], dtype=np.int64)
    clear_caches()
    if consumer == "align_pairs":
        host = [_mapping(m) for m in host_ab.align_pairs(pairs, band=BAND)]
        port = [_mapping(m) for m in port_ab.align_pairs(pairs, band=BAND, device="cpu")]
    elif consumer == "align_pairs_indexed":
        host = [_mapping(m) for m in host_ab.align_pairs_indexed(queries, targets, qi, ti, band=BAND)]
        port = [_mapping(m) for m in port_ab.align_pairs_indexed(queries, targets, qi, ti, band=BAND,
                                                                 device="cpu")]
    elif consumer == "align_pairs_nm":
        def key(m):
            return None if m is None else (m.score, m.nm, m.strand, m.target_end)

        host = [key(m) for m in host_ab.align_pairs_nm(pairs, band=BAND)]
        port = [key(m) for m in port_ab.align_pairs_nm(pairs, band=BAND, device="cpu")]
    elif consumer == "align_pairs_nm_values_indexed":
        host = host_ab.align_pairs_nm_values_indexed(queries, targets, qi, ti, band=BAND).tolist()
        port = port_ab.align_pairs_nm_values_indexed(queries, targets, qi, ti, band=BAND,
                                                     device="cpu").tolist()
    else:
        host = [[_mapping(m) for m in hits]
                for hits in host_ab.map_batch(HostIndex(targets), queries, band=BAND)]
        port = [[_mapping(m) for m in hits]
                for hits in port_ab.map_batch(PortIndex(targets), queries, band=BAND,
                                              device="cpu")]
    assert any(h not in (None, -1, []) for h in host)
    assert host == port


@pytest.mark.parametrize("mode", ["traceback", "nm", "numpy"])
def test_host_oracle_matches_savont_tpu(mode, monkeypatch):
    """The port's copy of the host C++ DP equals savont_tpu's run_jobs /
    run_jobs_nm on the host path, CIGARs included; so does its NumPy
    fallback, taken where no C++ library could be built."""
    steady_reference_native()
    pairs = mixed_pairs(seed=75, n=8)
    jobs, _ = host_ab._plan_pairs(pairs, BAND)
    if mode == "numpy":
        monkeypatch.setattr(host_dp, "get_lib", lambda: None)
        host, port = host_ab.run_jobs(jobs, band=BAND), host_dp.run_jobs_host(jobs, BAND)
    elif mode == "traceback":
        host, port = host_ab.run_jobs(jobs, band=BAND), host_dp.run_jobs_host(jobs, BAND)
    else:
        host, port = host_ab.run_jobs_nm(jobs, band=BAND), host_dp.run_jobs_nm_host(jobs, BAND)
    assert any(h is not None for h in host)
    for h, p in zip(host, port):
        assert (h is None) == (p is None)
        if h is not None:
            assert h[:5] == p[:5] and h[6] == p[6]
            assert np.array_equal(np.asarray(h[5], np.uint32), np.asarray(p[5], np.uint32))


def _native_snapshot():
    """native/'s sources with their times, and the names of its other files
    but for the libraries savont_tpu itself builds there (native/<name>.so,
    which its tests in other workers may write at any moment)."""
    files = list((ROOT / "native").iterdir())
    return (sorted((p.name, p.stat().st_mtime_ns) for p in files if p.suffix == ".cpp"),
            sorted(p.name for p in files
                   if p.suffix != ".cpp" and not (p.suffix == ".so" and p.with_suffix(".cpp").exists())))


def test_native_build_lands_in_build_dir(monkeypatch):
    """Every host library of the port is built from savont_tpu_torch/native
    into build/savont_tpu_torch/native under a name hashed from source, flags
    and CPU; the repository's native/ directory is neither read nor written."""
    before = _native_snapshot()
    assert native_build.NATIVE_SRC == ROOT / "savont_tpu_torch" / "native"
    monkeypatch.setattr(native_build, "_EXTRA_CACHE", {})
    build_dir = ROOT / "build" / "savont_tpu_torch" / "native"
    assert native_build.BUILD_DIR == build_dir
    for name, link in (("fastx", ["-lz"]), ("swalign", ["-fopenmp"]), ("pileup", ["-fopenmp"])):
        so = native_build.build_extra(name, extra_link=link)
        assert so is not None and so.parent == build_dir
        assert so.name.startswith(f"{name}_") and so.suffix == ".so"
    assert native_build.get_lib() is not None
    assert _native_snapshot() == before


def _build_in(build_dir: str) -> str:
    native_build.BUILD_DIR = Path(build_dir)
    return str(native_build.build_extra("pileup", extra_link=["-fopenmp"]))


def test_native_build_is_safe_across_processes(tmp_path):
    """Processes that build the same library at once all get one complete
    library: one build under the lock, the others reuse it; no temporary
    file is left behind."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        paths = pool.map(_build_in, [str(tmp_path)] * 4, chunksize=1)
    assert len(set(paths)) == 1 and Path(paths[0]).exists()
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".lock", ".so"]
