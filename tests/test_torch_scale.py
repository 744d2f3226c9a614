"""The launch cuts of the port's routes, on the CPU, against the JAX package.

At a PromethION barcode's scale (chip_smoke.py phase "scale": 100,000 reads,
100,000 references) the port's device routes cut their work into several
launches: stage 7 and classify at PAIRS_PER_LAUNCH jobs, stage 4 at
PAYLOAD_BYTES of payload too, sintax at CHUNK_ROWS references.  Here the
caps are made small, so that a sample of a few hundred reads of 12 templates
(chip_smoke.scale_sample) and a database of a few hundred references cross
them several times; every output must equal, byte for byte, the JAX
package's host run and the port's run with the caps left as they are.  On
the CPU the routes run the kernels' plain versions, one call a launch.

Tolerance: 0.  Outputs are bytes."""
import shutil

import pytest

import chip_smoke
import savont_tpu.ops.align as jax_align
from savont_tpu.config import ClassifyArgs as JaxClassifyArgs
from savont_tpu.config import ClusterArgs
from savont_tpu.config import SintaxArgs as JaxSintaxArgs
from savont_tpu.db.registry import load_database as jax_load_database
from savont_tpu.db.synth import build_emu_slice
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu.pipeline.classify import classify as jax_classify
from savont_tpu.pipeline.sintax import sintax as jax_sintax
from savont_tpu.validate import validate_asvs
from savont_tpu_torch import cli
from savont_tpu_torch.ops import align_torch, sintax_torch
from savont_tpu_torch.parallel import mesh as port_mesh
from savont_tpu_torch.pipeline import sintax as port_sintax

from _torch_jobs import clear_caches, read_outputs

N_READS, N_TEMPLATES = 600, 12
N_REFS = 240
ASV_OUTPUTS = tuple(chip_smoke.DIGESTS)
CLASSIFY_OUTPUTS = ("species_abundance.tsv", "genus_abundance.tsv", "asv_mappings.tsv")
SINTAX_OUTPUTS = ("genus_abundance.tsv", "asv_mappings.tsv")
# the caps that cut this sample's routes into three launches or more: stage
# 7 and classify by jobs, stage 4 by payload bytes (a 1,450-bp job at band 48
# holds about 70 KB), sintax by references
CAPS = {"PAIRS_PER_LAUNCH": 128, "PAYLOAD_BYTES": 6 << 20, "CHUNK_ROWS": 64}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The sample, the JAX package's host run_cluster on it (asv/), a
    database built by the JAX package's build_emu_slice from its templates
    (db/emu), and classify and sintax of the ASVs by the JAX package at the
    band of a fresh process (128), each on its own copy of the database:
    classify writes its minimizer index beside the database."""
    w = tmp_path_factory.mktemp("scale_cuts")
    chip_smoke.scale_sample(w / "reads.fq.gz", w / "templates.fa", N_READS, N_TEMPLATES)
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(w / "reads.fq.gz")], output_dir=str(w / "asv"),
                            threads=4))
    build_emu_slice(w / "templates.fa", w / "db", n_refs=N_REFS, seed=chip_smoke.DB_SEED)
    shutil.copytree(w / "db", w / "jax_db")
    band = jax_align.DEFAULT_BAND
    jax_align.DEFAULT_BAND = 128
    try:
        db_dir = w / "jax_db" / "emu"
        db = jax_load_database(db_dir)
        jax_classify(JaxClassifyArgs(input_dir=str(w / "asv"), output_dir=str(w / "jax_classify"),
                                     db=str(db_dir)), db)
        jax_sintax(JaxSintaxArgs(input_dir=str(w / "asv"), output_dir=str(w / "jax_sintax"),
                                 db=str(db_dir)), db)
    finally:
        jax_align.DEFAULT_BAND = band
    return w


def _capped(monkeypatch, capped: bool) -> None:
    if capped:
        monkeypatch.setattr(align_torch, "PAIRS_PER_LAUNCH", CAPS["PAIRS_PER_LAUNCH"])
        monkeypatch.setattr(align_torch, "PAYLOAD_BYTES", CAPS["PAYLOAD_BYTES"])
        monkeypatch.setattr(port_sintax, "CHUNK_ROWS", CAPS["CHUNK_ROWS"])


def _port_db(work, tag):
    """A copy of the database of the port's own, one a run."""
    dst = work / f"db_{tag}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(work / "db", dst)
    return dst / "emu"


def test_scale_sample_is_even_and_exact(work):
    """The host run finds every template of the sample, each ASV at NM=0:
    the runs below carry all 12."""
    val = validate_asvs(str(work / "asv" / "final_asvs.fasta"), str(work / "templates.fa"))
    assert len(val) == N_TEMPLATES and all(v.nm == 0 for v in val)


@pytest.mark.parametrize("capped", [False, True], ids=["caps_as_they_are", "caps_cut"])
def test_asv_launch_cuts_equal_the_host_run(work, monkeypatch, capped):
    """`asv --device cpu` on the device routes: with the caps cut, stage 7
    and stage 4 each run every planned job in three launches or more (the
    scale phase's several launches a route), each launch within its caps,
    and the outputs equal the JAX host run's and the uncut run's."""
    _capped(monkeypatch, capped)
    tag = "capped" if capped else "uncapped"
    clear_caches()
    align_torch.reset_counters()
    port_mesh.reset_route_stats()
    assert cli.main(["asv", str(work / "reads.fq.gz"), "-o", str(work / f"port_{tag}"),
                     "--device", "cpu", "-t", "4"]) == 0
    want = read_outputs(work / "asv", ASV_OUTPUTS)
    assert read_outputs(work / f"port_{tag}", ASV_OUTPUTS) == want
    for route in ("stage4", "stage7"):
        st = port_mesh.ROUTE_STATS[route]
        assert st["fallbacks"] == 0 and st["jobs"] == st["planned"] > 0, (route, st)
        assert sum(st["launch_jobs"]) == st["jobs"], (route, st)
        if capped:
            assert len(st["launch_jobs"]) >= 3, (route, st)
            assert max(st["launch_jobs"]) <= CAPS["PAIRS_PER_LAUNCH"], (route, st)
        else:
            assert len(st["launch_jobs"]) == 1, (route, st)
    st4 = port_mesh.ROUTE_STATS["stage4"]
    if capped:
        # a launch passes PAYLOAD_BYTES by less than one pair's jobs (two
        # strands at most)
        for n, lq in zip(st4["launch_jobs"], st4["launch_lq"]):
            assert (n - 2) * lq * 48 <= CAPS["PAYLOAD_BYTES"], st4
    assert not any(align_torch.LAUNCHES.values())


@pytest.mark.parametrize("capped", [False, True], ids=["caps_as_they_are", "caps_cut"])
def test_classify_launch_cut_equals_the_host_run(work, monkeypatch, capped):
    """`classify --device cpu` of the sample's ASVs: with PAIRS_PER_LAUNCH
    cut, kernel 1 (NM) takes its candidate jobs in two launches or more;
    the outputs equal the JAX host run's and the uncut run's."""
    _capped(monkeypatch, capped)
    tag = "capped" if capped else "uncapped"
    clear_caches()
    align_torch.reset_counters()
    out = work / f"classify_{tag}"
    assert cli.main(["classify", "-i", str(work / "asv"), "-o", str(out), "-d",
                     str(_port_db(work, f"classify_{tag}")), "--device", "cpu"]) == 0
    assert read_outputs(out, CLASSIFY_OUTPUTS) == read_outputs(work / "jax_classify",
                                                               CLASSIFY_OUTPUTS)
    n = align_torch.REFERENCE_CALLS["sw_forward_nm"]
    assert n >= 2 if capped else n == 1
    assert not any(align_torch.LAUNCHES.values())


@pytest.mark.parametrize("capped", [False, True], ids=["caps_as_they_are", "caps_cut"])
def test_sintax_chunks_equal_the_host_run(work, monkeypatch, capped):
    """`sintax --device cpu` of the sample's ASVs: with CHUNK_ROWS cut, the
    references stream through kernel 3 in three chunks or more, every
    reference once; the outputs equal the JAX host run's and the uncut
    run's."""
    _capped(monkeypatch, capped)
    tag = "capped" if capped else "uncapped"
    sintax_torch.reset_counters()
    port_sintax.SCORE_STATS["refs"] = 0
    out = work / f"sintax_{tag}"
    assert cli.main(["sintax", "-i", str(work / "asv"), "-o", str(out), "-d",
                     str(_port_db(work, f"sintax_{tag}")), "--device", "cpu"]) == 0
    assert read_outputs(out, SINTAX_OUTPUTS) == read_outputs(work / "jax_sintax", SINTAX_OUTPUTS)
    n = sintax_torch.REFERENCE_CALLS["sintax_scores"]
    assert n >= 3 if capped else n == 1
    assert port_sintax.SCORE_STATS["refs"] == N_REFS
    assert not any(sintax_torch.LAUNCHES.values())


def _scale_run(**over) -> dict:
    """A scale run's counters as cli_asv returns them, every check met."""
    s7 = {"calls": 1, "fallbacks": 0, "planned": 99_946, "jobs": 99_946,
          "launch_jobs": [16384] * 6 + [1642]}
    s4 = {**s7, "planned": 46_244, "jobs": 46_244, "launch_jobs": [15437, 15427, 15380]}
    # the launches inside each route; the stage-4 votes and stages 5-6
    # launch beside them, in the run-wide counts
    l4 = {"sw_forward_nm": 0, "sw_forward_payload": 3, "sw_walk": 3}
    l7 = {"sw_forward_nm": 7, "sw_forward_payload": 0, "sw_walk": 0}
    launches = {"sw_forward_nm": 12, "sw_forward_payload": 9, "sw_walk": 9}
    for k, v in over.items():
        what, key = k.split("__")
        {"s4": s4, "s7": s7, "l4": l4, "l7": l7, "launches": launches}[what][key] = v
    return {"routes": {"stage4": s4, "stage7": s7}, "launches": launches,
            "route_launches": {"stage4": l4, "stage7": l7}}


BAD_SCALE_RUNS = {
    "stage4_one_launch": {"s4__launch_jobs": [46_244]},
    "stage7_one_launch": {"s7__launch_jobs": [99_946]},
    "stage7_fallback": {"s7__fallbacks": 1},
    "stage4_jobs_not_planned": {"s4__jobs": 46_243},
    "stage7_launch_past_the_cap": {"s7__launch_jobs": [16385] * 6 + [1636]},
    "stage7_launches_short_of_the_jobs": {"s7__launch_jobs": [16384] * 6},
    "stage7_too_few_jobs": {"s7__planned": 40_000, "s7__jobs": 40_000,
                            "s7__launch_jobs": [20_000, 20_000]},
    "no_launches": {"l7__sw_forward_nm": 0},
    "stage4_walks_short_of_its_launches": {"l4__sw_walk": 2},
    "stage7_launches_outside_the_route": {"l7__sw_forward_nm": 6},
    "stage4_fallback": {"s4__fallbacks": 1},
}


def test_scale_routes_check_passes_the_measured_run():
    """check_asv_routes passes a run like the one the card gave: stage 4
    in three launches, stage 7 in seven."""
    chip_smoke.check_asv_routes("scale", _scale_run(), chip_smoke.N_READS_SCALE, min_launches=2)


@pytest.mark.parametrize("bad", BAD_SCALE_RUNS)
def test_scale_routes_check_refuses(bad):
    """check_asv_routes fails a scale run whose route fell back, ran
    other jobs than it planned, took one launch, passed PAIRS_PER_LAUNCH,
    counted fewer kernel launches than its launch cut, or carried under half
    the reads through stage 7."""
    with pytest.raises(AssertionError):
        chip_smoke.check_asv_routes("scale", _scale_run(**BAD_SCALE_RUNS[bad]),
                                       chip_smoke.N_READS_SCALE, min_launches=2)


def test_stage7_launch_kept_keeps_the_first_full_nm_launch(monkeypatch):
    """Inside stage7_launch_kept the stage-7 route's kernel-1 calls pass
    through unchanged; the first NM call of PAIRS_PER_LAUNCH jobs is kept
    (not a shorter one, not a payload-mode one), and the route's own
    sw_forward is back after the block."""
    import numpy as np
    import torch

    from _torch_jobs import substitution_jobs
    from savont_tpu_torch.ops.align_torch import jobs_to_tensors, sw_forward

    monkeypatch.setattr(align_torch, "PAIRS_PER_LAUNCH", 4)
    real = port_mesh.sw_forward
    x = jobs_to_tensors(substitution_jobs(5, 48, 4, 200), "cpu")
    short = tuple(a[:3] for a in x)
    kept = []
    with chip_smoke.stage7_launch_kept(kept):
        port_mesh.sw_forward(*short, 48)
        port_mesh.sw_forward(*x, 48, emit_payload=True)
        got = port_mesh.sw_forward(*x, 48)
        port_mesh.sw_forward(*x, 48)
    assert port_mesh.sw_forward is real
    assert len(kept) == 1 and kept[0][1] == 48
    assert all(a is b for a, b in zip(kept[0][0], x))
    assert torch.equal(got, sw_forward(*x, 48))
    assert np.array_equal(got.numpy(), sw_forward(*kept[0][0], 48).numpy())
