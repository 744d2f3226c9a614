"""chip_smoke.py off the card: its pinned output digests are those of the
JAX package's host run on its generated reads, its bounds follow from the
shapes, and it refuses to run (exit code not 0, no result line) without a
card or without the repository around it."""
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke
from savont_tpu.config import ClusterArgs
from savont_tpu.pipeline.asv import run_cluster
from savont_tpu.validate import validate_asvs

from _torch_jobs import clear_caches

ROOT = Path(__file__).resolve().parent.parent


def test_pinned_digests_equal_host_run(tmp_path):
    """The digests the card run is held to are those of savont_tpu's host
    run_cluster on the same seed-pinned reads (tolerance 0: bytes)."""
    fq, tpl = tmp_path / "reads.fq.gz", tmp_path / "templates.fa"
    chip_smoke.write_reads(fq, tpl, chip_smoke.main_path_rng())
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(tmp_path / "host"), threads=4))
    assert chip_smoke.output_digests(tmp_path / "host") == chip_smoke.DIGESTS
    val = validate_asvs(str(tmp_path / "host" / "final_asvs.fasta"), str(tpl))
    assert len(val) >= 5 and all(v.nm == 0 for v in val)


def test_small_sample_digests_equal_host_run(tmp_path):
    """The same for the 1,500-read sample of the host-routes run, drawn
    after the main sample."""
    fq, tpl = tmp_path / "reads.fq.gz", tmp_path / "templates.fa"
    chip_smoke.write_reads(fq, tpl, chip_smoke.small_sample_rng(), chip_smoke.N_READS_SMALL)
    clear_caches()
    run_cluster(ClusterArgs(input_files=[str(fq)], output_dir=str(tmp_path / "host"), threads=4))
    assert chip_smoke.output_digests(tmp_path / "host") == chip_smoke.DIGESTS_SMALL
    val = validate_asvs(str(tmp_path / "host" / "final_asvs.fasta"), str(tpl))
    assert len(val) >= 5 and all(v.nm == 0 for v in val)


def test_kernels_table_names_every_counter():
    """Every kernel the port counts launches of stands in chip_smoke's table
    with its source in the repository."""
    from savont_tpu_torch.ops import align_torch
    from savont_tpu_torch.probes import bitcast, i16ops, roll, roofline

    counted = set(align_torch.LAUNCHES) - {"walk_overflow"}
    for mod in (roofline, bitcast, i16ops, roll):
        counted |= set(mod.LAUNCHES)
    assert counted == set(chip_smoke.KERNELS)
    for src, rep in chip_smoke.KERNELS.values():
        assert (ROOT / src).is_file() and (ROOT / rep.split(":")[0]).is_file()


def test_sw_bounds_from_shapes():
    shape = {"B": 2304, "Lq": 1450, "Lt": 1450, "band": 48, "walk_steps": 2304 * 1450,
             "walk_max_steps": 1460, "walk_rows": 2304 * 1450}
    b = chip_smoke.sw_bounds(shape, 10e12)
    cells = 2304 * 1450 * 48
    assert b["sw_forward_nm"]["cells"] == cells
    nm_ops_ms = cells * chip_smoke.OPS_PER_CELL["sw_forward_nm"] / 10e12 * 1e3
    assert b["sw_forward_nm"]["bound_ms"] >= nm_ops_ms
    assert b["sw_forward_payload"]["bound_ms"] >= cells / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["sw_walk"]["bound_by"] == "bytes"
    # kernel 2's bound counts the walked bytes; the whole rows it streams and
    # the longest walk's chain of shared-memory loads stand beside it
    walked = 2304 * 1450 * 5 + 2304 * (12 + 4 * chip_smoke.MAXRUN + 24)
    assert b["sw_walk"]["bound_ms"] == walked / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["sw_walk"]["whole_rows_ms"] == 2304 * 1450 * 52 / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["sw_walk"]["whole_rows_ms"] > b["sw_walk"]["bound_ms"]
    assert b["sw_walk"]["chain_floor_ms"] == 1460 * 30 / 1.98e9 * 1e3


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    run = [sys.executable, "chip_smoke.py"]
    r = subprocess.run(run, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run(run, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
