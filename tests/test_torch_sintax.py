"""The port's sintax against the JAX package, on the CPU.

Kernel 3's plain version (ops/sintax_torch.py) is held to the JAX
package's mesh step sharded_sintax_scores on a one-device CPU mesh, over
chip_smoke's edge cases (the inputs the card run holds the kernel to), and
the port's device scores to the host stream _host_scores; the port's
`sintax --device cpu` to the JAX package's host sintax, byte for byte.
Tolerance 0: the keys are integers and the outputs bytes."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from savont_tpu.config import SintaxArgs as JaxSintaxArgs
from savont_tpu.db import registry as jax_registry
from savont_tpu.parallel.mesh import make_mesh, sharded_sintax_scores
from savont_tpu.pipeline import sintax as jax_sintax
from savont_tpu_torch.config import SintaxArgs
from savont_tpu_torch.db import registry
from savont_tpu_torch.ops import sintax_torch
from savont_tpu_torch.ops.encode import revcomp_bytes
from savont_tpu_torch.pipeline import sintax as port_sintax

from _torch_jobs import graded_refs, rand_seq, read_outputs, substitute, write_asv_dir, write_emu_db

OUTPUTS = ("genus_abundance.tsv", "asv_mappings.tsv")
N_EDGE = len(chip_smoke.sintax_edge_cases())


def _plain_keys(case) -> np.ndarray:
    q = torch.from_numpy(sintax_torch.kernel_kmers(case["queries"]))
    acc = torch.zeros(q.shape[0], dtype=torch.int32)
    refk = torch.from_numpy(sintax_torch.kernel_kmers(case["refk"]))
    ridx = torch.from_numpy(case["ridx"].astype(np.int32))
    calls = sintax_torch.REFERENCE_CALLS["sintax_scores"]
    for r0 in range(0, refk.shape[0], case["chunk"]):
        sintax_torch.sintax_scores(q, refk[r0 : r0 + case["chunk"]].contiguous(),
                                   ridx[r0 : r0 + case["chunk"]].contiguous(), acc)
    assert sintax_torch.REFERENCE_CALLS["sintax_scores"] > calls
    return sintax_torch.keys_int64(acc).numpy()


@pytest.mark.parametrize("k", range(N_EDGE))
def test_kernel3_plain_equals_jax_mesh_step(k):
    """Per chunk the JAX step on one CPU device, max'ed across chunks as its
    route does; the plain version accumulating the same chunks."""
    case = chip_smoke.sintax_edge_cases()[k]
    step = sharded_sintax_scores(make_mesh(1), case["queries"])
    want = np.zeros(len(case["queries"]), dtype=np.uint32)
    for r0 in range(0, len(case["refk"]), case["chunk"]):
        want = np.maximum(want, np.asarray(step(case["refk"][r0 : r0 + case["chunk"]],
                                                case["ridx"][r0 : r0 + case["chunk"]])))
    got = _plain_keys(case)
    assert np.array_equal(got, want.astype(np.int64)), case["name"]
    if case["name"] == "ties_chunks":
        scores = got >> 26
        assert scores.max() == 32 and (got[[0, 17, 299]] == 0).all()
        # pair 1's 32 repeated slots lie in row 1 only: score 32, ordinal 1
        assert got[1] == (32 << 26) | (0x3FFFFFF - 1)


def test_kernel3_wrapper_checks():
    q = torch.zeros((4, 32), dtype=torch.int32)
    refk = torch.zeros((2, 8), dtype=torch.int32)
    ridx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        sintax_torch.sintax_scores(q[:, :31].contiguous(), refk, ridx, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        sintax_torch.sintax_scores(q, refk.long(), ridx, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sintax_torch.sintax_scores_launch(q, refk, ridx, torch.zeros(4, dtype=torch.int32))


def _edge_db(tmp_path, seed: int):
    """Graded references plus the edges of the host stream: two references
    of equal sequence under different taxa (ties: the earlier is kept), a
    reference of 9 bases (no k-mer), one whose taxon is missing, and ASVs of
    10 bases (no k-mer: sentinel rows) and 14 bases (3 k-mers, so slots
    repeat and a reference that holds them scores 32)."""
    rng = np.random.default_rng(seed)
    refs = graded_refs(seed, n_bases=3)
    short = rand_seq(rng, 14)
    refs.insert(5, ("2001", "Twin A", "TwinGenus", "Fam9", refs[12][4]))
    refs += [("2002", "Twin B", "OtherGenus", "Fam9", refs[12][4]),
             ("2003", "Tiny", "TinyGenus", "Fam9", rand_seq(rng, 9)),
             ("2004", "Holder", "HolderGenus", "Fam9", rand_seq(rng, 300) + short)]
    write_emu_db(tmp_path / "db", refs)
    with open(tmp_path / "db" / "species_taxid.fasta", "a") as f:
        f.write(f">9999:emu_db:0\n{rand_seq(rng, 500).decode()}\n")
    asvs = [refs[0][4], bytes(substitute(rng, refs[12][4], 0.05)),
            revcomp_bytes(bytes(substitute(rng, refs[25][4], 0.08))), rand_seq(rng, 10), short,
            rand_seq(rng, 1400)]
    return tmp_path / "db", asvs


def test_device_scores_equal_host_stream(tmp_path, monkeypatch):
    """The port's device scores, in chunks of 4 references so that ties fall
    across launches, against the host stream of the same package."""
    db_dir, asvs = _edge_db(tmp_path, 81)
    db = registry.load_database(db_dir)
    subs = port_sintax.query_matrix(asvs, 20)
    monkeypatch.setattr(port_sintax, "CHUNK_ROWS", 4)
    dev_scores, dev_tax = port_sintax._device_scores(subs, db, len(subs), "cpu")
    host_scores, host_tax = port_sintax._host_scores(subs, port_sintax.QUERY_SENTINEL, db, len(subs))
    assert np.array_equal(dev_scores, host_scores)
    assert [None if e is None else dataclasses.astuple(e) for e in dev_tax] == \
        [None if e is None else dataclasses.astuple(e) for e in host_tax]
    assert dev_scores.max() == 32 and (dev_scores[60:80] == 0).all()


@pytest.mark.parametrize("detailed", [False, True])
def test_sintax_equals_jax_host(tmp_path, detailed):
    db_dir, asvs = _edge_db(tmp_path, 82)
    in_dir = write_asv_dir(tmp_path / "run", asvs)
    kw = {"detailed_unclassified": detailed, "n_iter": 50}
    jax_sintax.sintax(JaxSintaxArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "jax"),
                                    db=str(db_dir), **kw), jax_registry.load_database(db_dir))
    port_sintax.sintax(SintaxArgs(input_dir=str(in_dir), output_dir=str(tmp_path / "port"),
                                  db=str(db_dir), device="cpu", **kw), registry.load_database(db_dir))
    want = read_outputs(tmp_path / "jax", OUTPUTS)
    assert read_outputs(tmp_path / "port", OUTPUTS) == want
    assert "Genus0" in want["asv_mappings.tsv"].decode()


def test_extract_kmers_and_xorshift_equal_jax():
    rng = np.random.default_rng(83)
    for n in (0, 11, 12, 13, 200):
        s = rand_seq(rng, n) + b"acgtu"
        assert np.array_equal(port_sintax.extract_kmers(s), jax_sintax.extract_kmers(s))
    for seed in (0, 1, 42, 2**63 + 5):
        a, b = port_sintax.Xorshift(seed), jax_sintax.Xorshift(seed)
        assert [a.next_usize(97) for _ in range(50)] == [b.next_usize(97) for _ in range(50)]
