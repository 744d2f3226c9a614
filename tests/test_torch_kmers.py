"""Stage-1 device k-mers of the port (ops/kmers_torch.py, kernels 4 and 5 as
their plain PyTorch versions on the CPU, and parallel/mesh.split_kmer_count)
against the JAX package on the CPU: kmers_jax.split_kmers_batch,
device_split_kmers, syncmer_batch, _mm_hash64_planes and
mesh.sharded_split_kmer_count, and the host functions they reproduce
(kmers.split_kmer_mid, syncmer_and_snpmer_scan, count_flagged_kmers,
encode.mm_hash64).  The inputs are chip_smoke.kmer_edge_cases' reads (made
with numpy from a seed), the same arrays for both packages.

Tolerance: 0.  Every output is an integer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from savont_tpu.ops import kmers as jax_host
from savont_tpu.ops import kmers_jax
from savont_tpu.ops.encode import mm_hash64 as host_mm_hash64
from savont_tpu.parallel.mesh import make_mesh, sharded_split_kmer_count
from savont_tpu_torch.ops import kmers_torch as kt
from savont_tpu_torch.ops.encode import encode_seq
from savont_tpu_torch.ops.kmers import count_flagged_kmers
from savont_tpu_torch.parallel.mesh import split_kmer_count

from _torch_jobs import reference_native  # noqa: F401  (autouse: savont_tpu's native libraries whole)

MIN_BQ = chip_smoke.MIN_BQ
PAD_L = 12_288  # one padded width for every case (the longest read is 12,000)
CASES = [c["name"] for c in chip_smoke.kmer_edge_cases(17)]
U64 = np.uint64


def _case(k: int, name: str, with_qual: bool):
    """(codes, quals) of the named edge case at k; with_qual fills the
    reads without qualities from a seed, without it no read has any."""
    case = next(c for c in chip_smoke.kmer_edge_cases(k) if c["name"] == name)
    codes = [encode_seq(r) for r in case["reads"]]
    if not with_qual:
        return codes, None
    rng = np.random.default_rng(7)
    quals = case["quals"] or [None] * len(codes)
    return codes, [q if q is not None else rng.integers(2, 41, len(c)).astype(np.uint8)
                   for c, q in zip(codes, quals)]


def _padded(codes, quals):
    """The JAX batch: (N, PAD_L) int32 codes and phreds (zeros past a read's
    end, and for a read without qualities), lengths."""
    c = np.zeros((len(codes), PAD_L), np.int32)
    p = np.zeros((len(codes), PAD_L), np.int32)
    for i, r in enumerate(codes):
        c[i, : len(r)] = r
        if quals is not None and quals[i] is not None:
            p[i, : len(r)] = quals[i]
    return c, p, np.array([len(r) for r in codes], np.int32)


def _per_read(flat: torch.Tensor, batch) -> list[np.ndarray]:
    a = flat.numpy()
    oo = batch.out_off.numpy()
    return [a[oo[i] : oo[i + 1]] for i in range(len(oo) - 1)]


@pytest.mark.parametrize("with_qual", [True, False], ids=["qual", "no_qual"])
@pytest.mark.parametrize("k", chip_smoke.KMER_KS)
@pytest.mark.parametrize("name", CASES)
def test_split_kmers_batch_matches_jax(name, k, with_qual):
    """Kernel 4's plain version: every position's flagged key and validity
    equal kmers_jax.split_kmers_batch's, the padding's positions aside."""
    codes, quals = _case(k, name, with_qual)
    batch = kt.read_batch(codes, quals, k, "cpu")
    keys, valid = kt.split_kmers_batch(batch, MIN_BQ)
    assert keys.dtype == torch.int64 and valid.dtype == torch.uint8 and keys.numel() == batch.n_pos
    c, p, lens = _padded(codes, quals)
    khi, klo, canon, jvalid = kmers_jax.split_kmers_batch(
        jnp.asarray(c), jnp.asarray(p), jnp.asarray(lens), k, MIN_BQ, quals is not None)
    jkeys = kmers_jax._combine64(np.asarray(khi), np.asarray(klo)) | (
        np.asarray(canon).astype(U64) << U64(63))
    jvalid = np.asarray(jvalid)
    for i, (gk, gv) in enumerate(zip(_per_read(keys, batch), _per_read(valid, batch))):
        n = len(gk)
        assert n == max(len(codes[i]) - k + 1, 0)
        assert gk.view(U64).tolist() == jkeys[i, :n].tolist()
        assert gv.astype(bool).tolist() == jvalid[i, :n].tolist()


@pytest.mark.parametrize("k", chip_smoke.KMER_KS)
@pytest.mark.parametrize("name", CASES)
def test_device_split_kmers_matches_jax_and_host(name, k):
    """Per read, the flagged k-mers in position order: the port's
    device_split_kmers on the CPU == the JAX device_split_kmers ==
    split_kmer_mid (the JAX package's host function)."""
    codes, quals = _case(k, name, True)
    kt.reset_counters()
    got = kt.device_split_kmers(codes, quals, k, MIN_BQ, "cpu")
    assert kt.REFERENCE_CALLS["split_kmers"] == 1 and kt.LAUNCHES["split_kmers"] == 0
    want = kmers_jax.device_split_kmers(codes, quals, k, MIN_BQ)
    assert len(got) == len(want) == len(codes)
    for g, w, c, q in zip(got, want, codes, quals):
        assert g.dtype == U64
        assert g.tolist() == w.tolist() == jax_host.split_kmer_mid(c, q, k, MIN_BQ).tolist()


@pytest.mark.parametrize("kc", chip_smoke.SYNC_KC, ids=lambda kc: f"k{kc[0]}_c{kc[1]}")
@pytest.mark.parametrize("name", CASES)
def test_syncmer_batch_matches_jax_and_host(name, kc):
    """Kernel 5's plain version: the syncmer flags and the canonical k-mers
    of every position equal kmers_jax.syncmer_batch's, and its syncmers those
    of the host scan (syncmer_and_snpmer_scan), read by read."""
    k, c = kc
    codes, _ = _case(k, name, False)
    batch = kt.read_batch(codes, None, k, "cpu")
    flags, kmers = kt.syncmer_batch(batch, c)
    cp, _, lens = _padded(codes, None)
    jflags, khi, klo = kmers_jax.syncmer_batch(jnp.asarray(cp), jnp.asarray(lens), k, c)
    jflags = np.asarray(jflags)
    jkmers = kmers_jax._combine64(np.asarray(khi), np.asarray(klo))
    for i, (f, km) in enumerate(zip(_per_read(flags, batch), _per_read(kmers, batch))):
        n = len(f)
        assert f.astype(bool).tolist() == jflags[i, :n].tolist()
        assert km.view(U64).tolist() == jkmers[i, :n].tolist()
        pos, mk, _, _ = jax_host.syncmer_and_snpmer_scan(codes[i], None, k, c, np.zeros(0, U64), MIN_BQ)
        assert np.flatnonzero(f).tolist() == pos.tolist()
        assert km.view(U64)[f.astype(bool)].tolist() == mk.tolist()


def _hash_inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "random":
        return rng.integers(0, 2**63, 4096, dtype=np.uint64) * U64(2) + rng.integers(0, 2, 4096).astype(U64)
    if kind == "smers":  # canonical s-mers as kernel 5 hashes them (s <= 21)
        return rng.integers(0, 1 << 42, 4096, dtype=np.uint64)
    return np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1], U64)


@pytest.mark.parametrize("kind", ["random", "smers", "edges"])
def test_mm_hash64_matches_jax_planes_and_host(kind):
    v = _hash_inputs(kind)
    got = kt.mm_hash64(torch.from_numpy(v.view(np.int64))).numpy().view(U64)
    hi = (v >> U64(32)).astype(np.uint32)
    lo = (v & U64(0xFFFFFFFF)).astype(np.uint32)
    ghi, glo = kmers_jax._mm_hash64_planes(jnp.asarray(hi), jnp.asarray(lo))
    assert got.tolist() == kmers_jax._combine64(np.asarray(ghi), np.asarray(glo)).tolist()
    assert got.tolist() == host_mm_hash64(v).tolist()


def _count_reads():
    """Reads, exact copies and reverse complements: counts above 1 on both
    strands; random qualities, so the gate drops some positions."""
    rng = np.random.default_rng(5)
    base = [rng.integers(0, 4, int(rng.integers(60, 600))).astype(np.uint8) for _ in range(9)]
    codes = base + [b.copy() for b in base[:5]] + [(3 - b[::-1]).astype(np.uint8) for b in base[2:7]]
    codes += [(3 - base[3][::-1]).astype(np.uint8)]
    quals = [rng.integers(10, 45, len(c)).astype(np.uint8) for c in codes]
    return codes, quals


def _fold(flagged_unique: np.ndarray, n: np.ndarray):
    """sharded_split_kmer_count's (flagged k-mers, counts) as
    count_flagged_kmers' (bare k-mers, counts[n, 2])."""
    bare = flagged_unique & U64(0x7FFFFFFFFFFFFFFF)
    kmers, inv = np.unique(bare, return_inverse=True)
    counts = np.zeros((len(kmers), 2), np.uint32)
    np.add.at(counts, (inv, (flagged_unique >> U64(63)).astype(np.int64)), n.astype(np.uint32))
    return kmers, counts


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
@pytest.mark.parametrize("n_dev", [1, 8])
def test_split_kmer_count_matches_jax_mesh_and_host(n_dev):
    codes, quals = _count_reads()
    k = 17
    kt.reset_counters()
    got_k, got_c = split_kmer_count(codes, quals, k, MIN_BQ, "cpu")
    assert kt.REFERENCE_CALLS["split_kmers"] == 1
    assert got_k.dtype == U64 and got_c.dtype == np.uint32 and got_c.shape == (len(got_k), 2)
    jk, jc = _fold(*sharded_split_kmer_count(make_mesh(n_dev), codes, quals, k, MIN_BQ))
    hk, hc = count_flagged_kmers([jax_host.split_kmer_mid(c, q, k, MIN_BQ) for c, q in zip(codes, quals)])
    for want_k, want_c in ((jk, jc), (hk, hc)):
        assert got_k.tolist() == want_k.tolist()
        assert got_c.tolist() == want_c.tolist()
    # both strands seen more than once for some k-mers
    assert int((got_c.min(axis=1) >= 2).sum()) > 0


def test_split_kmer_count_empty_inputs():
    """No read, reads shorter than k, and positions that all fail the gate
    give count_flagged_kmers' empty table."""
    short = [np.zeros(10, np.uint8), np.zeros(0, np.uint8)]
    gated = [np.arange(40, dtype=np.uint8) % 4]
    q = [np.concatenate([np.full(39, 2, np.uint8), [40]]).astype(np.uint8)]
    for codes, quals in (([], None), (short, None), (gated, q)):
        km, ct = split_kmer_count(codes, quals, 17, MIN_BQ, "cpu")
        want = count_flagged_kmers([jax_host.split_kmer_mid(c, None if quals is None else quals[i], 17, MIN_BQ)
                                    for i, c in enumerate(codes)])
        assert km.dtype == want[0].dtype == U64 and ct.dtype == want[1].dtype == np.uint32
        assert km.shape == want[0].shape == (0,) and ct.shape == want[1].shape == (0, 2)


def test_kernel_wrappers_refuse_bad_arguments():
    codes = [np.arange(50, dtype=np.uint8) % 4]
    with pytest.raises(ValueError):
        kt.split_kmers_batch(kt.read_batch(codes, None, 16, "cpu"), MIN_BQ)  # even k
    with pytest.raises(ValueError):
        kt.read_batch(codes, None, 33, "cpu")
    batch = kt.read_batch(codes, None, 17, "cpu")
    for c in (0, 18):
        with pytest.raises(ValueError):
            kt.syncmer_batch(batch, c)
    with pytest.raises(ValueError):
        kt.split_kmers_batch(batch._replace(off=batch.off.int()), MIN_BQ)


def test_card_route_without_card_raises():
    """--device cuda never falls back to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the route runs there")
    codes = [np.arange(50, dtype=np.uint8) % 4]
    with pytest.raises(RuntimeError):
        split_kmer_count(codes, None, 17, MIN_BQ, "cuda")
    with pytest.raises(RuntimeError):
        kt.device_split_kmers(codes, None, 17, MIN_BQ, "cuda")
