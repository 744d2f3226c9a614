"""The port's native FASTA/FASTQ stream (savont_tpu_torch/native/fastx.cpp:
threads of the stream's own inflate, the caller's thread splits lines in
blocks) against the pure-Python parser of io/fastx.py, record by record and
byte for byte, and on FASTQ also against the JAX package's reader: the
records `asv` reads are unchanged.  Its parallel inflate (one gzip member
on several workers, from speculative block starts) against its one-thread
path and Python's gzip, with chunks made small so that small files cut
into many: one and many members, levels 0-9, fixed-Huffman and empty
members, plain files, truncated and corrupted files.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fastx.py -q
"""
import gzip
import os
import re
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest

from savont_tpu.io import fastx as jax_fastx
from savont_tpu_torch.io import fastx

SRC = Path(fastx.__file__).resolve().parent.parent / "native" / "fastx.cpp"


def _src_const(name: str) -> int:
    """A constant `a << b` of fastx.cpp."""
    m = re.search(rf"constexpr \w+ {name} = (\d+) << (\d+);", SRC.read_text())
    return int(m[1]) << int(m[2])


def _block() -> int:
    """The native inflater's block size (kBlock in fastx.cpp)."""
    return _src_const("kBlock")


def _rows(recs) -> list[tuple]:
    return [(r.id, r.seq, r.qual or None) for r in recs]


def _fasta(rng, n: int, width: int, crlf: bool = False, blank: bool = False) -> bytes:
    """n records of 0-3,000 random bases (with a lowercase and an RNA run)
    in lines of `width`, headers with spaces and tabs."""
    end = b"\r\n" if crlf else b"\n"
    out = []
    for i in range(n):
        seq = rng.choice(np.frombuffer(b"ACGTNacgu", np.uint8), int(rng.integers(0, 3000))).tobytes()
        out.append(b">rec%d some description\twith a tab" % i + end)
        out += [seq[j:j + width] + end for j in range(0, len(seq), width)]
        if blank:
            out.append(end)
    return b"".join(out)


def _fastq(rng, n: int, crlf: bool = False) -> bytes:
    end = b"\r\n" if crlf else b"\n"
    out = []
    for i in range(n):
        L = int(rng.integers(1, 2000))
        out += [b"@read%d runid=x ch=%d" % (i, i % 512) + end,
                rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes() + end, b"+" + end,
                rng.integers(33, 75, L, dtype=np.uint8).tobytes() + end]
    return b"".join(out)


def _cases(rng) -> dict[str, bytes]:
    """name -> (file name, bytes written to it)."""
    big = _fasta(rng, 4000, 60)
    return {
        "wrapped_crlf.fa.gz": gzip.compress(_fasta(rng, 300, 60, crlf=True), 1),
        "blank_lines.fa.gz": gzip.compress(b"\n" .join([b">a", b"ACGT", b"", b"GG", b">b", b"",
                                                        b">c d", b"TTTT", b"", b""]), 6),
        "blank_records.fa": _fasta(rng, 50, 70, blank=True),
        # a record, and a line, across the inflater's blocks: more than two blocks of text
        "across_blocks.fa.gz": gzip.compress(big * (2 * _block() // len(big) + 1), 1),
        "two_members.fa.gz": gzip.compress(_fasta(rng, 40, 60), 1) + gzip.compress(_fasta(rng, 40, 80), 9),
        "no_final_newline.fa": _fasta(rng, 3, 60).rstrip(b"\n") + b"\r",
        "empty.fa": b"",
        "empty.fa.gz": gzip.compress(b""),
        "reads.fq.gz": gzip.compress(_fastq(rng, 3000), 1),
        "reads_crlf.fq": _fastq(rng, 200, crlf=True),
        "reads_two_members.fq.gz": gzip.compress(_fastq(rng, 100), 1) + gzip.compress(_fastq(rng, 100), 1),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fastx")
    for name, data in _cases(np.random.default_rng(95)).items():
        (d / name).write_bytes(data)
    return d


NAMES = sorted(_cases(np.random.default_rng(95)))


@pytest.mark.parametrize("name", NAMES)
def test_native_stream_equals_python_parser(files, name):
    """Every record of the native stream, whole and in chunks of 7 records,
    equals the Python parser's, byte for byte."""
    assert fastx._native_lib() is not None
    path = str(files / name)
    want = _rows(fastx._read_fastx_python(path))
    assert _rows(fastx.read_fastx(path)) == want
    assert _rows(fastx.read_fastx_records(path)) == want
    chunks = list(fastx.read_fastx_stream(path, 7))
    assert [r for c in chunks for r in _rows(c)] == want
    assert all(len(c) == 7 for c in chunks[:-1])
    if name == "across_blocks.fa.gz":
        text = gzip.decompress((files / name).read_bytes())
        # a line runs across the first block's end
        assert len(text) > 2 * _block() and b"\n" not in text[_block() - 1:_block() + 1]
        assert len(want) >= 8000
    if name.startswith("empty"):
        assert want == [] and chunks == [[]]


@pytest.mark.parametrize("name", [n for n in NAMES if ".fq" in n])
def test_fastq_records_equal_the_jax_packages(files, name):
    """The records `asv` reads are the JAX package's reader's."""
    path = str(files / name)
    assert _rows(fastx.read_fastx(path)) == _rows(jax_fastx.read_fastx(path))
    assert all(r.qual is not None and len(r.qual) == len(r.seq) for r in fastx.read_fastx(path))


def test_stream_closed_early_ends_its_thread(files):
    """A stream left after its first record (the inflating thread blocked on
    a full queue) closes without waiting for the rest of the file; the file
    reads whole again after."""
    path = str(files / "across_blocks.fa.gz")

    def first_only():
        for _ in fastx.read_fastx(path):
            break

    t = threading.Thread(target=first_only)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert sum(1 for _ in fastx.read_fastx(path)) >= 8000


def test_parallel_stream_closed_early_ends_its_workers(files):
    """The same on the parallel path: its workers and sequencer, blocked on
    full queues, end when the stream closes after its first record."""
    path = str(files / "across_blocks.fa.gz")

    def first_only():
        for _ in fastx.read_fastx_stream(path, 7, 4, 1 << 16):
            break

    t = threading.Thread(target=first_only)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert sum(len(c) for c in fastx.read_fastx_stream(path, 4096, 4, 1 << 16)) >= 8000


def test_not_fastx_and_missing_files_raise(tmp_path):
    (tmp_path / "x.txt").write_bytes(b"hello\n")
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        list(fastx.read_fastx(str(tmp_path / "x.txt")))
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        list(fastx.read_fastx(str(tmp_path / "missing.fa")))


# ---- the parallel inflate ----------------------------------------------------

SMALL_CHUNK = 8192  # compressed bytes a chunk: the parity files cut into 10-60 chunks
WORKERS = min(4, os.cpu_count() or 1) - 1  # the parallel path's workers at threads=4


def _members(text: bytes, size: int, level: int) -> bytes:
    return b"".join(gzip.compress(text[i:i + size], level, mtime=0) for i in range(0, len(text), size))


def _strategy(text: bytes, strategy: int) -> bytes:
    """A gzip member under one of zlib's strategies: Z_FIXED, fixed-Huffman
    blocks only (none is a start the scan looks for: the real decode goes
    through every chunk); Z_RLE, copies at distance 1 only; Z_HUFFMAN_ONLY,
    literals only."""
    z = zlib.compressobj(6, zlib.DEFLATED, 31, 8, strategy)
    return z.compress(text) + z.flush()


def _stored_deflate(text: bytes) -> bytes:
    """A stored (level 0) member whose bytes are a raw deflate stream of
    text, as in a gzip of compressed data: the scan finds starts there that
    decode, and the real decode, copying stored blocks, never lands on
    them.  No line of it starts with '>', so it parses as one record."""
    z = zlib.compressobj(6, zlib.DEFLATED, -15)
    inner = (z.compress(text) + z.flush()).replace(b"\n>", b"\n<")
    return gzip.compress(b">stored deflate\n" + inner, 0, mtime=0)


def _parallel_cases() -> dict[str, bytes]:
    rng = np.random.default_rng(23)
    fa, fq = _fasta(rng, 500, 60), _fastq(rng, 600)
    tiny = _fasta(rng, 2, 60)
    return {
        "fa_one_l1.fa.gz": gzip.compress(fa, 1, mtime=0),
        "fa_one_l6.fa.gz": gzip.compress(fa, 6, mtime=0),
        "fa_one_l9.fa.gz": gzip.compress(fa, 9, mtime=0),
        "fa_many_l1.fa.gz": _members(fa, 60000, 1),
        "fq_one_l1.fq.gz": gzip.compress(fq, 1, mtime=0),
        "fq_one_l9.fq.gz": gzip.compress(fq, 9, mtime=0),
        "fq_many_l6.fq.gz": _members(fq, 50000, 6),
        "stored_l0.fa.gz": gzip.compress(fa[:300000], 0, mtime=0),
        "stored_deflate.fa.gz": _stored_deflate(fa),
        "fixed_huffman.fa.gz": _strategy(fa[:200000], zlib.Z_FIXED),
        "fixed_tiny_among.fa.gz": (gzip.compress(fa[:150000], 1) + _strategy(tiny, zlib.Z_FIXED)
                                   + gzip.compress(fa[150000:300000], 1)),
        "rle.fq.gz": _strategy(fq, zlib.Z_RLE),
        "huffman_only.fa.gz": _strategy(fa[:300000], zlib.Z_HUFFMAN_ONLY),
        "empty_among.fa.gz": gzip.compress(fa[:200000], 6) + gzip.compress(b"") + gzip.compress(fa[200000:400000], 6),
        "plain.fa": fa,
    }


PARALLEL_NAMES = sorted(_parallel_cases())


@pytest.fixture(scope="module")
def parallel_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    for name, data in _parallel_cases().items():
        (d / name).write_bytes(data)
    return d


def _stream(path, threads: int, chunk: int | None = SMALL_CHUNK, counts: dict | None = None) -> list[tuple]:
    return [r for c in fastx.read_fastx_stream(str(path), 97, threads, chunk, counts) for r in _rows(c)]


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("name", PARALLEL_NAMES)
def test_parallel_inflate_equals_one_thread_and_python_gzip(parallel_files, name, threads):
    """The records of a stream inflated from small chunks on threads - 1
    workers equal the one-thread path's and Python's gzip's, byte for byte;
    the parallel path engages on gzip input of two chunks or more, from
    three threads, and never hands the file back to gzread here."""
    path = parallel_files / name
    counts: dict = {}
    got = _stream(path, threads, counts=counts)
    assert got == _stream(path, 1, None)
    if name == "stored_deflate.fa.gz":
        # binary lines: the Python parser strips every space from a line's
        # ends, the native one a '\r'; the bytes are held to Python's gzip
        lines = gzip.decompress(path.read_bytes()).split(b"\n")[1:]
        assert len(got) == 1 and got[0][1] == b"".join(ln[:-1] if ln.endswith(b"\r") else ln for ln in lines)
    else:
        assert got == _rows(fastx._read_fastx_python(str(path))) and len(got) >= 50
    parallel = name.endswith(".gz") and threads == 4 and WORKERS >= 2
    assert counts["inflate_workers"] == (WORKERS if parallel else 0)
    assert counts["inflate_fallback"] == 0
    n_chunks = -(-path.stat().st_size // SMALL_CHUNK)
    if parallel:
        # every chunk after the first either started speculatively or was decoded again
        assert counts["inflate_chunks_spec"] + counts["inflate_chunks_redo"] <= n_chunks - 1
        if "fixed" not in name and "stored" not in name:
            assert counts["inflate_chunks_spec"] > 0
    else:
        assert counts["inflate_chunks_spec"] == counts["inflate_chunks_redo"] == 0


@pytest.fixture(scope="module")
def big_member(tmp_path_factory):
    """About 12 MB of FASTA text as one gzip member, and as many: more than
    the parallel path holds back before it hands bytes out (kHorizon)."""
    rng = np.random.default_rng(29)
    text = _fasta(rng, 8000, 60)
    assert len(text) > _block() + 4 * _src_const("kGzBuffer")
    d = tmp_path_factory.mktemp("big")
    (d / "one.fa.gz").write_bytes(gzip.compress(text, 1, mtime=0))
    (d / "many.fa.gz").write_bytes(_members(text, 1 << 20, 1))
    return d


def test_one_member_engages_the_workers(big_member):
    """One gzip member of many chunks is inflated from speculative starts,
    each verified where the real decode lands on it; its records equal the
    same text's in many members, on either path."""
    if WORKERS < 2:
        pytest.skip(f"the parallel path takes 2 workers or more; this host has {os.cpu_count()} CPUs")
    one, many = big_member / "one.fa.gz", big_member / "many.fa.gz"
    counts: dict = {}
    got = _stream(one, 4, 1 << 18, counts)
    n_chunks = -(-one.stat().st_size // (1 << 18))
    assert counts["inflate_workers"] == WORKERS and counts["inflate_fallback"] == 0
    # every chunk after the first is verified, but one the chunk before it
    # decodes to the end of the file (no block starts in it)
    assert n_chunks - 2 <= counts["inflate_chunks_spec"] <= n_chunks - 1
    assert counts["inflate_chunks_redo"] == 0
    assert got == _stream(many, 4, 1 << 18) == _stream(one, 1) == _stream(many, 1)
    assert len(got) == 8000


def test_chunk_default_matches_source():
    assert fastx.CHUNK_BYTES == _src_const("kChunk")


def _corrupt(data: bytes, how: str) -> bytes:
    if how == "truncated":
        return data[:len(data) * 3 // 5]
    b = bytearray(data)
    at = {"flip_early": len(b) // 5, "flip_late": len(b) * 4 // 5, "flip_crc": len(b) - 6}[how]
    b[at] ^= 0x10
    return bytes(b)


@pytest.mark.parametrize("how", ["truncated", "flip_early", "flip_late", "flip_crc"])
@pytest.mark.parametrize("src", ["big", "small"])
def test_damaged_files_read_as_the_one_thread_path_reads_them(tmp_path, big_member, parallel_files, how, src):
    """A truncated file, and a file with one byte flipped in its deflate
    data or its CRC, give the one-thread path's records (gzread's, up to
    where it stops), whether the parallel path finds the fault before it
    hands out any byte or tens of MB after."""
    data = (big_member / "one.fa.gz" if src == "big" else parallel_files / "fa_one_l6.fa.gz").read_bytes()
    path = tmp_path / "damaged.fa.gz"
    path.write_bytes(_corrupt(data, how))
    counts: dict = {}
    got = _stream(path, 4, 1 << 16 if src == "big" else SMALL_CHUNK, counts)
    assert got == _stream(path, 1, None)
    assert counts["inflate_fallback"] == (1 if WORKERS >= 2 else 0)
