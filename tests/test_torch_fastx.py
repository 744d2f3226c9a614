"""The port's native FASTA/FASTQ stream (savont_tpu_torch/native/fastx.cpp:
a thread of the stream's own inflates, the caller's thread splits lines in
blocks) against the pure-Python parser of io/fastx.py, record by record and
byte for byte, and on FASTQ also against the JAX package's reader: the
records `asv` reads are unchanged.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fastx.py -q
"""
import gzip
import re
import threading
from pathlib import Path

import numpy as np
import pytest

from savont_tpu.io import fastx as jax_fastx
from savont_tpu_torch.io import fastx

SRC = Path(fastx.__file__).resolve().parent.parent / "native" / "fastx.cpp"


def _block() -> int:
    """The native inflater's block size (kBlock in fastx.cpp)."""
    m = re.search(r"constexpr size_t kBlock = (\d+) << (\d+);", SRC.read_text())
    return int(m[1]) << int(m[2])


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


def test_not_fastx_and_missing_files_raise(tmp_path):
    (tmp_path / "x.txt").write_bytes(b"hello\n")
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        list(fastx.read_fastx(str(tmp_path / "x.txt")))
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        list(fastx.read_fastx(str(tmp_path / "missing.fa")))
