"""FASTQ/FASTA ingestion (the reference's needletail role, seq_parse.rs).

Pure-Python host parser with gzip support.  A C++ extension
(native/fastx.cpp) does the work when it builds: it inflates on threads of
its own (one gzip member over several cores where the caller gives it
threads) and splits lines in large blocks, and the records reach Python in
chunks; this module's parser is the fallback, and the yardstick the native
one is held to.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass


@dataclass(slots=True)
class FastxRecord:
    id: str  # full header line without '>'/'@'
    seq: bytes
    qual: bytes | None  # ASCII quality string, None for FASTA


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=1 << 20)
    return io.BufferedReader(f, buffer_size=1 << 20)


_NATIVE = None
_NATIVE_TRIED = False


def _native_lib():
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes

    from ..ops.native_build import build_extra

    so = build_extra("fastx", extra_link=["-lz", "-pthread"], extra_cflags=["-pthread"])
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.fastx_parse.restype = ctypes.c_void_p
    lib.fastx_parse.argtypes = [ctypes.c_char_p]
    for fn in ("fastx_seq_buf", "fastx_qual_buf", "fastx_head_buf"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("fastx_seq_off", "fastx_qual_off", "fastx_head_off"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_int64)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fastx_n_records.restype = ctypes.c_int64
    lib.fastx_n_records.argtypes = [ctypes.c_void_p]
    lib.fastx_free.argtypes = [ctypes.c_void_p]
    _NATIVE = lib
    return _NATIVE


def _records_from_chunk(lib, h) -> list[FastxRecord]:
    """Slice one native ParseState handle into FastxRecords (frees it)."""
    import ctypes

    import numpy as np

    try:
        n = lib.fastx_n_records(h)
        if n == 0:
            return []
        # one bulk copy of each offset table into Python ints: ctypes
        # pointer __getitem__ costs ~0.3 us per access, which dominated
        # the per-record loop at 6 lookups/record
        so = np.ctypeslib.as_array(lib.fastx_seq_off(h), (n + 1,)).tolist()
        qo = np.ctypeslib.as_array(lib.fastx_qual_off(h), (n + 1,)).tolist()
        ho = np.ctypeslib.as_array(lib.fastx_head_off(h), (n + 1,)).tolist()
        seq_buf = ctypes.string_at(lib.fastx_seq_buf(h), so[n])
        qual_buf = ctypes.string_at(lib.fastx_qual_buf(h), qo[n])
        head_buf = ctypes.string_at(lib.fastx_head_buf(h), ho[n])
    finally:
        lib.fastx_free(h)
    # one list comprehension (a generator resumption per record cost ~1 us
    # x 100k reads in the parse pass)
    return [
        FastxRecord(
            head_buf[ho[i] : ho[i + 1]].decode(),
            seq_buf[so[i] : so[i + 1]],
            qual_buf[qo[i] : qo[i + 1]] or None,
        )
        for i in range(n)
    ]


def _read_fastx_native(lib, path: str) -> list[FastxRecord]:
    h = lib.fastx_parse(path.encode())
    if not h:
        raise ValueError(f"{path}: not FASTA/FASTQ (native parser)")
    return _records_from_chunk(lib, h)


# compressed bytes a chunk of the native parallel inflate (kChunk in
# native/fastx.cpp): a 4 MiB chunk of a FASTA inflates in about 0.1 s on one
# core, so the first records come soon and the last chunk ends soon after
# the others, while each chunk's search for its first block, and its first
# 32 KiB decoded without the window, stay small beside it
CHUNK_BYTES = 4 << 20

# a native stream's inflate counts: workers of the parallel path (0 where
# one thread inflates), chunks that started speculatively and were verified,
# chunks the real decode went through itself (false or missing starts), and
# 1 where the parallel path handed the file back to gzread
INFLATE_COUNTS = ("inflate_workers", "inflate_chunks_spec", "inflate_chunks_redo", "inflate_fallback")


def read_fastx_stream(path: str, chunk_records: int = 32768, threads: int = 1,
                      chunk_bytes: int | None = None, counts: dict | None = None):
    """Yield lists of FastxRecords, chunk_records at a time, while the file
    is still being decompressed — lets ingestion pipeline with downstream
    counting (seq_parse.rs:87-122 channel analog).  A gzip file of two
    chunks of chunk_bytes compressed bytes or more (None: CHUNK_BYTES) is
    inflated by threads - 1 workers where that is 2 or more (and the host
    has the cores), else by one thread; the records are the same.  Where
    `counts` is given, the stream's inflate counts are added to it when it
    ends (INFLATE_COUNTS).  Falls back to one-shot parsing (a single yield)
    without the native lib."""
    lib = _native_lib()
    if lib is None or not hasattr(lib, "fastx_open"):
        recs = read_fastx_records(path)
        for s in range(0, len(recs), chunk_records) or [0]:
            yield recs[s : s + chunk_records]
        return
    import ctypes

    if not hasattr(lib.fastx_open, "_savont_bound"):
        lib.fastx_open.restype = ctypes.c_void_p
        lib.fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64]
        lib.fastx_next.restype = ctypes.c_void_p
        lib.fastx_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fastx_inflate_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.fastx_close.argtypes = [ctypes.c_void_p]
        lib.fastx_open._savont_bound = True
    sh = lib.fastx_open(path.encode(), max(1, int(threads)),
                        CHUNK_BYTES if chunk_bytes is None else int(chunk_bytes))
    if not sh:
        raise ValueError(f"{path}: not FASTA/FASTQ (native parser)")
    try:
        first = True
        while True:
            h = lib.fastx_next(sh, chunk_records)
            recs = _records_from_chunk(lib, h)
            if not recs:
                if first:
                    yield []  # empty file: one empty chunk
                return
            first = False
            yield recs
    finally:
        if counts is not None:
            got = (ctypes.c_int64 * len(INFLATE_COUNTS))()
            lib.fastx_inflate_counts(sh, got)
            for key, v in zip(INFLATE_COUNTS, got):
                counts[key] = counts.get(key, 0) + int(v)
        lib.fastx_close(sh)


def read_fastx_records(path: str) -> list[FastxRecord]:
    """All records as ONE list (native fast path builds it directly; the
    generator API wraps this)."""
    lib = _native_lib()
    if lib is not None:
        return _read_fastx_native(lib, path)
    return list(_read_fastx_python(path))


def read_fastx(path: str):
    """Yield FastxRecord from a FASTA/FASTQ(.gz) file as it is read: the C++
    parser's chunks one record at a time where it builds, the pure-Python
    parser's records otherwise."""
    if _native_lib() is not None:
        for recs in read_fastx_stream(path):
            yield from recs
        return
    yield from _read_fastx_python(path)


def _read_fastx_python(path: str):
    with _open(path) as f:
        first = f.peek(1)[:1]
        if first == b"@":
            while True:
                h = f.readline()
                if not h:
                    break
                seq = f.readline().rstrip(b"\r\n")
                f.readline()  # +
                qual = f.readline().rstrip(b"\r\n")
                yield FastxRecord(h[1:].rstrip(b"\r\n").decode(), seq, qual)
        elif first == b">":
            header = None
            chunks: list[bytes] = []
            for line in f:
                if line.startswith(b">"):
                    if header is not None:
                        yield FastxRecord(header, b"".join(chunks), None)
                    header = line[1:].rstrip(b"\r\n").decode()
                    chunks = []
                else:
                    chunks.append(line.strip())
            if header is not None:
                yield FastxRecord(header, b"".join(chunks), None)
        elif first == b"":
            return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")

