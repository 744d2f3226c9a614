"""Stage 1: k-mer counting and SNPmer calling; Stage 1.5: TwinRead building.

Reference: seq_parse.rs (counting passes), kmer_comp.rs (SNPmer calling and
TwinRead construction).  The reference's 3-tier thread/channel pipeline and
sharded hash maps become a sort/segment-reduce over all reads' split k-mers.
"""
from __future__ import annotations

import logging

import numpy as np

from ..config import ClusterArgs
from ..constants import MAX_KMER_COUNT_IN_READ
from ..core import KmerGlobalInfo, SnpmerInfo, TwinRead, compute_lsh_signatures_batch
from ..io.fastx import read_fastx
from ..ops.encode import (
    bin_qualities,
    encode_seq,
    estimate_sequence_identity,
    phred_from_ascii,
    quantize_qual_bin,
    revcomp_bytes,
)
from ..ops.kmers import (
    blockmer_hits_scan,
    blockmer_scan,
    count_blockmers,
    count_flagged_kmers,
    count_flagged_kmers_streaming,
    filter_counted_kmers,
    kmer_at_position_batch,
    masked_kmer,
    mid_base,
    split_kmer_mid,
    syncmer_and_snpmer_scan,
)
from ..ops.stats import binomial_test_gt, snpmer_strand_test
from ..tracing import part, span

log = logging.getLogger("savont")


_READ_CACHE: dict[str, list] = {}
_READ_CACHE_BYTES = 0
_READ_CACHE_LIMIT = 2 << 30  # 2 GB of raw sequence; larger files re-stream


def _cached_records(path: str):
    """Parse a FASTX file once and keep records in memory for the pipeline's
    multiple passes (the reference re-reads the file 3 times)."""
    global _READ_CACHE_BYTES
    recs = _READ_CACHE.get(path)
    if recs is not None:
        return recs
    from ..io.fastx import read_fastx_records

    recs = read_fastx_records(path)
    size = sum(len(r.seq) * 2 for r in recs)
    if _READ_CACHE_BYTES + size <= _READ_CACHE_LIMIT:
        _READ_CACHE[path] = recs
        _READ_CACHE_BYTES += size
    return recs


_ENCODE_CACHE: dict[str, tuple[list, list, list]] = {}
_ENCODE_CACHE_MAX_PATHS = 8


def _cached_encoded(path: str) -> tuple[list, list]:
    """2-bit codes + phred vectors aligned with _cached_records(path),
    computed once per parse (the counting pass and TwinRead construction
    both encode the same reads).  The entry holds the records list itself
    and validates with `is` (an id() key could be recycled after
    _READ_CACHE.clear() frees the old list); stale entries are dropped
    eagerly so cleared parses release their encodes too.  Uncached record
    lists (over the size limit) are re-encoded, never stored."""
    recs = _cached_records(path)
    hit = _ENCODE_CACHE.get(path)
    if hit is not None:
        if hit[0] is recs and _READ_CACHE.get(path) is recs:
            return hit[1], hit[2]
        del _ENCODE_CACHE[path]  # stale parse: free the old encodes
    codes, phred = _batch_encode([r.seq for r in recs], [r.qual for r in recs])
    if _READ_CACHE.get(path) is recs:
        if len(_ENCODE_CACHE) >= _ENCODE_CACHE_MAX_PATHS:
            _ENCODE_CACHE.clear()
        _ENCODE_CACHE[path] = (recs, codes, phred)
    return codes, phred


def _batch_encode(seqs: list[bytes], quals: list):
    """One-pass 2-bit encode + phred decode for a batch of reads: one LUT
    gather / one subtract over concatenated buffers, per-read views out.
    BIT-IDENTICAL to per-read encode_seq / phred_from_ascii (elementwise)."""
    from ..ops.encode import _BYTE_TO_CODE

    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    flat = (
        np.frombuffer(b"".join(seqs), np.uint8) if int(off[-1]) else np.zeros(0, np.uint8)
    )
    codes_all = _BYTE_TO_CODE[flat]
    codes_list = [codes_all[off[i] : off[i + 1]] for i in range(n)]
    phred_list: list = [None] * n
    qidx = [i for i in range(n) if quals[i] is not None]
    if qidx:
        qlens = np.fromiter((len(quals[i]) for i in qidx), np.int64, len(qidx))
        qoff = np.zeros(len(qidx) + 1, np.int64)
        np.cumsum(qlens, out=qoff[1:])
        # phred stays uint8: ascii-33 is [0, 93] for valid quality bytes, and
        # downstream scan kernels consume uint8 planes directly (the _concat
        # fast path then hands the parent span over with zero copies).
        # Sub-33 ascii wraps exactly like the reference's u8 arithmetic.
        qflat = (
            np.frombuffer(b"".join(quals[i] for i in qidx), np.uint8) - np.uint8(33)
            if int(qoff[-1])
            else np.zeros(0, np.uint8)
        )
        for j, i in enumerate(qidx):
            phred_list[i] = qflat[qoff[j] : qoff[j + 1]]
    return codes_list, phred_list


_PURE_ACGT = np.zeros(256, dtype=np.uint8)
for _b in b"ACGT":
    _PURE_ACGT[_b] = 1


def _pure_acgt_batch(seqs: list[bytes]) -> np.ndarray:
    """Per-read flag: every byte is uppercase ACGT.  Native one-pass scan
    straight off the bytes objects when available, else one LUT gather +
    segment reduction over the concatenated buffer."""
    from ..ops.kmers_native import pure_acgt_batch_native

    n = len(seqs)
    nat = pure_acgt_batch_native(seqs) if n else None
    if nat is not None:
        return nat
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    if int(off[-1]) == 0:
        return np.ones(n, dtype=bool)
    good = _PURE_ACGT[np.frombuffer(b"".join(seqs), np.uint8)]
    # non-ACGT bytes are rare: locate them and mark their owner reads
    # (cumsum/reduceat with u8->int64 casting is a ~40-74 ns/elem buffered
    # path — 5-11 s at 150 MB)
    bad = np.flatnonzero(good == 0)
    pure = np.ones(n, dtype=bool)
    if len(bad):
        pure[np.searchsorted(off, bad, side="right") - 1] = False
    return pure


def _iter_reads_for_counting(files: list[str]):
    """Counting passes handle the cutadapt 'rc' header suffix by
    reverse-complementing (seq_parse.rs:139-147)."""
    for path in files:
        for rec in _cached_records(path):
            fields = rec.id.split()
            if fields and fields[-1] == "rc":
                seq = revcomp_bytes(rec.seq)
                qual = rec.qual[::-1] if rec.qual is not None else None
            else:
                seq, qual = rec.seq, rec.qual
            yield seq, qual


# stage 1's count by part, summed over calls: seconds of parse + encode,
# of the host scan + count (the host route's streamed count includes its
# parse), and of the strand filter; reads, positions, flagged k-mers and
# distinct k-mers (device route), and the route of the last call.  The asv
# stage's parts (tracing.part) split the same time: "1.feed_wait", the count
# loop waiting for the feeder's parse + encode; "1.count", the scan, count
# and merge (the host count, or the device route's) and the strand filter
COUNT_STATS = {"calls": 0, "route": "", "reads": 0, "positions": 0, "flagged": 0, "distinct": 0,
               "parse_encode_s": 0.0, "host_count_s": 0.0, "filter_s": 0.0}


def reset_count_stats() -> None:
    for key, v in COUNT_STATS.items():
        COUNT_STATS[key] = type(v)()


def read_to_split_kmers(args: ClusterArgs) -> tuple[np.ndarray, np.ndarray]:
    """Count canonical split k-mers with strand-split counts over all input
    files (seq_parse.rs:12-78).  Returns (kmers sorted, counts[n,2]) after
    the both-strands/multiplicity filter.  args.stage1_backend "mesh" runs
    the extraction (kernel 4) and, without -b, the count on args.device."""
    from ..ops.kmers_native import get_scan_lib

    k = args.kmer_size
    stats = COUNT_STATS
    stats["calls"] += 1
    stats["route"] = args.stage1_backend
    on_device = args.stage1_backend == "mesh"
    if args.aggressive_bloom and args.bloom_filter_size <= 0:
        log.warning(
            "--aggressive-bloom has no effect without -b/--bloom-filter-size: "
            "counting is exact, and the aggressive admission rule only "
            "applies to the Bloom prefilter pass (seq_parse.rs:225-258)"
        )
    if (
        not on_device
        and args.bloom_filter_size <= 0
        and get_scan_lib() is not None
        and _sortcount_available()
    ):
        # pipelined ingestion (seq_parse.rs:87-122 channel analog): a
        # feeder thread parses + encodes 32k-record chunks while this
        # thread scans + counts the previous chunk in native OpenMP code
        # (which releases the GIL).  Counting is per-k-mer commutative, so
        # chunk boundaries cannot change the result (same merge as
        # _count_chunked_native; parity pinned by tests).
        with span(None, stats, "host_count_s"):
            kmers, counts, n_reads = _streamed_count(args)
        stats["reads"] += n_reads
        return _finish_split_kmers(kmers, counts, n_reads, args)

    with span(None, stats, "parse_encode_s"):
        codes_list, phred_list = _counting_encodes(args.input_files)
    n_reads = len(codes_list)
    stats["reads"] += n_reads
    per_read = None
    if on_device:
        # the device route (the reference's SAVONT_DEVICE_KMERS branch):
        # kernel 4 over the whole batch; without -b the count stays on the
        # device too and one table comes back
        if args.bloom_filter_size <= 0:
            from ..parallel.mesh import split_kmer_count

            with part("count"):
                kmers, counts = split_kmer_count(
                    codes_list, phred_list, k, args.minimum_base_quality, args.device, stats
                )
            return _finish_split_kmers(kmers, counts, n_reads, args)
        from ..ops.kmers_torch import device_split_kmers

        per_read = device_split_kmers(
            codes_list, phred_list, k, args.minimum_base_quality, args.device, stats
        )
    with part("count", also=(stats, "host_count_s")):
        kmers, counts = _host_count(codes_list, phred_list, per_read, args)
    return _finish_split_kmers(kmers, counts, n_reads, args)


def _counting_encodes(files: list[str]) -> tuple[list, list]:
    """Every read's codes and phreds for counting: the cached per-path
    encodes (stage 1.5 reuses them), 'rc'-tagged reads re-encoded from the
    flipped bytes — code-level revcomp would differ on non-ACGT bytes
    (revcomp_bytes maps them to N=code 0, not 3-code)."""
    codes_list, phred_list = [], []
    rc_rows: list[int] = []
    rc_seqs: list[bytes] = []
    rc_quals: list = []
    for path in files:
        enc_c, enc_p = _cached_encoded(path)
        for rec, c, p in zip(_cached_records(path), enc_c, enc_p):
            fields = rec.id.split()
            if fields and fields[-1] == "rc":
                rc_rows.append(len(codes_list))
                rc_seqs.append(revcomp_bytes(rec.seq))
                rc_quals.append(rec.qual[::-1] if rec.qual is not None else None)
            codes_list.append(c)
            phred_list.append(p)
    if rc_rows:  # one batched re-encode for every 'rc'-tagged read
        rc_c, rc_p = _batch_encode(rc_seqs, rc_quals)
        for i, c, p in zip(rc_rows, rc_c, rc_p):
            codes_list[i] = c
            phred_list[i] = p
    return codes_list, phred_list


def _host_count(codes_list, phred_list, per_read, args: ClusterArgs):
    """The host count of every read's flagged split k-mers: per_read where
    the device extracted them, else the native (or numpy) scan first."""
    from ..ops.kmers_native import get_scan_lib, split_kmers_native

    k = args.kmer_size
    if per_read is None:
        if get_scan_lib() is not None:
            per_read = split_kmers_native(codes_list, phred_list, k, args.minimum_base_quality)
        else:
            per_read = [
                split_kmer_mid(c, p, k, args.minimum_base_quality)
                for c, p in zip(codes_list, phred_list)
            ]
    if args.bloom_filter_size <= 0:
        return count_flagged_kmers(per_read, threads=args.threads)
    # -b: the reference's Bloom-prefiltered low-memory counting mode
    # (seq_parse.rs:80-314).  Exact chunked merge, identical output.
    kmers, counts = count_flagged_kmers_streaming(per_read)
    if args.aggressive_bloom:
        # seq_parse.rs:232-258: admission needs an occurrence with a
        # prior same-strand AND prior other-strand sighting (exact
        # Bloom semantics, i.e. no false-positive admissions)
        from ..ops.kmers import aggressive_bloom_admitted

        admitted = aggressive_bloom_admitted(per_read)
        if len(admitted):
            pos = np.minimum(np.searchsorted(admitted, kmers), len(admitted) - 1)
            keep = admitted[pos] == kmers
        else:
            keep = np.zeros(len(kmers), dtype=bool)
        n_drop = int(len(kmers) - keep.sum())
        kmers, counts = kmers[keep], counts[keep]
        log.info(
            "--aggressive-bloom: %d k-mers dropped by strict two-strand admission",
            n_drop,
        )
    return kmers, counts


def _finish_split_kmers(
    kmers: np.ndarray, counts: np.ndarray, n_reads: int, args: ClusterArgs
) -> tuple[np.ndarray, np.ndarray]:
    """Shared strand/multiplicity filter + starvation abort
    (seq_parse.rs:69-72)."""
    raw_n = len(kmers)
    with part("count", also=(COUNT_STATS, "filter_s")):
        kmers, counts = filter_counted_kmers(kmers, counts, args.single_strand)
    log.info("counted %d reads; %d split-kmers, %d retained after strand filter", n_reads, raw_n, len(kmers))
    if raw_n > 0 and len(kmers) < raw_n / 1000:
        raise SystemExit(
            "Less than 0.1% of SNPmers have counts > 1 in both strands and > 2 "
            "multiplicity (seq_parse.rs:69-72). Consider --single-strand."
        )
    return kmers, counts


def _streamed_count(
    args: ClusterArgs, chunk: int = 32768
) -> tuple[np.ndarray, np.ndarray, int]:
    """Pipelined parse+encode || scan+count over all input files.

    A feeder thread streams 32k-record chunks off the gz file
    (io/fastx.read_fastx_stream, inflated on args.threads - 1 workers where
    the file is gzip of several chunks), 2-bit-encodes them and applies the
    cutadapt 'rc' header flip (seq_parse.rs:139-147) for the counting copy,
    while this thread runs the native split-kmer scan + radix count on the
    previous chunk (OpenMP, GIL released) — the reference's 3-stage channel
    ingestion (seq_parse.rs:87-122) expressed as threads over batches.
    Populates _READ_CACHE/_ENCODE_CACHE with the RAW records/codes exactly
    like _cached_records/_cached_encoded (stage 1.5 reuses them).
    Counting is per-k-mer commutative so chunking cannot change the result
    (bit-identical to _count_chunked_native; tests pin it)."""
    import queue as _queue
    from threading import Thread

    from ..ops.kmers import merge_counted
    from ..ops.kmers_native import count_flagged_native, split_kmers_flat_native

    global _READ_CACHE_BYTES
    k = args.kmer_size
    q: _queue.Queue = _queue.Queue(maxsize=2)
    errs: list[BaseException] = []

    def _rc_swap(recs, codes, phred):
        """Counting copies with 'rc'-tagged reads reverse-complemented —
        EXACTLY the split()[-1] == "rc" predicate every other counting path
        uses (an endswith() fast path would miss trailing-whitespace
        headers and break the bit-identity invariant across env flags)."""
        rc_i, rc_s, rc_q = [], [], []
        for i, rec in enumerate(recs):
            fields = rec.id.split()
            if fields and fields[-1] == "rc":
                rc_i.append(i)
                rc_s.append(revcomp_bytes(rec.seq))
                rc_q.append(rec.qual[::-1] if rec.qual is not None else None)
        if not rc_i:
            return codes, phred
        codes, phred = list(codes), list(phred)
        rc_c, rc_p = _batch_encode(rc_s, rc_q)
        for i, c, p in zip(rc_i, rc_c, rc_p):
            codes[i] = c
            phred[i] = p
        return codes, phred

    def produce():
        global _READ_CACHE_BYTES
        try:
            for path in args.input_files:
                cached = _READ_CACHE.get(path)
                if cached is not None:
                    codes_all, phred_all = _cached_encoded(path)
                    for s in range(0, len(cached), chunk):
                        cc, pp = _rc_swap(
                            cached[s : s + chunk],
                            codes_all[s : s + chunk],
                            phred_all[s : s + chunk],
                        )
                        q.put((cc, pp))
                    continue
                from ..io.fastx import read_fastx_stream

                recs_all: list = []
                codes_all, phred_all = [], []
                for recs in read_fastx_stream(path, chunk, args.threads):
                    codes, phred = _batch_encode(
                        [r.seq for r in recs], [r.qual for r in recs]
                    )
                    recs_all.extend(recs)
                    codes_all.extend(codes)
                    phred_all.extend(phred)
                    cc, pp = _rc_swap(recs, codes, phred)
                    q.put((cc, pp))
                # same retention rules as _cached_records/_cached_encoded
                size = sum(len(r.seq) * 2 for r in recs_all)
                if _READ_CACHE_BYTES + size <= _READ_CACHE_LIMIT:
                    _READ_CACHE[path] = recs_all
                    _READ_CACHE_BYTES += size
                    if len(_ENCODE_CACHE) >= _ENCODE_CACHE_MAX_PATHS:
                        _ENCODE_CACHE.clear()
                    _ENCODE_CACHE[path] = (recs_all, codes_all, phred_all)
        except BaseException as e:  # re-raised on the consumer thread
            errs.append(e)
        finally:
            q.put(None)

    t = Thread(target=produce, daemon=True)
    t.start()
    kmers = np.zeros(0, dtype=np.uint64)
    counts = np.zeros((0, 2), dtype=np.uint32)
    n_reads = 0
    try:
        while True:
            with part("feed_wait"):
                item = q.get()
            if item is None:
                break
            with part("count"):
                codes_c, phred_c = item
                n_reads += len(codes_c)
                allk = split_kmers_flat_native(
                    codes_c, phred_c, k, args.minimum_base_quality, args.threads
                )
                if len(allk):
                    ck, cc2 = count_flagged_native(allk, args.threads)
                    kmers, counts = merge_counted(kmers, counts, ck, cc2)
    finally:
        # unblock a producer stuck on a full queue if we errored out
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except _queue.Empty:
                pass
            t.join(timeout=0.05)
    if errs:
        raise errs[0]
    return kmers, counts, n_reads


def _sortcount_available() -> bool:
    from ..ops.kmers_native import get_sortcount_lib

    return get_sortcount_lib() is not None


def _count_chunked_native(
    codes_list, phred_list, args: ClusterArgs, chunk: int = 32768
) -> tuple[np.ndarray, np.ndarray]:
    # PARITY ORACLE for _streamed_count (which replaced it on the default
    # path): same chunked scan+count+merge over pre-materialized encodes,
    # no threading.  chunk=32768 keeps the per-chunk k-mer stream + radix
    # ping-pong around ~1.1 GB transient (measured 13% faster than 16384
    # at 20k, identical output; the unchunked flat path allocated multi-GB
    # streams)
    from ..ops.kmers import merge_counted
    from ..ops.kmers_native import count_flagged_native, split_kmers_flat_native

    k = args.kmer_size
    kmers = np.zeros(0, dtype=np.uint64)
    counts = np.zeros((0, 2), dtype=np.uint32)
    for s in range(0, len(codes_list), chunk):
        allk = split_kmers_flat_native(
            codes_list[s : s + chunk], phred_list[s : s + chunk],
            k, args.minimum_base_quality, args.threads,
        )
        if len(allk) == 0:
            continue
        ck, cc = count_flagged_native(allk, args.threads)
        kmers, counts = merge_counted(kmers, counts, ck, cc)
    return kmers, counts


def read_blockmer_counts(args: ClusterArgs) -> tuple[np.ndarray, np.ndarray]:
    """Blockmer counting pass (seq_parse.rs blockmer lanes): anchor-canonical
    (k+l)-mers with per-orientation counts, then the strand/multiplicity
    filter (both orientations > 2; single-strand: counts[0] > 2)."""
    k, l = args.kmer_size, args.blockmer_length
    per_read = []
    for seq, qual in _iter_reads_for_counting(args.input_files):
        codes = encode_seq(seq)
        phred = phred_from_ascii(qual) if qual is not None else None
        per_read.append(blockmer_scan(codes, phred, k, l, args.minimum_base_quality))
    kmers, counts = count_blockmers(per_read, threads=args.threads)
    if args.single_strand:
        keep = counts[:, 0] > 2
    else:
        keep = (counts[:, 0] > 0) & (counts[:, 1] > 0) & (counts.sum(axis=1) > 2)
    return kmers[keep], counts[keep]


def get_blockmers(
    blk_kmers: np.ndarray,
    blk_counts: np.ndarray,
    snp_kmers: np.ndarray,
    snp_counts: np.ndarray,
    args: ClusterArgs,
) -> list[tuple[int, tuple[int, int], tuple[int, int]]]:
    """Blockmer calling (kmer_comp.rs:274-452): group by anchor k-mer;
    require > 2 counts per orientation; anchor's SNPmer-count ratio <= 10x;
    binomial + Fisher tests on the top-2 variants.  Returns
    [(anchor, (blockmer1, blockmer2), (count1, count2)), ...]."""
    l = args.blockmer_length
    if len(blk_kmers) == 0:
        return []
    snp_total = {int(k): int(c[0] + c[1]) for k, c in zip(snp_kmers, snp_counts)}
    # per-orientation support filter (kmer_comp.rs:303-311)
    if args.single_strand:
        ok = blk_counts[:, 0] > 2
    else:
        ok = (blk_counts[:, 0] > 2) & (blk_counts[:, 1] > 2)
    blk_kmers, blk_counts = blk_kmers[ok], blk_counts[ok]
    anchors = blk_kmers >> np.uint64(2 * l)
    # anchor vs SNPmer-count ratio (kmer_comp.rs:317-320)
    totals = blk_counts.sum(axis=1).astype(np.int64)
    keep = np.ones(len(blk_kmers), dtype=bool)
    for i, a in enumerate(anchors):
        ac = snp_total.get(int(a), 0)
        if ac > 10 * totals[i]:
            keep[i] = False
    blk_kmers, blk_counts, anchors, totals = blk_kmers[keep], blk_counts[keep], anchors[keep], totals[keep]

    order = np.lexsort((blk_kmers, anchors))
    anchors, blk_kmers, blk_counts, totals = anchors[order], blk_kmers[order], blk_counts[order], totals[order]
    out = []
    bound = np.flatnonzero(np.concatenate(([True], anchors[1:] != anchors[:-1]))) if len(anchors) else np.zeros(0, np.int64)
    ends = np.append(bound[1:], len(anchors))
    for s, e in zip(bound, ends):
        if e - s < 2:
            continue
        seg = np.argsort(-totals[s:e], kind="stable") + s
        i0, i1 = seg[0], seg[1]
        n, succ = int(totals[i0]), int(totals[i1])
        # kmer_comp.rs:364-371: reject if the second allele is noise-consistent
        cond1 = binomial_test_gt(n, succ, 0.025) > 0.05
        cond2 = binomial_test_gt(n, succ, 0.050) > 0.05 and args.blockmer_length < 5
        if cond1 or cond2:
            continue
        p, odds = snpmer_strand_test(blk_counts[i0], blk_counts[i1])
        if not args.single_strand and odds == 0.0:
            continue
        if p > 0.005 or (1.0 / 1.5 < odds < 1.5):
            out.append((int(anchors[i0]), (int(blk_kmers[i0]), int(blk_kmers[i1])), (n, succ)))
    log.info("Number of blockmers found: %d", len(out))
    return out


def get_snpmers(kmers: np.ndarray, counts: np.ndarray, args: ClusterArgs) -> KmerGlobalInfo:
    """SNPmer calling via masked-kmer grouping + binomial/Fisher tests
    (kmer_comp.rs:454-642)."""
    k = args.kmer_size
    if len(kmers) == 0:
        raise SystemExit("No k-mers found. Exiting.")

    totals = counts.sum(axis=1).astype(np.int64)
    sorted_totals = np.sort(totals)
    hf_idx = len(sorted_totals) - (len(sorted_totals) // 100000) - 1
    high_freq_thresh = max(int(sorted_totals[hf_idx]), 100)
    high_freq_kmers = np.sort(kmers[totals > high_freq_thresh])

    info = KmerGlobalInfo(
        snpmer_info=[],
        high_freq_kmers=high_freq_kmers,
        high_freq_thresh=float(high_freq_thresh),
        read_files=list(args.input_files),
    )
    if args.no_snpmers:
        return info

    # group by (masked kmer, mid base) — vectorized sort then segment walk
    masked = masked_kmer(kmers, k)
    mids = mid_base(kmers, k)
    order = np.lexsort((mids, masked))
    masked_s, mids_s, kmers_s, counts_s, totals_s = (
        masked[order], mids[order], kmers[order], counts[order], totals[order],
    )
    if not args.single_strand:
        strand_ok = (counts_s[:, 0] > 0) & (counts_s[:, 1] > 0)
    else:
        strand_ok = np.ones(len(kmers_s), dtype=bool)
    masked_s, mids_s, kmers_s, counts_s, totals_s = (
        masked_s[strand_ok], mids_s[strand_ok], kmers_s[strand_ok],
        counts_s[strand_ok], totals_s[strand_ok],
    )

    # segment boundaries over masked kmer
    if len(masked_s) == 0:
        return info
    bound = np.flatnonzero(np.concatenate(([True], masked_s[1:] != masked_s[:-1])))
    seg_starts = bound
    seg_ends = np.append(bound[1:], len(masked_s))
    multi = (seg_ends - seg_starts) >= 2

    # batch the binomial tests for the top-2 of each multi group
    tops, seconds, groups = [], [], []
    for s, e in zip(seg_starts[multi], seg_ends[multi]):
        seg_tot = totals_s[s:e]
        # stable sort by total desc (ties keep (masked, mid) order — matches
        # Rust insertion-sort behavior on tiny groups)
        ordg = np.argsort(-seg_tot, kind="stable") + s
        tops.append(int(totals_s[ordg[0]]))
        seconds.append(int(totals_s[ordg[1]]))
        groups.append(ordg)
    if not groups:
        return info
    pvals = binomial_test_gt(np.array(tops), np.array(seconds), 0.025)

    snpmers: list[SnpmerInfo] = []
    for gi, ordg in enumerate(groups):
        if pvals[gi] > 0.05:  # cond1: second allele consistent with noise
            continue
        i0, i1 = ordg[0], ordg[1]
        p, odds = snpmer_strand_test(counts_s[i0], counts_s[i1])
        if not args.single_strand and odds == 0.0:
            continue
        if p > 0.005 or (1.0 / 1.5 < odds < 1.5):
            snpmers.append(
                SnpmerInfo(
                    split_kmer=int(masked_s[i0]),
                    mid_bases=(int(mids_s[i0]), int(mids_s[i1])),
                    counts=(int(totals_s[i0]), int(totals_s[i1])),
                    k=k,
                )
            )
    snpmers.sort(key=lambda s: (s.split_kmer, s.mid_bases, s.counts, s.k))
    info.snpmer_info = snpmers
    log.info("Number of snpmers: %d (high-freq thresh %d)", len(snpmers), high_freq_thresh)
    return info


def build_twin_read(
    seq: bytes,
    qual: bytes | None,
    read_id: str,
    args: ClusterArgs,
    snpmer_sorted: np.ndarray,
    blockmer_sorted: np.ndarray | None = None,
) -> TwinRead | None:
    """get_twin_read_syncmer equivalent (seeding.rs:317-658)."""
    k, c = args.kmer_size, args.c
    if len(seq) < k:
        return None
    codes = encode_seq(seq)
    phred = phred_from_ascii(qual) if qual is not None else None

    mini_pos, mini_kmers, snp_pos, snp_kmers = syncmer_and_snpmer_scan(
        codes, phred, k, c, snpmer_sorted, args.minimum_base_quality
    )
    blk_pos = np.zeros(0, np.uint32)
    blk_fwd = np.zeros(0, bool)
    if blockmer_sorted is not None and len(blockmer_sorted):
        blk_pos, blk_fwd = blockmer_hits_scan(
            codes, phred, k, args.blockmer_length, blockmer_sorted, args.minimum_base_quality
        )

    all_equal_q = phred is not None and len(phred) > 0 and bool((phred == phred[0]).all())
    est_id = None if (phred is None or all_equal_q) else estimate_sequence_identity(phred)

    qual_levels = None
    if qual is not None:
        binned = bin_qualities(np.frombuffer(qual, dtype=np.uint8))
        qual_levels = quantize_qual_bin(binned)

    return TwinRead(
        id=read_id,
        base_id=read_id.split()[0] if read_id.split() else read_id,
        codes=codes,
        k=k,
        l=args.blockmer_length,
        qual_levels=qual_levels,
        est_id=est_id,
        mini_pos=mini_pos,
        mini_kmers_all=mini_kmers,
        snp_pos=snp_pos,
        snp_kmers_all=snp_kmers,
        blockmer_pos=blk_pos,
        blockmer_canonical=blk_fwd,
    )


def _apply_solid_filters(tr: TwinRead, args: ClusterArgs, high_freq_sorted: np.ndarray) -> bool:
    """In-read multiplicity + high-frequency filters (kmer_comp.rs:163-208).

    Filters only the POSITION vectors (reference retain_* quirk).  Returns
    False if the read is repetitive (< 5% solid minimizers) and must drop.
    """
    minis = tr.mini_kmers_all
    solid = np.ones(len(minis), dtype=bool)
    if len(minis):
        uniq, cnt = np.unique(minis, return_counts=True)
        j = np.searchsorted(uniq, minis)
        solid &= cnt[j] <= MAX_KMER_COUNT_IN_READ
        if len(high_freq_sorted):
            hj = np.clip(np.searchsorted(high_freq_sorted, minis), 0, len(high_freq_sorted) - 1)
            solid &= high_freq_sorted[hj] != minis
    if solid.sum() < tr.base_length // args.c // 20:
        return False
    tr.mini_pos = tr.mini_pos[solid]

    snps = tr.snp_kmers_all
    if len(snps) and len(high_freq_sorted):
        hj = np.clip(np.searchsorted(high_freq_sorted, snps), 0, len(high_freq_sorted) - 1)
        solid_snp = high_freq_sorted[hj] != snps
        tr.snp_pos = tr.snp_pos[solid_snp]
    return True


def _build_twin_read_from_scan(rec, scan, args: ClusterArgs, codes) -> TwinRead:
    """Assemble a TwinRead from precomputed scan results (native path)."""
    mini_pos, mini_kmers, snp_pos, snp_kmers = scan
    phred = phred_from_ascii(rec.qual) if rec.qual is not None else None
    all_equal_q = phred is not None and len(phred) > 0 and bool((phred == phred[0]).all())
    est_id = None if (phred is None or all_equal_q) else estimate_sequence_identity(phred)
    qual_levels = None
    if rec.qual is not None:
        qual_levels = quantize_qual_bin(bin_qualities(np.frombuffer(rec.qual, dtype=np.uint8)))
    return TwinRead(
        id=rec.id,
        base_id=rec.id.split()[0] if rec.id.split() else rec.id,
        codes=codes,
        k=args.kmer_size,
        l=args.blockmer_length,
        qual_levels=qual_levels,
        est_id=est_id,
        mini_pos=mini_pos,
        mini_kmers_all=mini_kmers,
        snp_pos=snp_pos,
        snp_kmers_all=snp_kmers,
    )


def _batched_qual_fields(quals: list[bytes | None]):
    """Vectorized (est_id, qual_levels) for a batch of reads.

    BIT-IDENTICAL to the per-read path in _build_twin_read_from_scan: the
    error-probability powers, the per-bin mins and the QualCompact3
    quantization are elementwise, and the per-segment error-prob sums use
    the strictly SEQUENTIAL order of estimate_sequence_identity (np.cumsum
    == the native kernel's scalar loop == the reference's Rust
    accumulation, seeding.rs:801-817).  Uses the one-pass native kernel
    when available (same math, same order; parity-tested in
    tests/test_native.py)."""
    from ..ops.encode import _ERR_PROB_LUT
    from ..ops.kmers_native import qual_fields_batch_native

    n = len(quals)
    est: list[float | None] = [None] * n
    levels: list[np.ndarray | None] = [None] * n
    idx = [i for i in range(n) if quals[i] is not None]
    if not idx:
        return est, levels

    lens = np.array([len(quals[i]) for i in idx], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    nonempty = lens > 0

    off = np.concatenate((starts, [int(lens.sum())]))
    native = None
    flat_q = None
    from ..ops.kmers_native import get_scan_lib

    if get_scan_lib() is not None:
        flat_q = (
            np.frombuffer(b"".join(quals[i] for i in idx), dtype=np.uint8)
            if lens.sum()
            else np.zeros(0, np.uint8)
        )
        native = qual_fields_batch_native(flat_q, off, threads=4)
    if native is not None:
        n_eq, n_levels, n_off, sums = native
        eq = n_eq.astype(bool)
        est_vals = np.full(len(idx), np.nan)
        ne = np.flatnonzero(nonempty)
        if len(ne):
            # elementwise — identical per read to 100.0 - total/len*100.0
            est_vals[ne] = 100.0 - sums[ne] / lens[ne] * 100.0
        for j, i in enumerate(idx):
            if not eq[j]:
                est[i] = float(est_vals[j])
        for j, i in enumerate(idx):
            levels[i] = n_levels[n_off[j] : n_off[j + 1]]
        return est, levels

    flat_q = (
        np.frombuffer(b"".join(quals[i] for i in idx), dtype=np.uint8)
        if lens.sum()
        else np.zeros(0, np.uint8)
    )
    # all-equal-quality detection: min == max per segment (exact; ASCII
    # order == phred order)
    eq = np.zeros(len(idx), dtype=bool)
    if nonempty.any():
        ne_starts = starts[nonempty]
        mins = np.minimum.reduceat(flat_q, ne_starts)
        maxs = np.maximum.reduceat(flat_q, ne_starts)
        eq[nonempty] = mins == maxs

    # per-segment sums: bit-identical to the per-read
    # estimate_sequence_identity (LUT[ascii] == LUT[(phred+33)&0xFF], and
    # both sum SEQUENTIALLY — np.cumsum per segment here).  Chunked at
    # read boundaries: the f64 LUT expansion is 8x the input (1.2 GB at
    # 100k reads) and page-faulting it dominated stage 1.5; per-read sums
    # are unchanged because the cumsum runs per segment.
    est_vals = np.full(len(idx), np.nan)
    ne_idx = np.flatnonzero(nonempty)
    if len(ne_idx) and len(flat_q):
        CHUNK = 2048  # reads per chunk (~24 MB of f64 at typical lengths)
        ends = starts + lens
        for s in range(0, len(ne_idx), CHUNK):
            sel = ne_idx[s : s + CHUNK]
            lo_b, hi_b = int(starts[sel[0]]), int(ends[sel[-1]])
            flat_p = _ERR_PROB_LUT[flat_q[lo_b:hi_b]]
            sums = np.empty(len(sel), dtype=np.float64)
            for t, (rs, re) in enumerate(
                zip((starts[sel] - lo_b).tolist(), (ends[sel] - lo_b).tolist())
            ):
                sums[t] = np.cumsum(flat_p[rs:re])[-1]
            est_vals[sel] = 100.0 - sums / lens[sel] * 100.0
    for j, i in enumerate(idx):
        if not eq[j]:
            est[i] = float(est_vals[j])

    # QualCompact3: per-read padding to bin_size=4 with 255, min per bin,
    # then one quantization pass over all bins
    BIN = 4
    nbins = (lens + BIN - 1) // BIN
    pad_starts = np.concatenate(([0], np.cumsum(nbins * BIN)[:-1]))
    total = int((nbins * BIN).sum())
    padded = np.full(total, 255, dtype=np.uint8)
    if lens.sum():
        within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(starts, lens)
        dest = np.repeat(pad_starts, lens) + within
        padded[dest] = flat_q
    binned = padded.reshape(-1, BIN).min(axis=1)
    all_levels = quantize_qual_bin(binned)
    bin_starts = np.concatenate(([0], np.cumsum(nbins)))
    for j, i in enumerate(idx):
        levels[i] = all_levels[bin_starts[j] : bin_starts[j + 1]]
    return est, levels


def twin_reads_from_files(
    kmer_info: KmerGlobalInfo, args: ClusterArgs, blockmer_sorted: np.ndarray | None = None
) -> list[TwinRead]:
    """Third pass over the FASTQ: TwinRead construction + filters
    (kmer_comp.rs:68-258 + main-loop sort at main.rs:533)."""
    from ..ops.kmers_native import get_scan_lib

    snpmer_sorted = kmer_info.snpmer_set_sorted()
    high_freq = kmer_info.high_freq_kmers
    twin_reads: list[TwinRead] = []
    n_len_filtered = 0
    n_repetitive = 0
    use_native = get_scan_lib() is not None
    for file_idx, path in enumerate(args.input_files):
        recs_all = _cached_records(path)
        enc_c, enc_p = _cached_encoded(path)  # shared with the counting pass
        n_file_total = len(recs_all)
        lens = np.fromiter((len(c) for c in enc_c), np.int64, n_file_total)
        in_range = (lens >= args.min_read_length) & (lens <= args.max_read_length)
        n_file_removed = int(n_file_total - in_range.sum())
        n_len_filtered += n_file_removed
        keep = np.flatnonzero(in_range & (lens >= args.kmer_size)).tolist()
        recs = [recs_all[i] for i in keep]
        codes_list = [enc_c[i] for i in keep]
        phred_list = [enc_p[i] for i in keep]
        scan_pools = None
        if use_native:
            from ..ops.kmers_native import syncmer_scan_flat_native

            scan_pools = syncmer_scan_flat_native(
                codes_list, phred_list, args.kmer_size, args.c,
                args.minimum_base_quality, snpmer_sorted,
            )
            mp_all, mk_all, sp_all, sk_all, sm_off, ss_off = scan_pools
            smoff = sm_off.tolist()
            ssoff = ss_off.tolist()
            ests, levels = _batched_qual_fields([r.qual for r in recs])
            k_sz, l_sz = args.kmer_size, args.blockmer_length
            # positional ctor + pairwise-zipped offsets: the kwarg dict and
            # the 4 list-index pairs per read cost ~2 us x 100k reads
            trs = [
                TwinRead(
                    rec.id,
                    (rec.id.split(None, 1) or (rec.id,))[0],
                    codes,
                    k_sz,
                    l_sz,
                    ql,
                    est,
                    mp_all[ms:me],
                    mk_all[ms:me],
                    sp_all[ss:se],
                    sk_all[ss:se],
                )
                for rec, codes, est, ql, ms, me, ss, se in zip(
                    recs, codes_list, ests, levels,
                    smoff, smoff[1:], ssoff, ssoff[1:],
                )
            ]
            # seq_bytes prefill: decode_seq(codes) is byte-identical to the
            # parsed rec.seq for pure-ACGT reads (N/lowercase reads differ
            # — encoding sanitizes N->A), so hand those reads the parsed
            # bytes object instead of re-decoding 100+ MB later
            # (TwinRead.warm_seq_bytes was ~0.9 s at 100k reads)
            pure = _pure_acgt_batch([rec.seq for rec in recs])
            from ..ops.encode import register_planner_codes_many

            pure_idx = np.flatnonzero(pure).tolist()
            pure_seqs = [recs[i].seq for i in pure_idx]
            for t, s in zip([trs[i] for i in pure_idx], pure_seqs):
                t._seq_bytes_cache = s
            # keep the planner-codes registry in sync with the prefill
            # (pure-ACGT: encode/decode round-trips, so the stored codes
            # ARE ascii_to_align_codes(rec.seq))
            register_planner_codes_many(
                pure_seqs, [codes_list[i] for i in pure_idx]
            )
            if blockmer_sorted is not None and len(blockmer_sorted):
                for tr, codes, phred in zip(trs, codes_list, phred_list):
                    tr.blockmer_pos, tr.blockmer_canonical = blockmer_hits_scan(
                        codes, phred, args.kmer_size, args.blockmer_length,
                        blockmer_sorted, args.minimum_base_quality,
                    )
        else:
            trs = [
                build_twin_read(rec.seq, rec.qual, rec.id, args, snpmer_sorted, blockmer_sorted)
                for rec in recs
            ]
        live = [tr for tr in trs if tr is not None]
        flat = None
        if live and scan_pools is not None:
            # the scan pools already ARE the concatenated per-read k-mer
            # lists in `live` order (the native path never drops reads);
            # guard the alignment in case a future native path filters
            assert len(live) == len(trs), "scan pools misaligned with live reads"
            from ..ops.kmers_native import solid_filter_pools_native

            r = solid_filter_pools_native(
                mk_all, sm_off, sk_all, ss_off,
                high_freq, MAX_KMER_COUNT_IN_READ, args.threads,
            )
            if r is not None:
                mb, sb, m_counts = r
                flat = (mb, sm_off, sb, ss_off, m_counts, mk_all, sk_all, mp_all, sp_all)
        elif live:
            from ..ops.kmers_native import solid_filter_flat_native

            r = solid_filter_flat_native(
                [t.mini_kmers_all for t in live],
                [t.snp_kmers_all for t in live],
                high_freq, MAX_KMER_COUNT_IN_READ, args.threads,
            )
            if r is not None:
                mb, m_off, sb, s_off, m_counts, minis_flat, snps_flat = r
                mpos_flat = np.concatenate([t.mini_pos for t in live])
                spos_flat = np.concatenate([t.snp_pos for t in live])
                flat = (mb, m_off, sb, s_off, m_counts, minis_flat, snps_flat, mpos_flat, spos_flat)
        if flat is not None:
            # batched mask application: ONE boolean gather per pool (the
            # per-read fancy-index loop was ~1.5 s of stage 1.5 at 100k).
            # The vec caches are filled from the scan k-mers while masking:
            # the scan already produced the exact canonical k-mers
            # kmer_at_position would recompute (empirically equal;
            # minimizers_vec parity is test-pinned), so the whole
            # _prime_vec_caches rolling pass disappears.
            mb, m_off, sb, s_off, m_counts, minis_flat, snps_flat, mpos_flat, spos_flat = flat
            fm_k = minis_flat[mb]
            fm_p = mpos_flat[mb]
            nm_off = np.zeros(len(live) + 1, dtype=np.int64)
            np.cumsum(m_counts, out=nm_off[1:])
            snp_filtering = bool(len(high_freq))
            if snp_filtering:
                fs_k = snps_flat[sb]
                fs_p = spos_flat[sb]
                css = np.zeros(len(sb) + 1, dtype=np.int64)
                np.cumsum(sb.astype(np.int64), out=css[1:])  # bool out=int64 cumsum is ~74 ns/elem
                s_counts = css[s_off[1:]] - css[s_off[:-1]]
                ns_off = np.zeros(len(live) + 1, dtype=np.int64)
                np.cumsum(s_counts, out=ns_off[1:])
                soff = ns_off.tolist()
            base_lens = np.fromiter((len(t.codes) for t in live), np.int64, len(live))
            keep = m_counts >= (base_lens // args.c // 20)
            n_repetitive += int(len(live) - keep.sum())
            moff = nm_off.tolist()
            for li in np.flatnonzero(keep).tolist():
                tr = live[li]
                mp = fm_p[moff[li] : moff[li + 1]]
                tr.mini_pos = mp
                tr._mini_vec_cache = (mp, fm_k[moff[li] : moff[li + 1]])
                if snp_filtering:
                    sp = fs_p[soff[li] : soff[li + 1]]
                    tr.snp_pos = sp
                    tr._snp_vec_cache = (sp, fs_k[soff[li] : soff[li + 1]])
                else:
                    tr._snp_vec_cache = (tr.snp_pos, tr.snp_kmers_all)
                tr.file_idx = file_idx
                twin_reads.append(tr)
        else:
            for tr in live:
                if not _apply_solid_filters(tr, args, high_freq):
                    n_repetitive += 1
                    continue
                tr.file_idx = file_idx
                twin_reads.append(tr)
        if log.isEnabledFor(5):  # TRACE: per-read SNPmer dump
            for tr in trs:
                if tr is not None:
                    log.log(5, "read %s: %d minimizers, snpmer positions %s",
                            tr.id, len(tr.mini_pos), tr.snp_pos.tolist())
        if n_file_removed > n_file_total / 2:
            # kmer_comp.rs:129-132
            log.warning(
                "More than 50%% of reads were removed in fastq file %s due to "
                "length filtering (min: %d, max: %d). Please check your input "
                "reads and filtering parameters.",
                path, args.min_read_length, args.max_read_length,
            )
        log.info("Number of reads removed due to length filtering: %d.", n_file_removed)

    from operator import attrgetter

    twin_reads.sort(key=attrgetter("id"))
    n_below = sum(1 for t in twin_reads if t.est_id is not None and t.est_id < args.quality_value_cutoff)
    log.info(
        "valid reads %d; %d below quality cutoff; %d length-filtered; %d repetitive",
        len(twin_reads), n_below, n_len_filtered, n_repetitive,
    )
    if twin_reads and n_below / len(twin_reads) > 0.5:
        # kmer_comp.rs:245-247
        log.warning(
            "More than 50%% of reads are below the quality threshold of %s%%. "
            "This may imply that these reads are not high enough quality for "
            "ASV reconstruction. Proceed with caution!",
            args.quality_value_cutoff,
        )
    twin_reads = [t for t in twin_reads if t.est_id is None or t.est_id >= args.quality_value_cutoff]
    # main.rs sorts by est accuracy desc, stable (main.rs:533)
    twin_reads.sort(key=lambda t: -(t.est_id if t.est_id is not None else 100.0))
    compute_lsh_signatures_batch(twin_reads, args.threads)
    _prime_vec_caches(twin_reads, args.kmer_size, args.threads)
    return twin_reads


def _prime_vec_caches(twin_reads: list[TwinRead], k: int, threads: int = 0) -> None:
    """Pre-fill minimizers_vec/snpmers_vec caches with one batched rolling
    pass for reads that don't already carry a valid cache (the native-scan
    path fills them from the scan k-mers while masking; this serves the
    Python-fallback path and any reads whose positions were replaced)."""
    from ..ops.kmers_native import kmer_at_positions_native

    need = [
        t for t in twin_reads
        if (c := getattr(t, "_mini_vec_cache", None)) is None or c[0] is not t.mini_pos
        or (s := getattr(t, "_snp_vec_cache", None)) is None or s[0] is not t.snp_pos
    ]
    if not need:
        return
    codes = [t.codes for t in need]
    mini_pos = [t.mini_pos for t in need]
    snp_pos = [t.snp_pos for t in need]
    minis = kmer_at_positions_native(codes, mini_pos, k, threads)
    snps = kmer_at_positions_native(codes, snp_pos, k, threads)
    if minis is None or snps is None:
        minis = kmer_at_position_batch(codes, mini_pos, k)
        snps = kmer_at_position_batch(codes, snp_pos, k)
    for t, mk, sk in zip(need, minis, snps):
        t._mini_vec_cache = (t.mini_pos, mk)
        t._snp_vec_cache = (t.snp_pos, sk)


def twin_reads_from_fasta(path, kmer_info: KmerGlobalInfo, args: ClusterArgs) -> list[TwinRead]:
    """Reload ASVs as TwinReads for EM (kmer_comp.rs:39-66) — no filters."""
    from ..ops.kmers_native import get_scan_lib, syncmer_scan_native

    snpmer_sorted = kmer_info.snpmer_set_sorted()
    recs = [r for r in read_fastx(str(path)) if len(r.seq) >= args.kmer_size]
    if get_scan_lib() is not None:
        # same native batched scan as the read path (quals are None for
        # FASTA, so the min-quality mask is a no-op in both scans)
        codes_list, _ = _batch_encode([r.seq for r in recs], [None] * len(recs))
        scans = syncmer_scan_native(
            codes_list, None, args.kmer_size, args.c,
            args.minimum_base_quality, snpmer_sorted,
        )
        return [
            _build_twin_read_from_scan(rec, scan, args, codes)
            for rec, scan, codes in zip(recs, scans, codes_list)
        ]
    out = []
    for rec in recs:
        tr = build_twin_read(rec.seq, None, rec.id, args, snpmer_sorted)
        if tr is not None:
            out.append(tr)
    return out
