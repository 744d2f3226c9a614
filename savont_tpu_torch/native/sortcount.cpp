// Parallel strand-split k-mer counting: sort-by-bare-value + run-length
// count of a bit63-flagged canonical k-mer stream.
//
// Replaces the reference's sharded hash-map counting (seq_parse.rs
// second_iteration, kmer % threads shards) with the sort/segment-reduce
// formulation: radix sort the flagged stream by its bare (low-63-bit)
// value, then count flag[0]/flag[1] occurrences per run of equal bare
// values.  Output order (bare ascending) matches np.unique, so the NumPy
// fallback in ops/kmers.py is bit-identical.
//
// LSD radix with an adaptive digit width covering only the populated bits
// (k<=31 split k-mers occupy 2k <= 62 low bits; 16S k=17 sorts in 3
// 12-bit passes).  Histograms are per-thread; scatter offsets come from a
// bucket-major exclusive scan so each thread writes disjoint slices.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

static const uint64_t BARE_MASK = ~(1ULL << 63);

extern "C" int64_t count_flagged_u64(const uint64_t *keys, int64_t n,
                                     uint64_t *out_uniq, uint32_t *out_counts,
                                     int threads) {
  if (n <= 0)
    return 0;
  if (threads < 1)
    threads = 1;

  // uninitialized ping-pong buffers: std::vector value-init memset ~0.5 GB
  // per 30M-kmer chunk before the sort even started; every page is fully
  // written by the scatter passes, so default-init is safe
  std::unique_ptr<uint64_t[]> a(new uint64_t[n]), b(new uint64_t[n]);

  uint64_t maxbare = 0;
#pragma omp parallel for reduction(max : maxbare) num_threads(threads)
  for (int64_t i = 0; i < n; i++) {
    uint64_t v = keys[i] & BARE_MASK;
    if (v > maxbare)
      maxbare = v;
  }
  // adaptive digit width: prefer 3 passes when <= 16-bit digits cover the
  // populated range (split k-mers occupy 2k bits: k=17 -> 34 -> RB=12),
  // else 4 passes with the narrowest sufficient digit.  Each pass is two
  // full sweeps over the data, so fewer passes is a direct bandwidth win;
  // the first pass reads `keys` in place (no upfront copy).
  int bits = 1;
  while (bits < 64 && (maxbare >> bits))
    bits++;
  int RB = (bits + 2) / 3;
  if (RB > 16)
    RB = (bits + 3) / 4;
  if (RB < 8)
    RB = 8;
  const int NB = 1 << RB;
  int passes = 1;
  while (passes < (64 + RB - 1) / RB && (maxbare >> ((int64_t)RB * passes)))
    passes++;
  const uint64_t *src = keys;
  uint64_t *dst = a.get();

  // chunking: fixed per-thread ranges shared by histogram + scatter
  std::vector<int64_t> lo(threads + 1);
  for (int t = 0; t <= threads; t++)
    lo[t] = n * t / threads;

  std::vector<int64_t> hist((size_t)threads * NB);
  for (int p = 0; p < passes; p++) {
    int shift = RB * p;
    std::memset(hist.data(), 0, hist.size() * sizeof(int64_t));
#pragma omp parallel num_threads(threads)
    {
      int t = omp_get_thread_num();
      int64_t *h = &hist[(size_t)t * NB];
      for (int64_t i = lo[t]; i < lo[t + 1]; i++)
        h[((src[i] & BARE_MASK) >> shift) & (NB - 1)]++;
    }
    // bucket-major exclusive scan: offset for (bucket, thread)
    int64_t run = 0;
    for (int bkt = 0; bkt < NB; bkt++)
      for (int t = 0; t < threads; t++) {
        int64_t c = hist[(size_t)t * NB + bkt];
        hist[(size_t)t * NB + bkt] = run;
        run += c;
      }
#pragma omp parallel num_threads(threads)
    {
      int t = omp_get_thread_num();
      int64_t *off = &hist[(size_t)t * NB];
      for (int64_t i = lo[t]; i < lo[t + 1]; i++)
        dst[off[((src[i] & BARE_MASK) >> shift) & (NB - 1)]++] = src[i];
    }
    src = dst;
    dst = (dst == a.get()) ? b.get() : a.get();
  }

  // parallel run-length count over runs of equal bare value
  std::vector<int64_t> start(threads + 1), nuniq(threads);
  for (int t = 0; t <= threads; t++) {
    int64_t s = n * t / threads;
    // advance to the first element starting a new run
    while (s > 0 && s < n &&
           (src[s] & BARE_MASK) == (src[s - 1] & BARE_MASK))
      s++;
    start[t] = s;
  }
  start[threads] = n;
#pragma omp parallel num_threads(threads)
  {
    int t = omp_get_thread_num();
    int64_t cnt = 0;
    uint64_t prev = 0;
    bool first = true;
    for (int64_t i = start[t]; i < start[t + 1]; i++) {
      uint64_t v = src[i] & BARE_MASK;
      if (first || v != prev) {
        cnt++;
        prev = v;
        first = false;
      }
    }
    nuniq[t] = cnt;
  }
  std::vector<int64_t> ubase(threads + 1, 0);
  for (int t = 0; t < threads; t++)
    ubase[t + 1] = ubase[t] + nuniq[t];
#pragma omp parallel num_threads(threads)
  {
    int t = omp_get_thread_num();
    int64_t u = ubase[t] - 1;
    uint64_t prev = 0;
    bool first = true;
    for (int64_t i = start[t]; i < start[t + 1]; i++) {
      uint64_t v = src[i] & BARE_MASK;
      if (first || v != prev) {
        u++;
        out_uniq[u] = v;
        out_counts[2 * u] = 0;
        out_counts[2 * u + 1] = 0;
        prev = v;
        first = false;
      }
      out_counts[2 * u + (src[i] >> 63)]++;
    }
  }
  return ubase[threads];
}

// In-place parallel LSD radix sort of a u64 key array (bytes above the
// maximum value are skipped).  Shares the histogram/scatter scheme of
// count_flagged_u64; used by the anchor-grouping path in align_batch.
extern "C" void radix_sort_u64(uint64_t *keys, int64_t n, int threads) {
  if (n <= 1)
    return;
  if (threads < 1)
    threads = 1;
  std::unique_ptr<uint64_t[]> buf(new uint64_t[n]); // uninit: fully scattered
  uint64_t *src = keys, *dst = buf.get();

  uint64_t maxv = 0;
#pragma omp parallel for reduction(max : maxv) num_threads(threads)
  for (int64_t i = 0; i < n; i++)
    if (src[i] > maxv)
      maxv = src[i];
  // adaptive digit width (same scheme as count_flagged_u64): 60-bit
  // anchor keys sort in 4 15-bit passes instead of 6 11-bit ones
  int bits = 1;
  while (bits < 64 && (maxv >> bits))
    bits++;
  int RB = (bits + 2) / 3;
  if (RB > 16)
    RB = (bits + 3) / 4;
  if (RB < 8)
    RB = 8;
  const int NB = 1 << RB;
  int passes = 1;
  while (passes < (64 + RB - 1) / RB && (maxv >> ((int64_t)RB * passes)))
    passes++;

  std::vector<int64_t> lo(threads + 1);
  for (int t = 0; t <= threads; t++)
    lo[t] = n * t / threads;
  std::vector<int64_t> hist((size_t)threads * NB);
  for (int p = 0; p < passes; p++) {
    int shift = RB * p;
    std::memset(hist.data(), 0, hist.size() * sizeof(int64_t));
#pragma omp parallel num_threads(threads)
    {
      int t = omp_get_thread_num();
      int64_t *h = &hist[(size_t)t * NB];
      for (int64_t i = lo[t]; i < lo[t + 1]; i++)
        h[(src[i] >> shift) & (NB - 1)]++;
    }
    int64_t run = 0;
    for (int bkt = 0; bkt < NB; bkt++)
      for (int t = 0; t < threads; t++) {
        int64_t c = hist[(size_t)t * NB + bkt];
        hist[(size_t)t * NB + bkt] = run;
        run += c;
      }
#pragma omp parallel num_threads(threads)
    {
      int t = omp_get_thread_num();
      int64_t *off = &hist[(size_t)t * NB];
      for (int64_t i = lo[t]; i < lo[t + 1]; i++)
        dst[off[(src[i] >> shift) & (NB - 1)]++] = src[i];
    }
    uint64_t *tmp = src;
    src = dst;
    dst = tmp;
  }
  if (src != keys)
    std::memcpy(keys, src, (size_t)n * sizeof(uint64_t));
}

// Expand minimizer-hit ranges into packed anchor sort keys
// (qid<<43 | tid<<29 | strand<<28 | oriented_qpos<<14 | tpos), applying
// the no_diag filter.  Returns the number of keys written.  The caller
// radix-sorts and decodes the fields back out of the key — this replaces
// the np.repeat/arange expansion + argsort in plan_jobs_batch.
// Range lookup of query minimizer hashes in the sorted target-hash table
// (replaces two np.searchsorted passes): writes per-query range start and
// length, returns the total hit count so the caller can size the key buffer.
extern "C" int64_t anchor_search(const uint64_t *h_sorted, int64_t n_h,
                                 const uint64_t *q, int64_t n, int64_t *lo,
                                 int64_t *cnt, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads > 0 ? threads : 1)
  for (int64_t i = 0; i < n; i++) {
    const uint64_t *l = std::lower_bound(h_sorted, h_sorted + n_h, q[i]);
    const uint64_t *r = std::upper_bound(l, h_sorted + n_h, q[i]);
    lo[i] = l - h_sorted;
    cnt[i] = r - l;
  }
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) total += cnt[i];
  return total;
}

// jid_shift: bit position of the query/job id field.  43 for the general
// (tid-carrying) planner; 29 when every table is a singleton (tid == 0), so
// the key collapses to jid|same|qp|tpos and the adaptive radix sort covers
// it in one fewer pass.  Sort order is unchanged (tid was constant 0).
extern "C" int64_t anchor_pack_keys(
    const int64_t *lo, const int64_t *cnt, int64_t n_minis,
    const int32_t *all_p, const uint8_t *all_f, const int32_t *qid,
    const int64_t *qlens, const int32_t *h_tid, const int32_t *h_tpos,
    const uint8_t *h_isf, int k, int no_diag, int jid_shift, uint64_t *keys) {
  int64_t w = 0;
  for (int64_t m = 0; m < n_minis; m++) {
    const int64_t q = qid[m];
    const int64_t qp_f = all_p[m];
    const int64_t qp_r = qlens[q] - k - qp_f;
    const uint64_t base = (uint64_t)q << jid_shift;
    for (int64_t j = lo[m]; j < lo[m] + cnt[m]; j++) {
      const int64_t tid = h_tid[j];
      if (no_diag && tid == q)
        continue;
      const int same = h_isf[j] == all_f[m];
      const int64_t qp = same ? qp_f : qp_r;
      keys[w++] = base | ((uint64_t)tid << 29) | ((uint64_t)same << 28) |
                  ((uint64_t)qp << 14) | (uint64_t)h_tpos[j];
    }
  }
  return w;
}

// ── fused indexed anchor planning ──────────────────────────────────────────
// The SoA planner's per-job mini expansion (np.repeat + 3 gathers to ~35M
// elements at 100k reads) cost more than every native call it fed.  These
// two functions consume the POOLED per-unique-query minimizers directly:
// job j probes pool_h[q_moff[uq[j]] .. q_moff[uq[j]+1]) against its target
// table ti[j] and emits the packed keys anchor_pack_keys(jid_shift = 29)
// would, already in radix_sort_u64's order: per job the strand- hits in
// reverse mini order, then the strand+ hits forward (qp ascends in both,
// each table's equal-hash runs are tpos-ascending, keys ascend with job
// id).
//
// Protocol: anchor_count_hits_idx fills job_off[n_jobs+1] and returns the
// total; the caller allocates keys[total] and calls anchor_pack_keys_idx.
// Both rebuild the per-table open-addressing maps (O(n_h), tiny next to
// the probe volume).

namespace {
struct TableMaps {
  std::vector<int64_t> cap_off;
  std::vector<int> shift;
  std::vector<uint64_t> hkey;
  std::vector<int64_t> hlo;
  std::vector<int64_t> hcnt;
  static constexpr uint64_t MUL = 0x9E3779B97F4A7C15ULL;

  void build(const uint64_t *h_cat, const int64_t *tab_off,
             int64_t n_tables) {
    cap_off.assign(n_tables + 1, 0);
    shift.assign(n_tables, 64);
    for (int64_t g = 0; g < n_tables; g++) {
      const int64_t len = tab_off[g + 1] - tab_off[g];
      int64_t c = 0;
      if (len > 0) {
        c = 16;
        int lg = 4;
        while (c < 2 * len) {
          c <<= 1;
          lg++;
        }
        shift[g] = 64 - lg;
      }
      cap_off[g + 1] = cap_off[g] + c;
    }
    hkey.assign(cap_off[n_tables], 0);
    hlo.assign(cap_off[n_tables], 0);
    hcnt.assign(cap_off[n_tables], 0);
    for (int64_t g = 0; g < n_tables; g++) {
      uint64_t *kk = hkey.data() + cap_off[g];
      int64_t *ll = hlo.data() + cap_off[g];
      int64_t *cc = hcnt.data() + cap_off[g];
      const uint64_t mask = (uint64_t)(cap_off[g + 1] - cap_off[g]) - 1;
      int64_t i = tab_off[g];
      while (i < tab_off[g + 1]) {
        int64_t j = i + 1;
        while (j < tab_off[g + 1] && h_cat[j] == h_cat[i])
          j++;
        uint64_t s = (h_cat[i] * MUL) >> shift[g];
        while (cc[s])
          s = (s + 1) & mask;
        kk[s] = h_cat[i];
        ll[s] = i;
        cc[s] = j - i;
        i = j;
      }
    }
  }

  // (global lo, cnt) for key q in table g; cnt 0 on miss
  inline void probe(int64_t g, uint64_t q, int64_t &lo, int64_t &cnt) const {
    if (cap_off[g + 1] == cap_off[g]) {
      lo = 0;
      cnt = 0;
      return;
    }
    const uint64_t *kk = hkey.data() + cap_off[g];
    const int64_t *ll = hlo.data() + cap_off[g];
    const int64_t *cc = hcnt.data() + cap_off[g];
    const uint64_t mask = (uint64_t)(cap_off[g + 1] - cap_off[g]) - 1;
    uint64_t s = (q * MUL) >> shift[g];
    while (cc[s] && kk[s] != q)
      s = (s + 1) & mask;
    lo = cc[s] ? ll[s] : 0;
    cnt = cc[s];
  }
};
} // namespace

extern "C" int64_t anchor_count_hits_idx(
    const uint64_t *h_cat, const int64_t *tab_off, int64_t n_tables,
    const uint64_t *pool_h, const int64_t *q_moff, const int64_t *job_uq,
    const int32_t *job_ti, int64_t n_jobs, int64_t *job_off, int threads) {
  TableMaps maps;
  maps.build(h_cat, tab_off, n_tables);
#pragma omp parallel for schedule(static) num_threads(threads > 0 ? threads : 1)
  for (int64_t j = 0; j < n_jobs; j++) {
    const int64_t g = job_ti[j];
    const int64_t s = q_moff[job_uq[j]], e = q_moff[job_uq[j] + 1];
    int64_t t = 0, lo, cnt;
    for (int64_t m = s; m < e; m++) {
      maps.probe(g, pool_h[m], lo, cnt);
      t += cnt;
    }
    job_off[j + 1] = t;
  }
  job_off[0] = 0;
  for (int64_t j = 0; j < n_jobs; j++)
    job_off[j + 1] += job_off[j];
  return job_off[n_jobs];
}

extern "C" void anchor_pack_keys_idx(
    const uint64_t *h_cat, const int64_t *tab_off, int64_t n_tables,
    const uint64_t *pool_h, const int32_t *pool_p, const uint8_t *pool_f,
    const int64_t *q_moff, const int64_t *job_uq, const int32_t *job_ti,
    int64_t n_jobs, const int64_t *qlens_uq, const int32_t *h_tpos,
    const uint8_t *h_isf, int k, const int64_t *job_off, uint64_t *keys,
    int threads) {
  TableMaps maps;
  maps.build(h_cat, tab_off, n_tables);
#pragma omp parallel for schedule(dynamic, 64)                                 \
    num_threads(threads > 0 ? threads : 1)
  for (int64_t j = 0; j < n_jobs; j++) {
    const int64_t g = job_ti[j];
    const int64_t s = q_moff[job_uq[j]], e = q_moff[job_uq[j] + 1];
    const uint64_t base = (uint64_t)j << 29;
    const int64_t qlen = qlens_uq[job_uq[j]];
    uint64_t *w = keys + job_off[j];
    int64_t lo, cnt;
    for (int64_t m = e - 1; m >= s; m--) {
      maps.probe(g, pool_h[m], lo, cnt);
      const uint64_t qp_r = (uint64_t)(qlen - k - pool_p[m]);
      for (int64_t t = lo; t < lo + cnt; t++)
        if (h_isf[t] != pool_f[m])
          *w++ = base | (qp_r << 14) | (uint64_t)h_tpos[t];
    }
    for (int64_t m = s; m < e; m++) {
      maps.probe(g, pool_h[m], lo, cnt);
      const uint64_t qp_f = (uint64_t)pool_p[m];
      for (int64_t t = lo; t < lo + cnt; t++)
        if (h_isf[t] == pool_f[m])
          *w++ = base | (1ULL << 28) | (qp_f << 14) | (uint64_t)h_tpos[t];
    }
  }
}
