// Per-read k-mer scan kernels (host native path).
//
// Exact semantic twins of savont_tpu_torch/ops/kmers.py split_kmer_mid and
// syncmer_and_snpmer_scan (themselves transcriptions of the reference's
// seeding.rs rolling loops).  Batched over concatenated read buffers,
// OpenMP over reads.  Tested bit-identical in tests/test_native.py.
#include <cstdint>
#include <cstring>
#include <cmath>
#if defined(__x86_64__)
#include <immintrin.h>
#endif
#include <vector>
#include <algorithm>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_thread_num() { return 0; }
#endif

namespace {

inline uint64_t mm_hash64(uint64_t key) {
    key = (~key) + (key << 21);
    key = key ^ (key >> 24);
    key = (key + (key << 3)) + (key << 8);
    key = key ^ (key >> 14);
    key = (key + (key << 2)) + (key << 4);
    key = key ^ (key >> 28);
    key = key + (key << 31);
    return key;
}

inline bool in_sorted(const uint64_t* arr, int64_t n, uint64_t v) {
    return std::binary_search(arr, arr + n, v);
}

// split_kmer_mid for one read; returns count written to out.
int64_t split_one(const uint8_t* codes, const uint8_t* phred, int64_t len,
                  int k, int min_bq, uint64_t* out) {
    if (len < k) return 0;
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const uint64_t split_mask = ~(3ULL << (k - 1));
    const int rev_shift = 2 * (k - 1);
    bool use_qual = false;
    if (phred) {
        for (int64_t i = 1; i < len; i++)
            if (phred[i] != phred[0]) { use_qual = true; break; }
    }
    uint64_t f = 0, r = 0;
    int64_t cnt = 0;
    for (int64_t i = 0; i < len; i++) {
        const uint64_t c = codes[i];
        f = ((f << 2) | c) & mask;
        r = (r >> 2) | ((3 - c) << rev_shift);
        if (i < k - 1) continue;
        const int64_t p = i - k + 1;
        const uint64_t sf = f & split_mask, sr = r & split_mask;
        if (sf == sr) continue;
        if (use_qual && phred[p + k / 2] < min_bq) continue;
        if (sf < sr)
            out[cnt++] = f | (1ULL << 63);
        else
            out[cnt++] = r;
    }
    return cnt;
}

}  // namespace

extern "C" {

// Batched split_kmer_mid.  codes/phred concatenated; offsets length n+1.
// phred == nullptr -> no quality gate.  out has room for (len-k+1) per read
// at out_off[i]; out_cnt[i] receives the written count.
void split_kmers_batch(const uint8_t* codes, const uint8_t* phred,
                       const int64_t* off, int64_t n_reads, int k, int min_bq,
                       uint64_t* out, const int64_t* out_off, int64_t* out_cnt,
                       int n_threads) {
#ifdef _OPENMP
    const int nt_ = (n_threads > 0) ? n_threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) num_threads(nt_)
#endif
    for (int64_t i = 0; i < n_reads; i++) {
        const int64_t len = off[i + 1] - off[i];
        out_cnt[i] = split_one(codes + off[i], phred ? phred + off[i] : nullptr,
                               len, k, min_bq, out + out_off[i]);
    }
}

// Batched syncmer + SNPmer scan (seeding.rs get_twin_read_syncmer).
// Outputs per read, written at out_off[i] (room for len-k+1 each):
//   mini_pos (u32), mini_kmer (u64), snp_pos (u32), snp_kmer (u64)
// with counts in mini_cnt / snp_cnt.  snp_sorted: sorted full-kmer set.
// Dedup: SNPmer hits whose masked kmer occurs more than once among ALL set
// hits in the read are dropped (DEDUP_SNPMERS).
void syncmer_scan_batch(const uint8_t* codes, const uint8_t* phred,
                        const int64_t* off, int64_t n_reads, int k, int c,
                        int min_bq, const uint64_t* snp_sorted, int64_t n_snp,
                        uint32_t* mini_pos, uint64_t* mini_kmer,
                        uint32_t* snp_pos, uint64_t* snp_kmer,
                        const int64_t* out_off, int64_t* mini_cnt,
                        int64_t* snp_cnt, int n_threads) {
    const int s = k - c + 1;
    const int m = k - s + 1;
    const int mid = (k - s) / 2;
    // conservative bitset prefilter over the SNPmer set's low key bits:
    // almost every position misses the set, so one AND+load replaces the
    // binary search on the common path (false positives fall through to
    // in_sorted; results unchanged)
    constexpr int FILT_BITS = 22;
    std::vector<uint64_t> filt;
    if (n_snp) {
        filt.assign((size_t)1 << (FILT_BITS - 6), 0);
        for (int64_t i = 0; i < n_snp; i++) {
            const uint64_t b = snp_sorted[i] & (((uint64_t)1 << FILT_BITS) - 1);
            filt[b >> 6] |= 1ULL << (b & 63);
        }
    }
    const uint64_t* filt_p = filt.data();
#ifdef _OPENMP
    const int nt_ = (n_threads > 0) ? n_threads : omp_get_max_threads();
#pragma omp parallel num_threads(nt_)
#endif
    {
        std::vector<uint64_t> shash;
        std::vector<uint64_t> hit_masked;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t ri = 0; ri < n_reads; ri++) {
            const uint8_t* seq = codes + off[ri];
            const uint8_t* ph = phred ? phred + off[ri] : nullptr;
            const int64_t len = off[ri + 1] - off[ri];
            mini_cnt[ri] = 0;
            snp_cnt[ri] = 0;
            if (len < k) continue;
            const int64_t ns = len - s + 1;

            bool use_qual = false;
            if (ph) {
                for (int64_t i = 1; i < len; i++)
                    if (ph[i] != ph[0]) { use_qual = true; break; }
            }

            // s-mer canonical hashes
            shash.resize(ns);
            {
                const uint64_t smask = (1ULL << (2 * s)) - 1;
                const int srev = 2 * (s - 1);
                uint64_t f = 0, r = 0;
                for (int64_t i = 0; i < len; i++) {
                    const uint64_t cc = seq[i];
                    f = ((f << 2) | cc) & smask;
                    r = (r >> 2) | ((3 - cc) << srev);
                    if (i >= s - 1) shash[i - s + 1] = mm_hash64(std::min(f, r));
                }
            }

            uint32_t* mp = mini_pos + out_off[ri];
            uint64_t* mk = mini_kmer + out_off[ri];
            uint32_t* sp = snp_pos + out_off[ri];
            uint64_t* sk = snp_kmer + out_off[ri];
            hit_masked.clear();

            const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
            const uint64_t split_mask = ~(3ULL << (k - 1));
            const int rev_shift = 2 * (k - 1);
            uint64_t f = 0, r = 0;
            int64_t nm = 0, nsnp = 0;
            for (int64_t i = 0; i < len; i++) {
                const uint64_t cc = seq[i];
                f = ((f << 2) | cc) & mask;
                r = (r >> 2) | ((3 - cc) << rev_shift);
                if (i < k - 1) continue;
                const int64_t p = i - k + 1;
                const uint64_t canon = ((f & split_mask) < (r & split_mask)) ? f : r;

                // syncmer: middle s-mer strict minimum of the window
                bool sync = true;
                const uint64_t center = shash[p + mid];
                for (int j = 0; j < m; j++) {
                    if (j != mid && shash[p + j] <= center) { sync = false; break; }
                }
                if (sync) {
                    mp[nm] = (uint32_t)p;
                    mk[nm] = canon;
                    nm++;
                }

                const uint64_t fb = canon & (((uint64_t)1 << FILT_BITS) - 1);
                if (n_snp && (filt_p[fb >> 6] >> (fb & 63)) & 1 &&
                    in_sorted(snp_sorted, n_snp, canon)) {
                    hit_masked.push_back(canon & split_mask);
                    const bool qok = !use_qual || ph[p + k / 2] > min_bq;
                    if (qok) {
                        sp[nsnp] = (uint32_t)p;
                        sk[nsnp] = canon;
                        nsnp++;
                    }
                }
            }

            // per-read dedup on masked kmer over ALL set hits
            if (nsnp) {
                std::sort(hit_masked.begin(), hit_masked.end());
                int64_t w = 0;
                for (int64_t j = 0; j < nsnp; j++) {
                    const uint64_t hm = sk[j] & split_mask;
                    auto lo = std::lower_bound(hit_masked.begin(), hit_masked.end(), hm);
                    auto hi = std::upper_bound(lo, hit_masked.end(), hm);
                    if (hi - lo == 1) {
                        sp[w] = sp[j];
                        sk[w] = sk[j];
                        w++;
                    }
                }
                nsnp = w;
            }
            mini_cnt[ri] = nm;
            snp_cnt[ri] = nsnp;
        }
    }
}

// Canonical window minimizers (semantic twin of ops/align.py
// _window_minimizers): codes are 0-3 with 4 = ambiguous; windows containing
// an ambiguous base are excluded; leftmost-min per w-window, deduped.
// out arrays have capacity len-k+1 per sequence at out_off[i].
void window_minimizers_batch(
    const uint8_t* codes, const int64_t* offsets, int64_t n_seqs,
    int k, int w,
    uint64_t* out_h, int64_t* out_pos, uint8_t* out_fwd,
    const int64_t* out_off, int64_t* out_cnt, int n_threads) {
#ifdef _OPENMP
    // num_threads clause, NOT omp_set_num_threads: the setter is sticky
    // global state that would serialize later parallel regions (the DP).
    const int nt = (n_threads > 0) ? n_threads
                   : (n_seqs > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel num_threads(nt)
#endif
    {
        std::vector<uint64_t> h;
        std::vector<uint8_t> isf;
        std::vector<int64_t> dq;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t si = 0; si < n_seqs; si++) {
            const uint8_t* c = codes + offsets[si];
            const int64_t len = offsets[si + 1] - offsets[si];
            const int64_t n = len - k + 1;
            out_cnt[si] = 0;
            if (n <= 0) continue;
            h.resize(n);
            isf.resize(n);
            const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
            const int rev_shift = 2 * (k - 1);
            uint64_t f = 0, r = 0;
            int64_t last_bad = -1;
            for (int64_t i = 0; i < len; i++) {
                uint64_t b = c[i];
                if (b > 3) { last_bad = i; b = 3; }
                f = ((f << 2) | b) & mask;
                r = (r >> 2) | ((3 - b) << rev_shift);
                if (i < k - 1) continue;
                const int64_t p = i - k + 1;
                const uint8_t fc = (f <= r);
                isf[p] = fc;
                h[p] = (last_bad >= p) ? ~0ULL : mm_hash64(fc ? f : r);
            }
            uint64_t* oh = out_h + out_off[si];
            int64_t* op = out_pos + out_off[si];
            uint8_t* of = out_fwd + out_off[si];
            int64_t cnt = 0;
            if (n < w) {
                int64_t best = 0;
                for (int64_t i = 1; i < n; i++)
                    if (h[i] < h[best]) best = i;
                if (h[best] != ~0ULL) {
                    oh[0] = h[best]; op[0] = best; of[0] = isf[best]; cnt = 1;
                }
                out_cnt[si] = cnt;
                continue;
            }
            // monotonic deque; strict pop keeps leftmost equal minima in front
            dq.resize(n);
            int64_t head = 0, tail = 0, last_out = -1;
            for (int64_t i = 0; i < n; i++) {
                while (tail > head && h[dq[tail - 1]] > h[i]) tail--;
                dq[tail++] = i;
                const int64_t wstart = i - w + 1;
                if (wstart < 0) continue;
                while (dq[head] < wstart) head++;
                const int64_t p = dq[head];
                if (p != last_out) {
                    if (h[p] != ~0ULL) { oh[cnt] = h[p]; op[cnt] = p; of[cnt] = isf[p]; cnt++; }
                    last_out = p;
                }
            }
            out_cnt[si] = cnt;
        }
    }
}

// Minimizer sketch (exact twin of ops/kmers.py minimizer_sketch /
// seeding.rs:99-187, including the UNMASKED warm-up accumulator and the
// first-emission-is-raw-canonical quirks).  Inputs decode through
// BYTE_TO_SEQ (types.rs:92-101), so both raw 2-bit codes and ASCII hash
// identically.  out arrays have capacity len-k+1 per sequence at
// out_off[si]; emissions are (value u64, global k-mer position u64).
void minimizer_sketch_batch(
    const uint8_t* codes, const int64_t* offsets, int64_t n_seqs,
    int w, int k,
    uint64_t* out_vals, uint64_t* out_pos,
    const int64_t* out_off, int64_t* out_cnt, int n_threads) {
    // thread-safe one-time init (C++11 magic static)
    static const uint8_t* B2S = []() {
        static uint8_t t[256] = {0};
        t[1] = 1; t[2] = 2; t[3] = 3;
        t['C'] = 1; t['G'] = 2; t['T'] = 3; t['U'] = 3;
        t['c'] = 1; t['g'] = 2; t['t'] = 3; t['u'] = 3;
        return t;
    }();
#ifdef _OPENMP
    const int nt = (n_threads > 0) ? n_threads
                   : (n_seqs > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel num_threads(nt)
#endif
    {
        std::vector<uint64_t> window((size_t)w);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t si = 0; si < n_seqs; si++) {
            const uint8_t* seq = codes + offsets[si];
            const int64_t len = offsets[si + 1] - offsets[si];
            out_cnt[si] = 0;
            if (len < (int64_t)k + w - 1) continue;
            const uint64_t max_mask = ~0ULL >> (64 - 2 * k);
            const uint64_t rev_mask = ~(3ULL << (2 * k - 2));
            const int rev_shift = 2 * (k - 1);
            uint64_t f = 0, r = 0, canonical = 0;
            // warm-up: f is deliberately NOT masked (seeding.rs:123-141)
            for (int64_t i = 0; i < (int64_t)k + w - 1; i++) {
                const uint64_t c = B2S[seq[i]];
                f = (f << 2) | c;
                r = (r >> 2) | ((3 - c) << rev_shift);
                if (i >= k - 1) {
                    canonical = (f < r) ? f : r;
                    window[i + 1 - k] = mm_hash64(canonical);
                }
            }
            // position_min: ties -> LAST index (Rust max_by semantics)
            int64_t min_pos = 0;
            uint64_t min_val = window[0];
            for (int j = 1; j < w; j++)
                if (window[j] <= min_val) { min_val = window[j]; min_pos = j; }
            uint64_t* ov = out_vals + out_off[si];
            uint64_t* op = out_pos + out_off[si];
            int64_t cnt = 0;
            ov[cnt] = canonical;  // quirk: warm-up's final canonical value
            op[cnt] = (uint64_t)min_pos;
            cnt++;
            for (int64_t i = (int64_t)k + w - 1; i < len; i++) {
                const uint64_t c = B2S[seq[i]];
                f = ((f << 2) | c) & max_mask;
                r = ((r >> 2) & rev_mask) | ((3 - c) << rev_shift);
                const uint64_t canon = (f < r) ? f : r;
                const uint64_t h = mm_hash64(canon);
                const int64_t gp = i - k + 1;
                const int64_t slot = gp % w;
                window[slot] = h;
                if (h < min_val) {
                    min_val = h;
                    min_pos = slot;
                    ov[cnt] = h;
                    op[cnt] = (uint64_t)gp;
                    cnt++;
                } else if (min_pos == slot) {
                    min_pos = 0;
                    min_val = window[0];
                    for (int j = 1; j < w; j++)
                        if (window[j] <= min_val) { min_val = window[j]; min_pos = j; }
                    const int64_t off = ((slot - min_pos) % w + w) % w;
                    ov[cnt] = min_val;
                    op[cnt] = (uint64_t)(gp - off);
                    cnt++;
                }
            }
            out_cnt[si] = cnt;
        }
    }
}

// Chaining + band planning for anchor groups (semantic twin of ops/align.py
// _chain_anchors + _band_centers + the lo computation in plan_jobs_batch).
// Anchors are pre-sorted by (group, qpos, tpos).  Per group g, writes the
// band lower bound lo (length qlen[g]) at out_lo + out_off[g] and the chain
// length in out_nchain[g] (0 = too few anchors, caller skips the group).
void chain_band_batch(
    const int64_t* qa, const int64_t* ta,
    const int64_t* grp_off, int64_t n_groups,
    const int64_t* qlen, const int64_t* tlen,
    int band, int min_anchors,
    int32_t* out_lo, const int64_t* out_off, int64_t* out_nchain,
    int n_threads) {
#ifdef _OPENMP
    const int nt = (n_threads > 0) ? n_threads
                   : (n_groups > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel num_threads(nt)
#endif
    {
        std::vector<int64_t> tails, tails_vals, parent, cq, ct, cbuf;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t g = 0; g < n_groups; g++) {
            const int64_t s = grp_off[g], e = grp_off[g + 1];
            const int64_t n = e - s;
            out_nchain[g] = 0;
            if (n < min_anchors) continue;

            // LIS on tpos (strictly increasing), same tie rules as the
            // Python bisect_left version
            tails.clear(); tails_vals.clear();
            parent.assign(n, -1);
            for (int64_t i = 0; i < n; i++) {
                const int64_t v = ta[s + i];
                // collinear fast path: most anchors extend the chain, so
                // probe the append case before the O(log) search (same
                // pos as lower_bound returning end())
                if (!tails_vals.empty() && v > tails_vals.back()) {
                    parent[i] = tails.back();
                    tails.push_back(i);
                    tails_vals.push_back(v);
                    continue;
                }
                const int64_t pos = std::lower_bound(tails_vals.begin(), tails_vals.end(), v)
                                    - tails_vals.begin();
                if (pos > 0) parent[i] = tails[pos - 1];
                if (pos == (int64_t)tails.size()) {
                    tails.push_back(i);
                    tails_vals.push_back(v);
                } else {
                    tails[pos] = i;
                    tails_vals[pos] = v;
                }
            }
            cq.clear(); ct.clear();
            for (int64_t cur = tails.back(); cur != -1; cur = parent[cur]) {
                cq.push_back(qa[s + cur]);
                ct.push_back(ta[s + cur]);
            }
            std::reverse(cq.begin(), cq.end());
            std::reverse(ct.begin(), ct.end());
            const int64_t nc = (int64_t)cq.size();
            if (nc < min_anchors) continue;
            out_nchain[g] = nc;

            // band centers: np.interp between chain anchors (exact hit on a
            // duplicated x returns the LAST duplicate's value), diagonal
            // extrapolation outside, ties-to-even rounding, running max;
            // then lo = cummax(clip(centers - b/2, 0, max(tlen-b, 0)))
            //
            // Two passes: (1) branch-free per-interval center fill — the
            // nearbyint expression is IDENTICAL to the former per-x loop
            // (ties-to-even, same slope hoist), just grouped by interval so
            // the compiler can vectorize it; (2) scalar cummax/clip/store
            // sweep (trivial ALU, store-bandwidth-bound).
            const int64_t m = qlen[g];
            const int64_t tl = tlen[g];
            const int64_t b = std::min<int64_t>(band, std::max<int64_t>(8, tl));
            const int64_t lo_max = std::max<int64_t>(tl - b, 0);
            int32_t* lo = out_lo + out_off[g];
            cbuf.resize(m);
            int64_t* cb = cbuf.data();
            // head: x < cq[0], diagonal extrapolation
            const int64_t head = std::min<int64_t>(std::max<int64_t>(cq[0], 0), m);
            for (int64_t x = 0; x < head; x++)
                cb[x] = ct[0] - (cq[0] - x);
            // interior intervals [cq[j], min(cq[j+1], m)): exact hit at the
            // interval start (handles duplicated x via empty intervals —
            // the LAST duplicate owns the point), interpolation after
            for (int64_t j = 0; j + 1 < nc; j++) {
                const int64_t xs = std::max<int64_t>(cq[j], 0);
                const int64_t xe = std::min<int64_t>(cq[j + 1], m);
                if (xs >= xe) continue;
                const double slope = (double)(ct[j + 1] - ct[j]) /
                                     (double)(cq[j + 1] - cq[j]);
                const double base = (double)ct[j];
                const int64_t x0 = cq[j];
                if (cq[j] >= 0 && cq[j] < m) cb[cq[j]] = ct[j];
                // rint == nearbyint value-wise (nearest-even under the
                // default FP mode, which nothing here changes); gcc refuses
                // to vectorize nearbyint (inexact-flag semantics) but emits
                // vrndscalepd for rint
                for (int64_t x = std::max<int64_t>(xs, x0 + 1); x < xe; x++)
                    cb[x] = (int64_t)std::rint(slope * (double)(x - x0) + base);
            }
            // tail: x >= cq[nc-1] — exact value at the last anchor, then
            // diagonal extrapolation
            if (cq[nc - 1] >= 0 && cq[nc - 1] < m) cb[cq[nc - 1]] = ct[nc - 1];
            for (int64_t x = std::max<int64_t>(cq[nc - 1] + 1, 0); x < m; x++)
                cb[x] = ct[nc - 1] + (x - cq[nc - 1]);
            int64_t run_c = INT64_MIN, run_lo = 0;
            for (int64_t x = 0; x < m; x++) {
                const int64_t c = cb[x];
                if (c > run_c) run_c = c;
                int64_t l = run_c - b / 2;
                if (l < 0) l = 0;
                if (l > lo_max) l = lo_max;
                if (l > run_lo) run_lo = l;
                if (x == 0) run_lo = l;
                // NT store: lo planes are written once here and read much
                // later (after all groups) by the DP kernel — no reuse to
                // cache, and the write volume is ~qlen*8B per kept group
#if defined(__x86_64__)
                _mm_stream_si32((int*)&lo[x], (int)run_lo);
#else
                lo[x] = (int32_t)run_lo;
#endif
            }
        }
#if defined(__x86_64__)
        _mm_sfence();  // NT stores must land before the caller's DP reads
#endif
    }
}

// Minimizer bitmask join (exact twin of the n_asvs<=64 branch in
// stage7_em._all_snpmer_candidates): per read, count how many of its
// (unique, sorted) minimizers appear in each ASV's unique minimizer set.
// keys is the sorted union of all ASV minimizers, masks[i] has bit a set
// iff ASV a contains keys[i].  out is (n_reads, n_asvs) int64, zeroed by
// the caller.
void mini_mask_join(const uint64_t* keys, const uint64_t* masks, int64_t nk,
                    const uint64_t* qm, const int64_t* q_start,
                    const int64_t* q_cnt, int64_t n_reads,
                    int n_asvs, int64_t* out, int n_threads) {
    if (nk == 0) return;
#ifdef _OPENMP
    const int nt = (n_threads > 0) ? n_threads
                   : (n_reads > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel for schedule(static) num_threads(nt)
#endif
    for (int64_t r = 0; r < n_reads; r++) {
        int64_t* row = out + (size_t)r * n_asvs;
        for (int64_t i = q_start[r]; i < q_start[r] + q_cnt[r]; i++) {
            const uint64_t v = qm[i];
            const uint64_t* p = std::lower_bound(keys, keys + nk, v);
            if (p == keys + nk || *p != v) continue;
            uint64_t m = masks[p - keys];
            while (m) {
                const int a = __builtin_ctzll(m);
                row[a]++;
                m &= m - 1;
            }
        }
    }
}

// Solid-filter masks (kmer_comp.rs:163-208; exact twin of the numpy body
// of stage1_kmers._apply_solid_filters): per read, a minimizer is solid
// iff its within-read multiplicity is <= max_count and it is not in the
// sorted high-frequency set; a SNPmer survives iff not high-frequency.
// The repetitive-read drop decision stays in Python (needs base_length).
void solid_filter_batch(const uint64_t* minis, const int64_t* m_off,
                        const uint64_t* snps, const int64_t* s_off,
                        int64_t n_reads, const uint64_t* hf, int64_t n_hf,
                        int64_t max_count, uint8_t* mini_solid,
                        uint8_t* snp_solid, int threads) {
#pragma omp parallel num_threads(threads)
    {
        std::vector<uint64_t> sorted;
#pragma omp for schedule(dynamic, 64)
        for (int64_t r = 0; r < n_reads; r++) {
            const int64_t ms = m_off[r], me = m_off[r + 1];
            sorted.assign(minis + ms, minis + me);
            std::sort(sorted.begin(), sorted.end());
            for (int64_t i = ms; i < me; i++) {
                auto range = std::equal_range(sorted.begin(), sorted.end(), minis[i]);
                bool ok = (range.second - range.first) <= max_count;
                if (ok && n_hf)
                    ok = !std::binary_search(hf, hf + n_hf, minis[i]);
                mini_solid[i] = ok;
            }
            for (int64_t i = s_off[r]; i < s_off[r + 1]; i++)
                snp_solid[i] =
                    !(n_hf && std::binary_search(hf, hf + n_hf, snps[i]));
        }
    }
}

// Join read SNPmers against the flat sorted consensus-SNPmer table and
// count per-(read, cluster) matches/mismatches (the inner join of
// asv_cluster.rs:1007-1130 read reassignment; exact twin of the numpy
// expansion in stage23_cluster._reassign_reads).  ridx must be
// non-decreasing (reads flattened in order): thread chunks are aligned to
// read boundaries so no two threads touch the same output row.
void snpmer_join_count(const uint64_t* sms, const uint64_t* kms,
                       const int64_t* ridx, int64_t n, const uint64_t* c_sm,
                       const uint64_t* c_km, const int64_t* c_cid, int64_t m,
                       int64_t C, int64_t* m_mat, int64_t* mm_mat,
                       int threads) {
    if (n <= 0 || m <= 0) return;
    std::vector<int64_t> start(threads + 1);
    for (int t = 0; t <= threads; t++) {
        int64_t s = n * t / threads;
        while (s > 0 && s < n && ridx[s] == ridx[s - 1]) s++;
        start[t] = s;
    }
    start[threads] = n;
#pragma omp parallel num_threads(threads)
    {
        int t = omp_get_thread_num();
        for (int64_t i = start[t]; i < start[t + 1]; i++) {
            const uint64_t q = sms[i];
            const uint64_t* lo = std::lower_bound(c_sm, c_sm + m, q);
            for (const uint64_t* p = lo; p < c_sm + m && *p == q; p++) {
                const int64_t j = p - c_sm;
                int64_t* mat = (c_km[j] == kms[i]) ? m_mat : mm_mat;
                mat[ridx[i] * C + c_cid[j]]++;
            }
        }
    }
}

// Canonical k-mers at sorted positions (types.rs:622-663 semantics; exact
// twin of ops/kmers.kmer_at_position): canonical by MASKED comparison,
// forward k-mer on ties.  One rolling pass per read, emitting when the
// window start matches the next requested position.
void kmer_at_positions_batch(const uint8_t* codes, const int64_t* off,
                             int64_t n_reads, const uint32_t* pos,
                             const int64_t* pos_off, int k, uint64_t* out,
                             int threads) {
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const uint64_t split_mask = ~(3ULL << (k - 1));
    const int rev_shift = 2 * (k - 1);
#pragma omp parallel for schedule(dynamic, 64) num_threads(threads)
    for (int64_t r = 0; r < n_reads; r++) {
        const uint8_t* c = codes + off[r];
        const int64_t len = off[r + 1] - off[r];
        int64_t pi = pos_off[r];
        const int64_t pe = pos_off[r + 1];
        if (pi == pe) continue;
        uint64_t f = 0, rv = 0;
        for (int64_t i = 0; i < len && pi < pe; i++) {
            const uint64_t b = c[i];
            f = ((f << 2) | b) & mask;
            rv = (rv >> 2) | ((3 - b) << rev_shift);
            if (i < k - 1) continue;
            const int64_t p = i - k + 1;
            while (pi < pe && (int64_t)pos[pi] == p) {
                out[pi++] = ((rv & split_mask) < (f & split_mask)) ? rv : f;
            }
        }
    }
}

// Sequential greedy LSH clustering (asv_cluster.rs:72-249; exact twin of
// stage23_cluster.cluster_reads_by_kmers).  Inherently order-dependent, so
// single-threaded — the win over the Python loop is constant-factor (no
// numpy dispatch per candidate).  Similarity comparisons use exact integer
// cross-multiplication: count/denom ordering is preserved under the
// monotonic ^(1/k), so results match the Python float path except at
// exact-boundary pow roundings that integer ratios cannot hit.
// sigs (n_reads, n_tables) with sig_valid 0 marking None; minis raw
// (UNFILTERED) per-read minimizer k-mers, concatenated with offsets.
// thresh_pow_k = KMER_CLUSTER_THRESHOLD ** k (computed host-side).
// assignment[r] = representative read id (r itself for new reps).
void lsh_greedy_cluster(const uint64_t* sigs, const uint8_t* sig_valid,
                        int n_tables, const uint64_t* minis,
                        const int64_t* mini_off, int64_t n_reads,
                        double thresh_pow_k, int top_n, int64_t* assignment) {
    // parallel pre-pass: sorted-unique mini set per read, in place in one
    // flat buffer (order-independent, so it can run ahead of the greedy
    // loop); the serial loop then does zero per-read sorting, and a read
    // that becomes a representative serves its span directly
    std::vector<uint64_t> ubuf(minis, minis + mini_off[n_reads]);
    std::vector<int64_t> ulen(n_reads);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 256)
#endif
    for (int64_t r = 0; r < n_reads; r++) {
        uint64_t* b = ubuf.data() + mini_off[r];
        uint64_t* e = ubuf.data() + mini_off[r + 1];
        std::sort(b, e);
        ulen[r] = std::unique(b, e) - b;
    }

    std::vector<std::unordered_map<uint64_t, std::vector<int64_t>>> buckets(n_tables);

    // per-read selection against the CURRENT representative state (buckets
    // only change when a read becomes a new rep).  Returns the chosen rep
    // id or -1 (new representative).  Scratch passed in so parallel
    // callers get thread-local maps.
    auto select = [&](int64_t r, std::unordered_map<int64_t, int64_t>& hits,
                      std::vector<std::pair<int64_t, int64_t>>& cand) -> int64_t {
        hits.clear();
        for (int t = 0; t < n_tables; t++) {
            if (!sig_valid[r * n_tables + t]) continue;
            auto it = buckets[t].find(sigs[r * n_tables + t]);
            if (it == buckets[t].end()) continue;
            for (int64_t c : it->second) hits[c]++;
        }
        int64_t best_rep = -1;
        if (!hits.empty()) {
            cand.clear();
            for (auto& kv : hits) cand.push_back({kv.second, kv.first});
            // (hits desc, cand_id desc) — asv_cluster.rs:111
            std::sort(cand.begin(), cand.end(),
                      [](const std::pair<int64_t, int64_t>& a,
                         const std::pair<int64_t, int64_t>& b) {
                          if (a.first != b.first) return a.first > b.first;
                          return a.second > b.second;
                      });
            const int64_t max_hits = cand[0].first;

            const uint64_t* rs = ubuf.data() + mini_off[r];
            const int64_t rs_n = ulen[r];

            int64_t best_c = 0, best_d = 1;  // best ratio as exact rational
            int64_t checked = 0;
            for (auto& hc : cand) {
                if (!(hc.first == max_hits || checked < top_n)) break;
                checked++;
                const int64_t c = hc.second;
                const uint64_t* rep = ubuf.data() + mini_off[c];
                const int64_t rep_n = ulen[c];
                // denom quirk: UNIQUE count for the current read vs RAW
                // vector length for the representative (asv_cluster.rs)
                const int64_t denom =
                    std::max(rs_n, mini_off[c + 1] - mini_off[c]);
                if (denom == 0) continue;
                // exact upper bound on the intersection: if it cannot
                // STRICTLY beat the running best (the update is >), skip
                // the merge — candidates are hit-sorted, so the best is
                // usually found first
                const int64_t ub = std::min(rs_n, rep_n);
                if (ub * best_d <= best_c * denom) continue;
                // sorted-set intersection by two-pointer merge (both sides
                // sorted+unique): O(n+m) vs n*log m binary searches
                int64_t count = 0;
                {
                    const uint64_t *a = rs, *ae = rs + rs_n;
                    const uint64_t *b = rep, *be = rep + rep_n;
                    while (a != ae && b != be) {
                        if (*a < *b) ++a;
                        else if (*b < *a) ++b;
                        else { count++; ++a; ++b; }
                    }
                }
                if (count * best_d > best_c * denom) {  // sim > best_sim
                    best_c = count;
                    best_d = denom;
                    best_rep = c;
                }
            }
            // best_sim <= threshold -> new representative
            if ((double)best_c / (double)best_d <= thresh_pow_k) best_rep = -1;
        }
        return best_rep;
    };

    // block-speculative execution of the inherently serial greedy loop:
    // evaluate a block of reads IN PARALLEL against the rep-state snapshot
    // at block start, then walk the block serially.  The rep state changes
    // ONLY when a read becomes a new representative, and a later read's
    // candidate set can change ONLY if it shares an LSH bucket with a rep
    // created earlier in the same block — so a speculative result is
    // committed unless one of the read's signatures hits a bucket key
    // inserted this block (exact per-table sig-set check), in which case
    // that read alone is recomputed serially against the live state.
    // Bit-identical to the pure serial loop by construction.
    const int64_t BLK = 2048;
    std::vector<int64_t> tent(std::min(BLK, n_reads));
    std::unordered_map<int64_t, int64_t> s_hits;
    std::vector<std::pair<int64_t, int64_t>> s_cand;
    std::vector<std::unordered_set<uint64_t>> new_sigs(n_tables);
    for (int64_t bs = 0; bs < n_reads; bs += BLK) {
        const int64_t be = std::min(bs + BLK, n_reads);
#ifdef _OPENMP
#pragma omp parallel
        {
            std::unordered_map<int64_t, int64_t> hits;
            std::vector<std::pair<int64_t, int64_t>> cand;
#pragma omp for schedule(dynamic, 16)
            for (int64_t r = bs; r < be; r++)
                tent[r - bs] = select(r, hits, cand);
        }
#else
        for (int64_t r = bs; r < be; r++)
            tent[r - bs] = select(r, s_hits, s_cand);
#endif
        bool any_new = false;
        for (int t = 0; t < n_tables; t++)
            new_sigs[t].clear();
        for (int64_t r = bs; r < be; r++) {
            bool stale = false;
            if (any_new)
                for (int t = 0; t < n_tables; t++)
                    if (sig_valid[r * n_tables + t] &&
                        new_sigs[t].count(sigs[r * n_tables + t])) {
                        stale = true;
                        break;
                    }
            const int64_t best_rep =
                stale ? select(r, s_hits, s_cand) : tent[r - bs];
            if (best_rep >= 0) {
                assignment[r] = best_rep;
            } else {
                for (int t = 0; t < n_tables; t++)
                    if (sig_valid[r * n_tables + t]) {
                        buckets[t][sigs[r * n_tables + t]].push_back(r);
                        new_sigs[t].insert(sigs[r * n_tables + t]);
                    }
                assignment[r] = r;
                any_new = true;
            }
        }
    }
}

// Greedy zero-mismatch SNPmer sub-clustering within one k-mer cluster
// (asv_cluster.rs:593-693; exact twin of the non-blockmer path of
// stage23_cluster._snpmer_subcluster).  Reads arrive in cluster order;
// each is assigned to the representative with (most matches, smallest
// current cluster, smallest id) among reps with >= 1 splitmer match and
// 0 mismatches, else becomes a new representative.  snps = per-read
// UNFILTERED snpmer k-mers concatenated with offsets; mask zeroes the
// mid-base bits.  assignment[i] = local index of the representative.
void snpmer_greedy_subcluster(const uint64_t* snps, const int64_t* off,
                              int64_t n_reads, uint64_t mask,
                              int64_t* assignment) {
    // splitmer -> (full kmer, rep local id) entries, in insertion order
    std::unordered_map<uint64_t, std::vector<std::pair<uint64_t, int64_t>>> index;
    std::vector<int64_t> rep_size(n_reads, 0);
    std::unordered_map<int64_t, std::pair<int64_t, int64_t>> scores;  // rep -> (m, mm)

    for (int64_t i = 0; i < n_reads; i++) {
        const int64_t s = off[i], e = off[i + 1];
        scores.clear();
        for (int64_t j = s; j < e; j++) {
            auto it = index.find(snps[j] & mask);
            if (it == index.end()) continue;
            for (auto& ent : it->second) {
                auto& sc = scores[ent.second];
                if (ent.first == snps[j])
                    sc.first++;
                else
                    sc.second++;
            }
        }
        int64_t best = -1, best_m = 0, best_sz = 0;
        for (auto& kv : scores) {
            if (kv.second.first <= 0 || kv.second.second != 0) continue;
            const int64_t m = kv.second.first, sz = rep_size[kv.first];
            if (best < 0 || m > best_m || (m == best_m && sz < best_sz) ||
                (m == best_m && sz == best_sz && kv.first < best)) {
                best = kv.first;
                best_m = m;
                best_sz = sz;
            }
        }
        if (best >= 0) {
            assignment[i] = best;
            rep_size[best]++;
        } else {
            assignment[i] = i;
            rep_size[i] = 1;
            for (int64_t j = s; j < e; j++)
                index[snps[j] & mask].push_back({snps[j], i});
        }
    }
}

// Parallel multi-cluster entry point for snpmer_greedy_subcluster: clusters are
// independent (the greedy order matters only WITHIN a cluster), so each
// runs on its own thread.  c_off indexes reads (cluster c = reads
// [c_off[c], c_off[c+1]) of the concatenated read stream); `off` holds
// ABSOLUTE offsets into snps, so per-cluster calls are pointer shifts.
// assignment[i] is local to read i's cluster (same contract as the
// single-cluster entry point).
void snpmer_greedy_subcluster_multi(const uint64_t* snps, const int64_t* off,
                                    const int64_t* c_off, int64_t n_clusters,
                                    uint64_t mask, int64_t* assignment,
                                    int threads) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) \
    num_threads(threads > 0 ? threads : 1)
#endif
    for (int64_t c = 0; c < n_clusters; c++) {
        const int64_t rs = c_off[c];
        snpmer_greedy_subcluster(snps, off + rs, c_off[c + 1] - rs, mask,
                                 assignment + rs);
    }
}

// Batched LSH signatures (types.rs:719-747 semantics, matches
// core.py compute_lsh_signatures bit-for-bit).  For each read and table
// seed t in [0, n_tables): rank the read's UNFILTERED minimizer k-mers by
// FxHash64 fed [seed, kmer] (ties keep input order), take the `bucket`
// lowest, signature = XOR_j kmer_j * (j+1) with wrapping multiplies.
// out_sigs is (n_reads, n_tables); out_valid[r]=0 when the read has fewer
// than `bucket` minimizers (Python side maps those to None).
void lsh_batch(const uint64_t* minis, const int64_t* off, int64_t n_reads,
               int n_tables, int bucket, uint64_t* out_sigs,
               uint8_t* out_valid, int threads) {
    const uint64_t FX = 0x517CC1B727220A95ULL;
#pragma omp parallel for schedule(dynamic, 64) num_threads(threads)
    for (int64_t r = 0; r < n_reads; r++) {
        const int64_t s = off[r], e = off[r + 1];
        const int64_t n = e - s;
        if (n < bucket) {
            out_valid[r] = 0;
            continue;
        }
        out_valid[r] = 1;
        for (int t = 0; t < n_tables; t++) {
            const uint64_t seed_h = (uint64_t)t * FX;
            const uint64_t rot = (seed_h << 5) | (seed_h >> 59);
            // bottom-`bucket` (h, idx) with stable ties; bucket is 3 in
            // practice so insertion into a tiny array is fastest
            uint64_t best_h[8];
            int64_t best_i[8];
            int filled = 0;
            for (int64_t i = 0; i < n; i++) {
                uint64_t h = (rot ^ minis[s + i]) * FX;
                if (filled == bucket && h >= best_h[bucket - 1]) continue;
                int j = filled < bucket ? filled : bucket - 1;
                while (j > 0 && best_h[j - 1] > h) {
                    best_h[j] = best_h[j - 1];
                    best_i[j] = best_i[j - 1];
                    j--;
                }
                best_h[j] = h;
                best_i[j] = i;
                if (filled < bucket) filled++;
            }
            uint64_t sig = 0;
            for (int j = 0; j < bucket; j++)
                sig ^= minis[s + best_i[j]] * (uint64_t)(j + 1);
            out_sigs[r * n_tables + t] = sig;
        }
    }
}

}  // extern "C"

// ── consensus-SNPmer reclustering (asv_cluster.rs:830-1270) ────────────────
//
// Consensus per cluster: group member SNPmers (full k-mers from the
// FILTERED snpmers_vec view) by value, count; per splitmer keep the
// variant with max (count, kmer); keep if count >= max(size/6, 1).
// Positions/medians are not tracked: the merge decision uses only the
// splitmer->kmer map and poly counts (exact twin of the Python
// build_consensus_snpmers + compare_consensus semantics).

namespace {

struct ReConsensus {
    std::vector<uint64_t> sm;  // sorted ascending, unique
    std::vector<uint64_t> km;
};

inline uint64_t re_splitmer(uint64_t km, int is_blockmer, int l, uint64_t mask) {
    return is_blockmer ? (km >> (2 * l)) : (km & mask);
}

// members[ms..me): read ids into r_km/r_koff; min_count from cluster size
static void re_build_consensus(const int64_t* members, int64_t ms, int64_t me,
                               const uint64_t* r_km, const int64_t* r_koff,
                               int is_blockmer, int l, uint64_t mask,
                               std::vector<uint64_t>& buf, ReConsensus& out) {
    out.sm.clear();
    out.km.clear();
    buf.clear();
    for (int64_t m = ms; m < me; m++) {
        const int64_t r = members[m];
        buf.insert(buf.end(), r_km + r_koff[r], r_km + r_koff[r + 1]);
    }
    if (buf.empty()) return;
    std::sort(buf.begin(), buf.end());
    // unique kmers + counts -> (sm, count, km) sorted by (sm, count, km)
    struct Poly { uint64_t sm, km; int64_t cnt; };
    std::vector<Poly> polys;
    for (size_t i = 0; i < buf.size();) {
        size_t j = i + 1;
        while (j < buf.size() && buf[j] == buf[i]) j++;
        polys.push_back({re_splitmer(buf[i], is_blockmer, l, mask), buf[i],
                         (int64_t)(j - i)});
        i = j;
    }
    std::sort(polys.begin(), polys.end(), [](const Poly& a, const Poly& b) {
        if (a.sm != b.sm) return a.sm < b.sm;
        if (a.cnt != b.cnt) return a.cnt < b.cnt;
        return a.km < b.km;
    });
    const int64_t size = me - ms;
    const int64_t min_count = std::max<int64_t>(size / 6, 1);
    for (size_t i = 0; i < polys.size(); i++) {
        if (i + 1 < polys.size() && polys[i + 1].sm == polys[i].sm) continue;
        if (polys[i].cnt >= min_count) {
            out.sm.push_back(polys[i].sm);
            out.km.push_back(polys[i].km);
        }
    }
}

// matches/mismatches over shared splitmers (symmetric: sm unique per side)
static void re_compare(const ReConsensus& a, const ReConsensus& b,
                       int64_t& m, int64_t& mm) {
    m = mm = 0;
    size_t i = 0, j = 0;
    while (i < a.sm.size() && j < b.sm.size()) {
        if (a.sm[i] < b.sm[j]) i++;
        else if (a.sm[i] > b.sm[j]) j++;
        else {
            if (a.km[i] == b.km[j]) m++; else mm++;
            i++; j++;
        }
    }
}

}  // namespace

extern "C" {

// One greedy merge round over clusters pre-sorted by (-size, first member).
// Consensuses are built once at entry (stale during the pass, like the
// reference); cluster SIZES grow as merges land.  merged_into[j] = index of
// the surviving cluster j merged into, or -1.  Returns the merge count.
int64_t recluster_round(const int64_t* members, const int64_t* m_off,
                        int64_t n_clusters, const uint64_t* r_km,
                        const int64_t* r_koff, int is_blockmer, int l,
                        uint64_t sm_mask, int64_t* merged_into, int threads) {
    std::vector<ReConsensus> cons(n_clusters);
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1)
#endif
    {
        std::vector<uint64_t> buf;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t c = 0; c < n_clusters; c++)
            re_build_consensus(members, m_off[c], m_off[c + 1], r_km, r_koff,
                               is_blockmer, l, sm_mask, buf, cons[c]);
    }
    std::vector<int64_t> size(n_clusters);
    for (int64_t c = 0; c < n_clusters; c++) size[c] = m_off[c + 1] - m_off[c];
    for (int64_t c = 0; c < n_clusters; c++) merged_into[c] = -1;
    int64_t num_merges = 0;
    std::vector<char> merged(n_clusters, 0);
    for (int64_t i = 0; i < n_clusters; i++) {
        if (merged[i]) continue;
        const int64_t li = (int64_t)cons[i].sm.size();
        for (int64_t j = i + 1; j < n_clusters; j++) {
            if (merged[j]) continue;
            int64_t m, mm;
            re_compare(cons[i], cons[j], m, mm);
            const int64_t lj = (int64_t)cons[j].sm.size();
            // concordant both ways (m/mm symmetric for unique-sm maps)
            bool conc = mm == 0 &&
                        m >= std::min(li, std::max<int64_t>(lj, 2)) &&
                        m >= std::min(lj, std::max<int64_t>(li, 2));
            const int64_t max_len = std::max(size[i], size[j]);
            const int64_t min_len = std::min(size[i], size[j]);
            // size-disparity overrides (asv_cluster.rs:1208-1224); the
            // 0.975 threshold is evaluated in double like the Python twin
            if (mm == 0 && (double)m > (double)std::min(li, lj) * 0.975 &&
                max_len / min_len > 50)
                conc = true;
            if (mm == 0 && max_len / min_len > 500 && min_len <= 2)
                conc = true;
            if (conc) {
                merged_into[j] = i;
                merged[j] = 1;
                size[i] += size[j];
                num_merges++;
            }
        }
    }
    return num_merges;
}

// Batched consensus build over final clusters (for read reassignment):
// emits flat (sm, km, cid) with capacity = total member kmers; returns the
// emitted count.  Output is ordered by cluster then sm ascending.
int64_t consensus_batch(const int64_t* members, const int64_t* m_off,
                        int64_t n_clusters, const uint64_t* r_km,
                        const int64_t* r_koff, int is_blockmer, int l,
                        uint64_t sm_mask, uint64_t* out_sm, uint64_t* out_km,
                        int64_t* out_cid, int threads) {
    std::vector<ReConsensus> cons(n_clusters);
#ifdef _OPENMP
#pragma omp parallel num_threads(threads > 0 ? threads : 1)
#endif
    {
        std::vector<uint64_t> buf;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t c = 0; c < n_clusters; c++)
            re_build_consensus(members, m_off[c], m_off[c + 1], r_km, r_koff,
                               is_blockmer, l, sm_mask, buf, cons[c]);
    }
    int64_t w = 0;
    for (int64_t c = 0; c < n_clusters; c++) {
        for (size_t x = 0; x < cons[c].sm.size(); x++) {
            out_sm[w] = cons[c].sm[x];
            out_km[w] = cons[c].km[x];
            out_cid[w] = c;
            w++;
        }
    }
    return w;
}

}  // extern "C"

extern "C" {

// Compact per-read prefix regions of an oversized scratch buffer into an
// exact-size buffer: region i lives at src + src_off[i]*elt and holds
// cnt[i] elements; it lands at dst + dst_off[i]*elt (dst_off = cumsum cnt).
// Element type erased to bytes so one entry point serves u32/u64/u8.
void gather_ranges(const uint8_t* src, const int64_t* src_off,
                   const int64_t* cnt, const int64_t* dst_off, int64_t n,
                   int64_t elt, uint8_t* dst, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads > 0 ? threads : 1)
    for (int64_t i = 0; i < n; i++) {
        if (cnt[i] > 0)
            memcpy(dst + dst_off[i] * elt, src + src_off[i] * elt,
                   (size_t)(cnt[i] * elt));
    }
}

// Scatter-gather memcpy from n independently-allocated source ranges
// (raw pointers) into one dense buffer: range i is src_ptrs[i], holds
// cnt[i] elements of elt bytes, lands at dst + dst_off[i]*elt.  Serves the
// minimizer-pool cache assembly (per-entry numpy slice stores were ~1.4 s
// of Python dispatch at 100k reads).
void gather_ptr_ranges(const uint64_t* src_ptrs, const int64_t* cnt,
                       const int64_t* dst_off, int64_t n, int64_t elt,
                       uint8_t* dst, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads > 0 ? threads : 1)
    for (int64_t i = 0; i < n; i++) {
        if (cnt[i] > 0)
            memcpy(dst + dst_off[i] * elt, (const uint8_t*)(uintptr_t)src_ptrs[i],
                   (size_t)(cnt[i] * elt));
    }
}

// Reverse-complement align codes (0..3 bases, >=4 ambiguous kept as-is)
// for n concatenated ranges: dst[off[i]:off[i+1]] = reverse of the src
// range with c<4 mapped to 3-c.  Replaces the NumPy reversed-index
// megagather in _qcodes_cached_batch (np.repeat + arange + fancy index
// built three full-size temporaries at 100k-read scale).
void revcomp_codes_ranges(const uint8_t* src, const int64_t* off, int64_t n,
                          uint8_t* dst, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads > 0 ? threads : 1)
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* s = src + off[i];
        uint8_t* d = dst + off[i];
        int64_t len = off[i + 1] - off[i];
        for (int64_t j = 0; j < len; j++) {
            uint8_t c = s[len - 1 - j];
            d[j] = c < 4 ? (uint8_t)(3 - c) : c;
        }
    }
}

}  // extern "C"

extern "C" {

// eq-flag + QualCompact3 levels + sequential error-prob sums for a batch
// of raw ASCII quality strings (native twin of the whole of
// stage1_kmers._batched_qual_fields).  quals: concatenated ASCII; off:
// (n+1); lut: 256 doubles (err prob per ASCII byte).  Outputs per read i:
// eq[i] = all-bases-equal flag, levels at lvl_off[i] (ceil(len/4)
// entries, 4-base min bins quantized to 0..15 like
// encode.quantize_qual_bin), est_sum[i] = strictly SEQUENTIAL
// sum_j lut[q[j]] — the same order as the reference's Rust accumulation
// (seeding.rs:801-817) and np.cumsum, which every Python path mirrors
// (est_id is a sort key and appears in outputs, so all paths must agree
// bit-exactly).
void qual_fields_batch(const uint8_t* quals, const int64_t* off, int64_t n,
                       const double* lut, uint8_t* eq, uint8_t* levels,
                       const int64_t* lvl_off, double* est_sum,
                       int n_threads) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    num_threads(n_threads > 0 ? n_threads : 1)
#endif
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* q = quals + off[i];
        const int64_t len = off[i + 1] - off[i];
        uint8_t* lvl = levels + lvl_off[i];
        est_sum[i] = 0.0;
        if (len == 0) {
            eq[i] = 0;
            continue;
        }
        uint8_t mn = 255, mx = 0;
        double s = 0.0;  // sequential: j strictly increasing across bins
        const int64_t nbins = (len + 3) / 4;
        for (int64_t b = 0; b < nbins; b++) {
            uint8_t m = 255;
            const int64_t hi = std::min(len, b * 4 + 4);
            for (int64_t j = b * 4; j < hi; j++) {
                const uint8_t v = q[j];
                m = std::min(m, v);
                mx = std::max(mx, v);
                s += lut[v];
            }
            mn = std::min(mn, m);
            lvl[b] = (m <= 34) ? 0
                               : (uint8_t)std::min<int>((m - 35) / 3 + 1, 15);
        }
        eq[i] = (mn == mx) ? 1 : 0;
        est_sum[i] = s;
    }
}

// Per-read pure-ACGT flags straight off the parsed bytes objects (no
// concatenation): out[i] = 1 iff every byte of seqs[i] is uppercase
// A/C/G/T.  Replaces the Python join + LUT gather + flatnonzero sweep
// (~0.4 s at 100k reads).
void pure_acgt_batch(const uint8_t* const* seqs, const int64_t* lens,
                     int64_t n, uint8_t* out, int n_threads) {
    static uint8_t ok[256];
    ok['A'] = ok['C'] = ok['G'] = ok['T'] = 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 256) \
    num_threads(n_threads > 0 ? n_threads : 1)
#endif
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* s = seqs[i];
        const int64_t len = lens[i];
        uint8_t acc = 1;
        for (int64_t j = 0; j < len; j++) acc &= ok[s[j]];
        out[i] = acc;
    }
}

}  // extern "C"

extern "C" {

// Per-segment sort + dedup of u64 values (native twin of per-read
// np.unique): segment i of vals (off[i]..off[i+1]) lands sorted+unique at
// out + out_off[i] with its length in cnt[i].
void sort_unique_batch(const uint64_t* vals, const int64_t* off, int64_t n,
                       uint64_t* out, const int64_t* out_off, int64_t* cnt,
                       int n_threads) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) \
    num_threads(n_threads > 0 ? n_threads : 1)
#endif
    for (int64_t i = 0; i < n; i++) {
        const int64_t len = off[i + 1] - off[i];
        uint64_t* dst = out + out_off[i];
        std::memcpy(dst, vals + off[i], (size_t)len * sizeof(uint64_t));
        std::sort(dst, dst + len);
        cnt[i] = std::unique(dst, dst + len) - dst;
    }
}

}  // extern "C"
