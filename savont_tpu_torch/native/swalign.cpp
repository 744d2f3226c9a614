// Banded affine Smith-Waterman batch kernel (host native path).
//
// Exact semantic twin of savont_tpu_torch/ops/align.py::banded_sw + _traceback:
// same prefix-max E formulation, same tie-breaking, same NM definition.
// Parallel over pairs with OpenMP.  Built by savont_tpu_torch/ops/native_build.py
// and loaded via ctypes; the NumPy implementation is the fallback and the
// correctness oracle (tests/test_native.py asserts equality).
//
// CIGAR ops: 0 = M, 1 = I (consumes query), 2 = D (consumes target).
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t MATCH = 2;
constexpr int32_t MISMATCH = -4;
constexpr int32_t GAP_OPEN = 4;
constexpr int32_t GAP_EXT = 2;
constexpr int32_t NEG = -20000;

struct Result {
    int32_t score, q0, q1, t0, t1, nm, cigar_len, overflow;
};

// Reused across pairs within a thread: rows 1..m are fully overwritten each
// call, so only row 0 of H (zeros) and F (NEG) needs initialization — this
// avoids ~1.5 MB of value-init per pair.
struct Scratch {
    std::vector<int16_t> H, E, F, G, twin;
    std::vector<int16_t> A, P, T, je2;
    std::vector<uint8_t> ops;
};

void align_one(const uint8_t* q, int32_t m, const uint8_t* t, int32_t n,
               const int32_t* lo_full /* m+1 */, int32_t band,
               Result* res, uint32_t* cigar_out, int32_t max_cigar,
               Scratch& sc) {
    res->score = 0;
    res->cigar_len = 0;
    res->overflow = 0;
    if (m <= 0 || n <= 0) return;

    const size_t cells = (size_t)(m + 1) * band;
    sc.H.resize(cells);
    sc.E.resize(cells);
    sc.F.resize(cells);
    sc.G.resize(cells);
    sc.twin.resize(band + 2);
    std::vector<int16_t>& H = sc.H;
    std::vector<int16_t>& E = sc.E;
    std::vector<int16_t>& F = sc.F;
    std::vector<int16_t>& G = sc.G;
    std::vector<int16_t>& twin = sc.twin;
    std::fill(H.begin(), H.begin() + band, (int16_t)0);
    std::fill(F.begin(), F.begin() + band, (int16_t)NEG);
    sc.A.resize(band);
    sc.P.resize(band);
    sc.T.resize(band);
    if ((int32_t)sc.je2.size() != band) {
        sc.je2.resize(band);
        for (int32_t j = 0; j < band; j++) sc.je2[j] = (int16_t)(GAP_EXT * j);
    }
    int16_t* __restrict A = sc.A.data();
    int16_t* __restrict P = sc.P.data();
    int16_t* __restrict T = sc.T.data();
    const int16_t* __restrict je2 = sc.je2.data();

    int32_t best = 0, best_r = 0, best_j = 0;
    for (int32_t r = 1; r <= m; r++) {
        const int16_t qc = (int16_t)q[r - 1];
        const int64_t l = lo_full[r];
        const int32_t dl = (int32_t)(l - lo_full[r - 1]);
        const int16_t* __restrict Hp = &H[(size_t)(r - 1) * band];
        const int16_t* __restrict Fp = &F[(size_t)(r - 1) * band];
        int16_t* __restrict Hr = &H[(size_t)r * band];
        int16_t* __restrict Er = &E[(size_t)r * band];
        int16_t* __restrict Fr = &F[(size_t)r * band];
        int16_t* __restrict Gr = &G[(size_t)r * band];

        // gather this row's target codes once (padding code 255 mismatches)
        for (int32_t j = 0; j < band; j++) {
            const int64_t col = l + j;
            twin[j] = (col < n) ? (int16_t)t[col] : (int16_t)255;
        }

        // G and F pass — branch-free over the interior, vectorizable
        const int32_t interior = std::max(0, band - dl);  // j where j+dl < band
        const int32_t dstart = (dl >= 1) ? 0 : 1;         // j where j+dl-1 >= 0
        // boundary cells handled scalar below
#ifdef _OPENMP
#pragma omp simd
#endif
        for (int32_t j = dstart; j < interior; j++) {
            const int32_t up = j + dl;
            const int16_t hup = Hp[up];
            const int16_t fup = Fp[up];
            int16_t f = (int16_t)(std::max<int16_t>((int16_t)(hup - GAP_OPEN), fup) - GAP_EXT);
            f = std::max<int16_t>(f, (int16_t)NEG);
            const int16_t hdiag = Hp[up - 1];
            const int16_t tc = twin[j];
            const int16_t s = (tc == qc && qc < 4) ? (int16_t)MATCH : (int16_t)MISMATCH;
            int16_t g = std::max<int16_t>(std::max<int16_t>(0, (int16_t)(hdiag + s)), f);
            Fr[j] = f;
            Gr[j] = g;
        }
        // left boundary (dl == 0, j == 0): diagonal is the free zero column
        if (dstart == 1) {
            const int32_t up = dl;  // == 0
            const int32_t hup = Hp[up], fup = Fp[up];
            int32_t f = std::max(hup - GAP_OPEN, fup) - GAP_EXT;
            if (f < NEG) f = NEG;
            const int32_t hdiag = (l == 0) ? 0 : NEG;
            const int16_t tc = twin[0];
            const int32_t s = (tc == qc && qc < 4) ? MATCH : MISMATCH;
            Fr[0] = (int16_t)f;
            Gr[0] = (int16_t)std::max(std::max(0, hdiag + s), f);
        }
        // right tail (j + dl >= band): previous row out of band
        for (int32_t j = interior; j < band; j++) {
            const int32_t hdiag = (j + dl - 1 < band) ? Hp[j + dl - 1] : NEG;
            const int16_t tc = twin[j];
            const int32_t s = (tc == qc && qc < 4) ? MATCH : MISMATCH;
            int32_t f = NEG;
            Fr[j] = (int16_t)f;
            Gr[j] = (int16_t)std::max(std::max(0, hdiag + s), f);
        }

        // E as an exclusive prefix max of A[j] = G[j] + ext*j (pre-override
        // G, matching the NumPy oracle), computed with log-step shifted-max
        // passes so the whole row stays SIMD.
#ifdef _OPENMP
#pragma omp simd
#endif
        for (int32_t j = 0; j < band; j++) A[j] = (int16_t)(Gr[j] + je2[j]);
        P[0] = (int16_t)NEG;
        for (int32_t j = 1; j < band; j++) P[j] = A[j - 1];
        for (int32_t s = 1; s < band; s <<= 1) {
#ifdef _OPENMP
#pragma omp simd
#endif
            for (int32_t j = s; j < band; j++)
                T[j] = std::max(P[j], P[j - s]);
            for (int32_t j = 0; j < s; j++) T[j] = P[j];
            std::swap(P, T);
        }
        // e/h pass: valid columns are j < n - l (lo is clipped, so this is
        // the only place the target end can cut into the band)
        const int32_t jmax =
            (int32_t)std::min<int64_t>(band, std::max<int64_t>(n - l, 0));
#ifdef _OPENMP
#pragma omp simd
#endif
        for (int32_t j = 0; j < band; j++) {
            int16_t e = (int16_t)(P[j] - GAP_OPEN - je2[j]);
            e = std::max<int16_t>(e, (int16_t)NEG);
            const int16_t g = Gr[j];
            int16_t h = std::max<int16_t>(g, e);
            const bool valid = j < jmax;
            Er[j] = e;
            Hr[j] = valid ? h : (int16_t)NEG;
            Gr[j] = valid ? g : (int16_t)NEG;
        }
        int16_t row_best = NEG;
#ifdef _OPENMP
#pragma omp simd reduction(max : row_best)
#endif
        for (int32_t j = 0; j < band; j++)
            row_best = std::max(row_best, Hr[j]);
        if (row_best > best) {
            int32_t row_best_j = 0;
            while (Hr[row_best_j] != row_best) row_best_j++;
            best = row_best;
            best_r = r;
            best_j = row_best_j;
        }
    }

    res->score = best;
    if (best <= 0) return;

    // traceback (same preference order as the Python _traceback)
    std::vector<uint8_t>& ops = sc.ops;  // end -> start
    ops.clear();
    ops.reserve(m + 256);
    int32_t r = best_r, j = best_j;
    int state = 0;  // 0=H 1=G 2=E 3=F
    while (r > 0 && j >= 0 && j < band) {
        const int64_t l = lo_full[r];
        const int32_t dl = (int32_t)(l - lo_full[r - 1]);
        const int16_t* Hrow = &H[(size_t)r * band];
        const int16_t* Erow = &E[(size_t)r * band];
        const int16_t* Frow = &F[(size_t)r * band];
        const int16_t* Grow = &G[(size_t)r * band];
        if (state == 0) {
            state = (Hrow[j] == Grow[j]) ? 1 : 2;
            continue;
        }
        if (state == 1) {
            const int32_t g = Grow[j];
            if (g == 0) break;
            if (g == Frow[j]) { state = 3; continue; }
            ops.push_back(0);
            r -= 1;
            j = j + dl - 1;
            state = 0;
            if (j < 0) break;
            continue;
        }
        if (state == 2) {
            ops.push_back(2);
            if (j - 1 >= 0 && Erow[j] == Grow[j - 1] - GAP_OPEN - GAP_EXT) state = 1;
            j -= 1;
            continue;
        }
        // state == 3 (F)
        ops.push_back(1);
        {
            const int32_t up = j + dl;
            const int16_t* Hprev = &H[(size_t)(r - 1) * band];
            if (up < band && Frow[j] == Hprev[up] - GAP_OPEN - GAP_EXT) state = 0;
            r -= 1;
            j = up;
            if (j >= band) break;
        }
    }

    int32_t q_len = 0, t_len = 0;
    for (uint8_t o : ops) {
        if (o != 2) q_len++;
        if (o != 1) t_len++;
    }
    const int32_t q_end = best_r;
    const int64_t t_end = lo_full[best_r] + best_j + 1;
    const int32_t q_start = q_end - q_len;
    const int64_t t_start = t_end - t_len;
    res->q0 = q_start;
    res->q1 = q_end;
    res->t0 = (int32_t)t_start;
    res->t1 = (int32_t)t_end;

    // run-length encode from start to end; compute NM
    int32_t nm = 0;
    int32_t clen = 0;
    int64_t qp = q_start, tp = t_start;
    for (int64_t i = (int64_t)ops.size() - 1; i >= 0;) {
        const uint8_t op = ops[i];
        int64_t jend = i;
        while (jend >= 0 && ops[jend] == op) jend--;
        const int32_t len = (int32_t)(i - jend);
        if (op == 0) {
            for (int32_t x = 0; x < len; x++) {
                const uint8_t qb = q[qp + x], tb = t[tp + x];
                if (qb != tb || (qb == 4 && tb == 4)) nm++;
            }
            qp += len;
            tp += len;
        } else if (op == 1) {
            nm += len;
            qp += len;
        } else {
            nm += len;
            tp += len;
        }
        if (clen < max_cigar) cigar_out[clen] = ((uint32_t)len << 4) | op;
        else res->overflow = 1;
        clen++;
        i = jend;
    }
    res->nm = nm;
    res->cigar_len = std::min(clen, max_cigar);
}

}  // namespace

extern "C" {

// q: concatenated query codes; q_off/q_len per pair.  t likewise.
// lo: concatenated (len = q_len+1 per pair) band lower bounds.
// out_meta: (B, 8) int32; out_cigar: (B, max_cigar) uint32.
void sw_banded_batch(
    const uint8_t* q, const int64_t* q_off, const int32_t* q_len,
    const uint8_t* t, const int64_t* t_off, const int32_t* t_len,
    const int32_t* lo, const int64_t* lo_off,
    int32_t n_pairs, int32_t band,
    int32_t* out_meta, uint32_t* out_cigar, int32_t max_cigar,
    int32_t n_threads) {
#ifdef _OPENMP
    const int nt_ = (n_threads > 0) ? n_threads
                    : (n_pairs > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel num_threads(nt_)
#endif
    {
        Scratch sc;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int32_t i = 0; i < n_pairs; i++) {
            Result res{};
            align_one(q + q_off[i], q_len[i], t + t_off[i], t_len[i],
                      lo + lo_off[i], band, &res,
                      out_cigar + (size_t)i * max_cigar, max_cigar, sc);
            int32_t* m = out_meta + (size_t)i * 8;
            m[0] = res.score; m[1] = res.q0; m[2] = res.q1;
            m[3] = res.t0; m[4] = res.t1; m[5] = res.nm;
            m[6] = res.cigar_len; m[7] = res.overflow;
        }
    }
}

}  // extern "C"

// ── NM-only forward kernel, inter-pair SIMD ─────────────────────────────────
//
// Port of the JAX package's ops/align_jax.py::sw_forward_meta (same tie-breaking,
// proven equal to the traceback backends): banded forward DP carrying
// (nm, q_start, t_start) metadata along winning paths, so no matrices are
// stored and no traceback runs.  SIMD lanes = PAIRS (PBLK int16 lanes;
// 32 = one AVX-512BW vector, measured ~7% over 16 on such hosts); the
// band loop is scalar but every op inside is vertical across the block.
// Band advances of 0/1 are lane blends; rare larger jumps pre-shift the
// lane's previous-row planes, so raw planner bands are handled exactly.
namespace {

constexpr int PBLK = 32;

// branchless select on an all-ones/zeros int16 mask
#define SEL16(m, a, b) ((int16_t)((b) ^ (((a) ^ (b)) & (m))))

struct NmScratch {
    // planes [band+1][PBLK] (one slot of padding so up() at j = band-1 can
    // read a fill slot instead of branching)
    std::vector<int16_t> H, F, nmh, qsh, tsh, nmf, qsf, tsf;
    std::vector<int16_t> tc;
};

// Fused F/G + E-prefix row pass (vertical across lanes).  G and its
// metadata live in registers between the two halves — the Gr plane is never
// materialized.  The E prefix (run_*) is sequential in j, so the loop keeps
// ascending-j order; every int16 op of the original two-pass form is
// preserved, so results stay bit-identical.
//
// The pass updates the planes IN PLACE: row j's new values overwrite the
// previous row's at j after all reads of them.  Old j+1 values are still
// untouched when iteration j runs, and the j-1 values a later iteration
// needs (the diagonal) are carried in two rotating row snapshots (scalar)
// or the rolling registers (AVX-512).  This halves the plane count vs the
// old double-buffered form — the whole working set now fits L1d — with
// every int16 op unchanged.
template <bool COORDS>
inline void fused_row_pass_scalar(
    NmScratch& sc, const int16_t* qc, const int16_t* dl,
    const int16_t* lrow16, const int16_t* tlen16, int32_t r, int32_t band,
    int16_t* bv, int16_t* bqs, int16_t* bts,
    int16_t* bqe, int16_t* bte, int16_t* bnm) {
    const int stride = PBLK;
    int16_t* Hb = sc.H.data();
    int16_t* Fb = sc.F.data();
    int16_t* nmhb = sc.nmh.data();
    int16_t* nmfb = sc.nmf.data();
    int16_t* qshb = sc.qsh.data();
    int16_t* tshb = sc.tsh.data();
    int16_t* qsfb = sc.qsf.data();
    int16_t* tsfb = sc.tsf.data();
    const int16_t* tcb = sc.tc.data();
    int16_t run_v[PBLK], run_nm[PBLK], run_qs[PBLK], run_ts[PBLK];
    // rotating snapshots of the previous row's old values at j and j-1
    // (only the planes the diagonal reads: H, nmh, and the start coords)
    int16_t snapH[2][PBLK], snapNMH[2][PBLK];
    int16_t snapQS[2][PBLK], snapTS[2][PBLK];
    for (int p = 0; p < PBLK; p++) {
        run_v[p] = NEG; run_nm[p] = 0; run_qs[p] = 0; run_ts[p] = 0;
    }
    int cur = 0;
    for (int32_t j = 0; j < band; j++) {
        const size_t o0 = (size_t)j * stride;
        const size_t o1 = o0 + stride;
        const int16_t mjpos = (int16_t)-(int16_t)(j > 0);
        // old row-j values, taken before the in-place store below
        for (int p = 0; p < PBLK; p++) {
            snapH[cur][p] = Hb[o0 + p];
            snapNMH[cur][p] = nmhb[o0 + p];
        }
        if constexpr (COORDS) {
            for (int p = 0; p < PBLK; p++) {
                snapQS[cur][p] = qshb[o0 + p];
                snapTS[cur][p] = tshb[o0 + p];
            }
        }
        const int16_t* Hj = snapH[cur];
        const int16_t* NMHj = snapNMH[cur];
        const int16_t* Hm = (j > 0) ? snapH[cur ^ 1] : snapH[cur];
        const int16_t* NMHm = (j > 0) ? snapNMH[cur ^ 1] : snapNMH[cur];
        const int16_t* QSj = snapQS[cur];
        const int16_t* TSj = snapTS[cur];
        const int16_t* QSm = (j > 0) ? snapQS[cur ^ 1] : snapQS[cur];
        const int16_t* TSm = (j > 0) ? snapTS[cur ^ 1] : snapTS[cur];
#ifdef _OPENMP
#pragma omp simd
#endif
        for (int p = 0; p < PBLK; p++) {
            // all-int16 mask arithmetic: sel(m,a,b) = b ^ ((a^b)&m)
            const int16_t md1 = (int16_t)-(int16_t)(dl[p] == 1);
            const int16_t col = (int16_t)(lrow16[p] + j);
            const int16_t Hup = SEL16(md1, Hb[o1 + p], Hj[p]);
            const int16_t Fup = SEL16(md1, Fb[o1 + p], Fb[o0 + p]);
            const int16_t nmh_up = SEL16(md1, nmhb[o1 + p], NMHj[p]);
            const int16_t nmf_up = SEL16(md1, nmfb[o1 + p], nmfb[o0 + p]);
            // diag = previous row, column j + dl - 1; at j = 0 with
            // dl = 0, the free zero boundary applies only at col 0
            const int16_t mdiag = (int16_t)(md1 | mjpos);
            const int16_t medge = (int16_t)(~mdiag & (int16_t)-(int16_t)(col == 0));
            const int16_t Hd0 = SEL16(md1, Hj[p], Hm[p]);
            const int16_t nmd0 = SEL16(md1, NMHj[p], NMHm[p]);
            const int16_t Hdiag = SEL16(mdiag, Hd0, (int16_t)(~medge & (int16_t)NEG));
            const int16_t nmd = (int16_t)(mdiag & nmd0);
            const int16_t tcv = tcb[o0 + p];
            const int16_t mmatch = (int16_t)-(int16_t)((tcv == qc[p]) & (qc[p] < 4) & (tcv < 4));
            const int16_t s = SEL16(mmatch, (int16_t)MATCH, (int16_t)MISMATCH);
            // F: prefer H-origin on ties
            const int16_t hgo = (int16_t)(Hup - GAP_OPEN);
            const int16_t mfh = (int16_t)-(int16_t)(hgo >= Fup);
            int16_t f = (int16_t)(std::max<int16_t>(hgo, Fup) - GAP_EXT);
            f = std::max<int16_t>(f, (int16_t)NEG);
            const int16_t nmf_n = (int16_t)(SEL16(mfh, nmh_up, nmf_up) + 1);
            // G: priority zero > F > diag
            const int16_t gd = (int16_t)(Hdiag + s);
            const int16_t g = std::max<int16_t>(std::max<int16_t>(0, gd), f);
            const int16_t mgz = (int16_t)-(int16_t)(g == 0);
            const int16_t mgf = (int16_t)(~mgz & (int16_t)-(int16_t)(g == f));
            const int16_t nmdm = (int16_t)(nmd + (int16_t)(~mmatch & 1));
            const int16_t nmg_v = (int16_t)(~mgz & SEL16(mgf, nmf_n, nmdm));
            // E prefix + H + best (same-row consumption of g/nmg_v)
            int16_t e = (int16_t)(run_v[p] - GAP_OPEN - GAP_EXT * j);
            e = std::max<int16_t>(e, (int16_t)NEG);
            e = SEL16(mjpos, e, (int16_t)NEG);
            const int16_t nme = (int16_t)(mjpos & (int16_t)(run_nm[p] + j));
            const int16_t mg = (int16_t)-(int16_t)(g >= e);
            const int16_t mvalid = (int16_t)-(int16_t)(col < tlen16[p]);
            const int16_t h0 = SEL16(mg, g, e);
            const int16_t h = SEL16(mvalid, h0, (int16_t)NEG);
            const int16_t nmh_n = SEL16(mg, nmg_v, nme);
            // in-place stores: all reads of the old row-j values are done
            Fb[o0 + p] = f;
            nmfb[o0 + p] = nmf_n;
            Hb[o0 + p] = h;
            nmhb[o0 + p] = nmh_n;
            // prefix update with A = G + ext*j, ties -> larger j
            const int16_t cand = (int16_t)(g + GAP_EXT * j);
            const int16_t mtake = (int16_t)-(int16_t)(cand >= run_v[p]);
            run_v[p] = SEL16(mtake, cand, run_v[p]);
            run_nm[p] = SEL16(mtake, (int16_t)(nmg_v - j), run_nm[p]);
            // per-lane best (strict >: earliest row, lowest j wins)
            const int16_t mb = (int16_t)-(int16_t)(h > bv[p]);
            bv[p] = SEL16(mb, h, bv[p]);
            bqe[p] = SEL16(mb, (int16_t)r, bqe[p]);
            bte[p] = SEL16(mb, (int16_t)(col + 1), bte[p]);
            bnm[p] = SEL16(mb, nmh_n, bnm[p]);
            if constexpr (COORDS) {
                const int16_t qsh_up = SEL16(md1, qshb[o1 + p], QSj[p]);
                const int16_t tsh_up = SEL16(md1, tshb[o1 + p], TSj[p]);
                const int16_t qsf_up = SEL16(md1, qsfb[o1 + p], qsfb[o0 + p]);
                const int16_t tsf_up = SEL16(md1, tsfb[o1 + p], tsfb[o0 + p]);
                const int16_t qsd0 = SEL16(md1, QSj[p], QSm[p]);
                const int16_t tsd0 = SEL16(md1, TSj[p], TSm[p]);
                const int16_t qsd = SEL16(mdiag, qsd0, (int16_t)(medge & (int16_t)(r - 1)));
                const int16_t tsd = SEL16(mdiag, tsd0, (int16_t)(medge & col));
                const int16_t qsf_n = SEL16(mfh, qsh_up, qsf_up);
                const int16_t tsf_n = SEL16(mfh, tsh_up, tsf_up);
                const int16_t qsg_v = SEL16(mgz, (int16_t)r, SEL16(mgf, qsf_n, qsd));
                const int16_t tsg_v = SEL16(mgz, (int16_t)(col + 1), SEL16(mgf, tsf_n, tsd));
                const int16_t qse = (int16_t)(mjpos & run_qs[p]);
                const int16_t tse = (int16_t)(mjpos & run_ts[p]);
                const int16_t qsh_n = SEL16(mg, qsg_v, qse);
                const int16_t tsh_n = SEL16(mg, tsg_v, tse);
                qsfb[o0 + p] = qsf_n;
                tsfb[o0 + p] = tsf_n;
                qshb[o0 + p] = qsh_n;
                tshb[o0 + p] = tsh_n;
                run_qs[p] = SEL16(mtake, qsg_v, run_qs[p]);
                run_ts[p] = SEL16(mtake, tsg_v, run_ts[p]);
                bqs[p] = SEL16(mb, qsh_n, bqs[p]);
                bts[p] = SEL16(mb, tsh_n, bts[p]);
            }
        }
        cur ^= 1;
    }
}

#if defined(__AVX512BW__)
// AVX-512BW specialization of the fused row pass.  One zmm register holds
// all PBLK = 32 int16 lanes, masks live in k-registers (vpcmpw + vpblendmw
// instead of materialized -1/0 int16 masks), and the j/j±1 plane rows roll
// through registers so each plane is loaded once per iteration.  Every
// operation maps 1:1 onto the scalar form above (same int16 wrapping
// arithmetic, same select semantics), so results are bit-identical; the
// scalar form remains the portable fallback and the readable reference.
static_assert(PBLK == 32, "one zmm of int16 lanes");

template <bool COORDS>
inline void fused_row_pass_avx512(
    NmScratch& sc, const int16_t* qc, const int16_t* dl,
    const int16_t* lrow16, const int16_t* tlen16, int32_t r, int32_t band,
    int16_t* bv, int16_t* bqs, int16_t* bts,
    int16_t* bqe, int16_t* bte, int16_t* bnm) {
    const int stride = PBLK;
    // planes are updated IN PLACE: every old value a later iteration needs
    // (j-1 / j / j+1) is already carried in the rolling registers below
    int16_t* Hb = sc.H.data();
    int16_t* Fb = sc.F.data();
    int16_t* nmhb = sc.nmh.data();
    int16_t* nmfb = sc.nmf.data();
    int16_t* qshb = sc.qsh.data();
    int16_t* tshb = sc.tsh.data();
    int16_t* qsfb = sc.qsf.data();
    int16_t* tsfb = sc.tsf.data();
    const int16_t* tcb = sc.tc.data();

    auto LDU = [stride](const int16_t* p, int32_t j) {
        return _mm512_loadu_si512((const void*)(p + (size_t)j * stride));
    };
    auto STU = [stride](int16_t* p, int32_t j, __m512i v) {
        _mm512_storeu_si512((void*)(p + (size_t)j * stride), v);
    };

    const __m512i vneg = _mm512_set1_epi16((short)NEG);
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vone = _mm512_set1_epi16(1);
    const __m512i vfour = _mm512_set1_epi16(4);
    const __m512i vmatch = _mm512_set1_epi16((short)MATCH);
    const __m512i vmism = _mm512_set1_epi16((short)MISMATCH);
    const __m512i vgo = _mm512_set1_epi16((short)GAP_OPEN);
    const __m512i vge = _mm512_set1_epi16((short)GAP_EXT);
    const __m512i vr = _mm512_set1_epi16((short)r);
    const __m512i vrm1 = _mm512_set1_epi16((short)(r - 1));
    const __m512i vqc = _mm512_loadu_si512((const void*)qc);
    const __m512i vdl = _mm512_loadu_si512((const void*)dl);
    const __m512i vtlen = _mm512_loadu_si512((const void*)tlen16);
    const __mmask32 kd1 = _mm512_cmpeq_epi16_mask(vdl, vone);

    __m512i vrunv = vneg, vrunnm = vzero, vrunqs = vzero, vrunts = vzero;
    __m512i vbv = _mm512_loadu_si512((const void*)bv);
    __m512i vbqe = _mm512_loadu_si512((const void*)bqe);
    __m512i vbte = _mm512_loadu_si512((const void*)bte);
    __m512i vbnm = _mm512_loadu_si512((const void*)bnm);
    __m512i vbqs = vzero, vbts = vzero;
    if constexpr (COORDS) {
        vbqs = _mm512_loadu_si512((const void*)bqs);
        vbts = _mm512_loadu_si512((const void*)bts);
    }

    // rolling plane rows: P = j-1, C = j, N = j+1
    __m512i hC = LDU(Hb, 0), hN = LDU(Hb, 1), hP = hC;
    __m512i fC = LDU(Fb, 0), fN = LDU(Fb, 1);
    __m512i nhC = LDU(nmhb, 0), nhN = LDU(nmhb, 1), nhP = nhC;
    __m512i nfC = LDU(nmfb, 0), nfN = LDU(nmfb, 1);
    __m512i qshC = vzero, qshN = vzero, qshP = vzero;
    __m512i tshC = vzero, tshN = vzero, tshP = vzero;
    __m512i qsfC = vzero, qsfN = vzero, tsfC = vzero, tsfN = vzero;
    if constexpr (COORDS) {
        qshC = LDU(qshb, 0); qshN = LDU(qshb, 1); qshP = qshC;
        tshC = LDU(tshb, 0); tshN = LDU(tshb, 1); tshP = tshC;
        qsfC = LDU(qsfb, 0); qsfN = LDU(qsfb, 1);
        tsfC = LDU(tsfb, 0); tsfN = LDU(tsfb, 1);
    }
    __m512i vcol = _mm512_loadu_si512((const void*)lrow16);  // lrow + j
    __m512i vextj = vzero;                                   // GAP_EXT * j
    __m512i vnmj = vzero;                                    // j

    for (int32_t j = 0; j < band; j++) {
        if (j > 0) {
            hP = hC; hC = hN; hN = LDU(Hb, j + 1);
            nhP = nhC; nhC = nhN; nhN = LDU(nmhb, j + 1);
            fC = fN; fN = LDU(Fb, j + 1);
            nfC = nfN; nfN = LDU(nmfb, j + 1);
            if constexpr (COORDS) {
                qshP = qshC; qshC = qshN; qshN = LDU(qshb, j + 1);
                tshP = tshC; tshC = tshN; tshN = LDU(tshb, j + 1);
                qsfC = qsfN; qsfN = LDU(qsfb, j + 1);
                tsfC = tsfN; tsfN = LDU(tsfb, j + 1);
            }
            vcol = _mm512_add_epi16(vcol, vone);
            vextj = _mm512_add_epi16(vextj, vge);
            vnmj = _mm512_add_epi16(vnmj, vone);
        }
        const __m512i vHup = _mm512_mask_blend_epi16(kd1, hC, hN);
        const __m512i vFup = _mm512_mask_blend_epi16(kd1, fC, fN);
        const __m512i vnmhu = _mm512_mask_blend_epi16(kd1, nhC, nhN);
        const __m512i vnmfu = _mm512_mask_blend_epi16(kd1, nfC, nfN);
        const __m512i vHd0 = _mm512_mask_blend_epi16(kd1, hP, hC);
        const __m512i vnmd0 = _mm512_mask_blend_epi16(kd1, nhP, nhC);
        __m512i vHdiag, vnmd;
        __mmask32 kedge = 0;
        if (j > 0) {  // mdiag = all-ones: diag reads go straight through
            vHdiag = vHd0;
            vnmd = vnmd0;
        } else {  // mdiag = kd1; medge = ~kd1 & (col == 0)
            const __mmask32 kcol0 = _mm512_cmpeq_epi16_mask(vcol, vzero);
            kedge = _kandn_mask32(kd1, kcol0);
            vHdiag = _mm512_mask_blend_epi16(
                kd1, _mm512_maskz_mov_epi16(_knot_mask32(kedge), vneg), vHd0);
            vnmd = _mm512_maskz_mov_epi16(kd1, vnmd0);
        }
        const __m512i vtc = LDU(tcb, j);
        const __mmask32 kmm = _kand_mask32(
            _mm512_cmpeq_epi16_mask(vtc, vqc),
            _kand_mask32(_mm512_cmplt_epi16_mask(vqc, vfour),
                         _mm512_cmplt_epi16_mask(vtc, vfour)));
        const __m512i vs = _mm512_mask_blend_epi16(kmm, vmism, vmatch);
        const __m512i vhgo = _mm512_sub_epi16(vHup, vgo);
        const __mmask32 kfh =
            _mm512_cmp_epi16_mask(vFup, vhgo, _MM_CMPINT_LE);  // hgo >= Fup
        __m512i vf = _mm512_sub_epi16(_mm512_max_epi16(vhgo, vFup), vge);
        vf = _mm512_max_epi16(vf, vneg);
        const __m512i vnmfn =
            _mm512_add_epi16(_mm512_mask_blend_epi16(kfh, vnmfu, vnmhu), vone);
        const __m512i vgd = _mm512_add_epi16(vHdiag, vs);
        const __m512i vg = _mm512_max_epi16(_mm512_max_epi16(vzero, vgd), vf);
        const __mmask32 kgz = _mm512_cmpeq_epi16_mask(vg, vzero);
        const __mmask32 kgf =
            _kandn_mask32(kgz, _mm512_cmpeq_epi16_mask(vg, vf));
        const __m512i vnmdm = _mm512_add_epi16(
            vnmd, _mm512_maskz_mov_epi16(_knot_mask32(kmm), vone));
        const __m512i vnmg = _mm512_maskz_mov_epi16(
            _knot_mask32(kgz), _mm512_mask_blend_epi16(kgf, vnmdm, vnmfn));
        STU(Fb, j, vf);
        STU(nmfb, j, vnmfn);
        // E prefix + H + best
        __m512i ve, vnme;
        if (j > 0) {
            ve = _mm512_sub_epi16(vrunv, _mm512_add_epi16(vgo, vextj));
            ve = _mm512_max_epi16(ve, vneg);
            vnme = _mm512_add_epi16(vrunnm, vnmj);
        } else {
            ve = vneg;
            vnme = vzero;
        }
        const __mmask32 kg =
            _mm512_cmp_epi16_mask(ve, vg, _MM_CMPINT_LE);  // g >= e
        const __mmask32 kvalid = _mm512_cmplt_epi16_mask(vcol, vtlen);
        const __m512i vh0 = _mm512_mask_blend_epi16(kg, ve, vg);
        const __m512i vh = _mm512_mask_blend_epi16(kvalid, vneg, vh0);
        const __m512i vnmhn = _mm512_mask_blend_epi16(kg, vnme, vnmg);
        STU(Hb, j, vh);
        STU(nmhb, j, vnmhn);
        const __m512i vcand = _mm512_add_epi16(vg, vextj);
        const __mmask32 ktake =
            _mm512_cmp_epi16_mask(vrunv, vcand, _MM_CMPINT_LE);  // cand >= run_v
        vrunv = _mm512_mask_blend_epi16(ktake, vrunv, vcand);
        vrunnm = _mm512_mask_blend_epi16(ktake, vrunnm,
                                         _mm512_sub_epi16(vnmg, vnmj));
        const __mmask32 kb = _mm512_cmpgt_epi16_mask(vh, vbv);
        vbv = _mm512_mask_blend_epi16(kb, vbv, vh);
        vbqe = _mm512_mask_blend_epi16(kb, vbqe, vr);
        vbte = _mm512_mask_blend_epi16(kb, vbte, _mm512_add_epi16(vcol, vone));
        vbnm = _mm512_mask_blend_epi16(kb, vbnm, vnmhn);
        if constexpr (COORDS) {
            const __m512i vqshu = _mm512_mask_blend_epi16(kd1, qshC, qshN);
            const __m512i vtshu = _mm512_mask_blend_epi16(kd1, tshC, tshN);
            const __m512i vqsfu = _mm512_mask_blend_epi16(kd1, qsfC, qsfN);
            const __m512i vtsfu = _mm512_mask_blend_epi16(kd1, tsfC, tsfN);
            const __m512i vqsd0 = _mm512_mask_blend_epi16(kd1, qshP, qshC);
            const __m512i vtsd0 = _mm512_mask_blend_epi16(kd1, tshP, tshC);
            __m512i vqsd, vtsd;
            if (j > 0) {
                vqsd = vqsd0;
                vtsd = vtsd0;
            } else {
                vqsd = _mm512_mask_blend_epi16(
                    kd1, _mm512_maskz_mov_epi16(kedge, vrm1), vqsd0);
                vtsd = _mm512_mask_blend_epi16(
                    kd1, _mm512_maskz_mov_epi16(kedge, vcol), vtsd0);
            }
            const __m512i vqsfn = _mm512_mask_blend_epi16(kfh, vqsfu, vqshu);
            const __m512i vtsfn = _mm512_mask_blend_epi16(kfh, vtsfu, vtshu);
            const __m512i vqsg = _mm512_mask_blend_epi16(
                kgz, _mm512_mask_blend_epi16(kgf, vqsd, vqsfn), vr);
            const __m512i vtsg = _mm512_mask_blend_epi16(
                kgz, _mm512_mask_blend_epi16(kgf, vtsd, vtsfn),
                _mm512_add_epi16(vcol, vone));
            STU(qsfb, j, vqsfn);
            STU(tsfb, j, vtsfn);
            const __m512i vqse = (j > 0) ? vrunqs : vzero;
            const __m512i vtse = (j > 0) ? vrunts : vzero;
            const __m512i vqshn = _mm512_mask_blend_epi16(kg, vqse, vqsg);
            const __m512i vtshn = _mm512_mask_blend_epi16(kg, vtse, vtsg);
            STU(qshb, j, vqshn);
            STU(tshb, j, vtshn);
            vrunqs = _mm512_mask_blend_epi16(ktake, vrunqs, vqsg);
            vrunts = _mm512_mask_blend_epi16(ktake, vrunts, vtsg);
            vbqs = _mm512_mask_blend_epi16(kb, vbqs, vqshn);
            vbts = _mm512_mask_blend_epi16(kb, vbts, vtshn);
        }
    }
    _mm512_storeu_si512((void*)bv, vbv);
    _mm512_storeu_si512((void*)bqe, vbqe);
    _mm512_storeu_si512((void*)bte, vbte);
    _mm512_storeu_si512((void*)bnm, vbnm);
    if constexpr (COORDS) {
        _mm512_storeu_si512((void*)bqs, vbqs);
        _mm512_storeu_si512((void*)bts, vbts);
    }
}
#endif  // __AVX512BW__

template <bool COORDS>
inline void fused_row_pass(
    NmScratch& sc, const int16_t* qc, const int16_t* dl,
    const int16_t* lrow16, const int16_t* tlen16, int32_t r, int32_t band,
    int16_t* bv, int16_t* bqs, int16_t* bts,
    int16_t* bqe, int16_t* bte, int16_t* bnm) {
#if defined(__AVX512BW__)
    fused_row_pass_avx512<COORDS>(sc, qc, dl, lrow16, tlen16, r, band,
                                  bv, bqs, bts, bqe, bte, bnm);
#else
    fused_row_pass_scalar<COORDS>(sc, qc, dl, lrow16, tlen16, r, band,
                                  bv, bqs, bts, bqe, bte, bnm);
#endif
}

// COORDS=false drops the (q_start, t_start) metadata planes entirely —
// score / q_end / t_end / nm are bit-identical to the COORDS=true variant
// (the start planes never feed back into them); out slots 1 and 3 are 0.
// NM-only consumers (stage-7 tie-break) use this ~1/3-lighter form.
template <bool COORDS>
inline void nm_block(
    const uint8_t* const* q, const int32_t* qlen,
    const uint8_t* const* t, const int32_t* tlen,
    const int32_t* const* lo_raw,  // planner lo, len qlen per pair
    int np, int band, int32_t* out /* (PBLK, 6) */, NmScratch& sc) {
    const int stride = PBLK;
    const size_t plane = (size_t)(band + 1) * stride;
    auto init_plane = [&](std::vector<int16_t>& v, int16_t val) {
        v.assign(plane, val);
    };
    init_plane(sc.H, 0);
    init_plane(sc.F, NEG);
    init_plane(sc.nmh, 0);
    init_plane(sc.nmf, 0);
    if (COORDS) {
        init_plane(sc.qsh, 0);
        init_plane(sc.tsh, 0);
        init_plane(sc.qsf, 0);
        init_plane(sc.tsf, 0);
    }
    sc.tc.resize(plane);

    int32_t m_max = 0;
    for (int p = 0; p < np; p++) m_max = std::max(m_max, qlen[p]);

    // per-lane running best (value, qs, ts, qe, te, nm)
    int16_t bv[PBLK], bqs[PBLK], bts[PBLK], bqe[PBLK], bte[PBLK], bnm[PBLK];
    for (int p = 0; p < PBLK; p++) {
        bv[p] = 0; bqs[p] = bts[p] = bqe[p] = bte[p] = bnm[p] = 0;
    }
    // fill slots at j = band stay at their init values (NEG / 0): the up()
    // access j+1 at j = band-1 lands there, matching shl1's fill.

    int16_t qc[PBLK], dl[PBLK], lrow16[PBLK], tlen16[PBLK];
    uint8_t regather[PBLK];
    int32_t lrow[PBLK];
    for (int p = 0; p < PBLK; p++) tlen16[p] = (int16_t)tlen[p < np ? p : 0];
    for (int32_t r = 1; r <= m_max; r++) {
        bool any_jump = false;
        for (int p = 0; p < np; p++) {
            const int32_t m = qlen[p];
            const int32_t ri = std::min(r, m);           // clamp into lo range
            const int32_t lr = (int32_t)lo_raw[p][ri - 1];
            const int32_t lprev = (r <= 1 || r > m)
                ? lr                                      // row 1: lo_full[0]
                : (int32_t)lo_raw[p][ri - 2];
            qc[p] = (r <= m) ? (int16_t)q[p][r - 1] : (int16_t)5;
            lrow[p] = lr;
            const int32_t d = lr - lprev;
            dl[p] = (int16_t)d;
            if (d > 1) any_jump = true;
            lrow16[p] = (int16_t)lr;
            regather[p] = 0;
        }
        // rare band jumps (large deletions): shift the lane's previous-row
        // planes left by d-1 (fills NEG / 0 like shl1) and regather its
        // target window, then the normal dl = 1 blend path applies — exact
        // raw-lo semantics without per-lane gathers in the hot loops
        if (any_jump) {
            int16_t* planes_neg[2] = { sc.H.data(), sc.F.data() };
            int16_t* planes_zero[6] = { sc.nmh.data(), sc.nmf.data(),
                                        COORDS ? sc.qsh.data() : nullptr,
                                        COORDS ? sc.tsh.data() : nullptr,
                                        COORDS ? sc.qsf.data() : nullptr,
                                        COORDS ? sc.tsf.data() : nullptr };
            const int nz = COORDS ? 6 : 2;
            for (int p = 0; p < np; p++) {
                const int32_t d = dl[p];
                if (d <= 1) continue;
                const int32_t sh = d - 1;
                for (int x = 0; x < 2; x++) {
                    int16_t* pl = planes_neg[x];
                    for (int32_t j = 0; j + sh < band + 1; j++)
                        pl[(size_t)j * PBLK + p] = pl[(size_t)(j + sh) * PBLK + p];
                    for (int32_t j = std::max(0, band + 1 - sh); j < band + 1; j++)
                        pl[(size_t)j * PBLK + p] = NEG;
                }
                for (int x = 0; x < nz; x++) {
                    int16_t* pl = planes_zero[x];
                    for (int32_t j = 0; j + sh < band + 1; j++)
                        pl[(size_t)j * PBLK + p] = pl[(size_t)(j + sh) * PBLK + p];
                    for (int32_t j = std::max(0, band + 1 - sh); j < band + 1; j++)
                        pl[(size_t)j * PBLK + p] = 0;
                }
                dl[p] = 1;
                regather[p] = 1;
            }
        }
        // target window: full gather on the first row, then an incremental
        // lane-blend shift (dl in {0,1}) plus one fresh load per advanced
        // lane — clamped tails stay clamped, so the shift recurrence holds
        if (r == 1) {
            for (int32_t j = 0; j < band; j++) {
                int16_t* tcj = &sc.tc[(size_t)j * stride];
                for (int p = 0; p < np; p++) {
                    int64_t col = lrow[p] + j;
                    if (col >= tlen[p]) col = tlen[p] - 1;
                    tcj[p] = (col >= 0) ? (int16_t)t[p][col] : (int16_t)255;
                }
            }
        } else {
            int16_t* __restrict tcb = sc.tc.data();
            int16_t md1v[PBLK];
            for (int p = 0; p < PBLK; p++)
                md1v[p] = (int16_t)-(int16_t)(dl[p] == 1 && !regather[p]);
            for (int32_t j = 0; j < band - 1; j++) {
                const size_t o0 = (size_t)j * stride;
                const size_t o1 = o0 + stride;
#ifdef _OPENMP
#pragma omp simd
#endif
                for (int p = 0; p < PBLK; p++)
                    tcb[o0 + p] = SEL16(md1v[p], tcb[o1 + p], tcb[o0 + p]);
            }
            int16_t* tclast = &sc.tc[(size_t)(band - 1) * stride];
            for (int p = 0; p < np; p++) {
                if (regather[p]) {
                    for (int32_t j = 0; j < band; j++) {
                        int64_t col = lrow[p] + j;
                        if (col >= tlen[p]) col = tlen[p] - 1;
                        sc.tc[(size_t)j * stride + p] = (int16_t)t[p][col];
                    }
                } else if (dl[p] == 1) {
                    int64_t col = lrow[p] + band - 1;
                    if (col >= tlen[p]) col = tlen[p] - 1;
                    tclast[p] = (int16_t)t[p][col];
                }
            }
        }

        // Fused F/G + E-prefix row pass; the Gr plane is never
        // materialized (G + metadata stay in registers between the two
        // halves).  Dispatches to the AVX-512BW specialization where
        // available, else the portable scalar form — both bit-identical.
        fused_row_pass<COORDS>(sc, qc, dl, lrow16, tlen16, r, band,
                               bv, bqs, bts, bqe, bte, bnm);
        // planes were updated in place; the fill slots at j = band are
        // never written, so they keep their init values (NEG / 0)
    }

    for (int p = 0; p < np; p++) {
        int32_t* o = out + (size_t)p * 6;
        o[0] = bv[p]; o[1] = COORDS ? bqs[p] : 0; o[2] = bqe[p];
        o[3] = COORDS ? bts[p] : 0; o[4] = bte[p]; o[5] = bnm[p];
    }
}

}  // namespace

extern "C" {

}  // extern "C"

// NM-only batch: q/t/lo concatenated like sw_banded_batch; lo is the raw
// planner band (len q_len per pair, arbitrary non-decreasing advances).
// out_meta: (B, 6) int32 = (score, q_start, q_end, t_start, t_end, nm).
// The COORDS=false variant skips the (q_start, t_start) metadata planes
// (slots 1/3 read 0); score, q_end, t_end, nm stay bit-identical — for
// NM-only consumers.
template <bool COORDS>
static void sw_nm_batch_impl(
    const uint8_t* q, const int64_t* q_off, const int32_t* q_len,
    const uint8_t* t, const int64_t* t_off, const int32_t* t_len,
    const int32_t* lo, const int64_t* lo_off,
    int32_t n_pairs, int32_t band,
    int32_t* out_meta, int32_t n_threads) {
    const int32_t n_blocks = (n_pairs + PBLK - 1) / PBLK;
#ifdef _OPENMP
    const int nt_ = (n_threads > 0) ? n_threads
                    : (n_blocks > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel num_threads(nt_)
#endif
    {
        NmScratch sc;
        const uint8_t* qp[PBLK];
        const uint8_t* tp[PBLK];
        const int32_t* lop[PBLK];
        int32_t ql[PBLK], tl[PBLK];
        int32_t blk_out[PBLK * 6];
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int32_t b = 0; b < n_blocks; b++) {
            const int32_t start = b * PBLK;
            const int np = std::min<int32_t>(PBLK, n_pairs - start);
            for (int i = 0; i < PBLK; i++) {
                const int32_t src = (i < np) ? start + i : start;  // clone row 0
                qp[i] = q + q_off[src];
                tp[i] = t + t_off[src];
                lop[i] = lo + lo_off[src];
                ql[i] = q_len[src];
                tl[i] = t_len[src];
            }
            nm_block<COORDS>(qp, ql, tp, tl, lop, PBLK, band, blk_out, sc);
            std::memcpy(out_meta + (size_t)start * 6, blk_out,
                        (size_t)np * 6 * sizeof(int32_t));
        }
    }
}

extern "C" {

void sw_nm_batch(
    const uint8_t* q, const int64_t* q_off, const int32_t* q_len,
    const uint8_t* t, const int64_t* t_off, const int32_t* t_len,
    const int32_t* lo, const int64_t* lo_off,
    int32_t n_pairs, int32_t band,
    int32_t* out_meta, int32_t n_threads) {
    sw_nm_batch_impl<true>(q, q_off, q_len, t, t_off, t_len, lo, lo_off,
                           n_pairs, band, out_meta, n_threads);
}

// no-coords variant (see above): stage-7 tie-break economics
void sw_nm_batch_nc(
    const uint8_t* q, const int64_t* q_off, const int32_t* q_len,
    const uint8_t* t, const int64_t* t_off, const int32_t* t_len,
    const int32_t* lo, const int64_t* lo_off,
    int32_t n_pairs, int32_t band,
    int32_t* out_meta, int32_t n_threads) {
    sw_nm_batch_impl<false>(q, q_off, q_len, t, t_off, t_len, lo, lo_off,
                            n_pairs, band, out_meta, n_threads);
}

}  // extern "C"

// ── Full traceback kernel, inter-pair SIMD ──────────────────────────────────
//
// Same lane-block forward as sw_nm_batch but without metadata planes;
// instead each cell stores one packed direction byte (the five comparisons
// the traceback makes on the H/E/F/G matrices), and a scalar per-pair walk
// reconstructs the CIGAR.  Bits are computed from the same post-override
// values the value-based traceback reads, so results are bit-identical to
// sw_banded_batch (tests assert it).
namespace {

constexpr uint8_t T_H_IS_G = 1;    // H == G
constexpr uint8_t T_G_ZERO = 2;    // G == 0
constexpr uint8_t T_G_IS_F = 4;    // G == F
constexpr uint8_t T_E_FROM_G = 8;  // E[j] == G[j-1] - o - e
constexpr uint8_t T_F_FROM_H = 16; // F[j] == Hprev[j+dl] - o - e

struct TbScratch {
    std::vector<int16_t> H, F, tc;          // planes [band+1][PBLK]
    std::vector<uint8_t> dirs;              // [m_max][band][PBLK]
    std::vector<uint8_t> ops;
};

// Fused F/G + E-prefix + direction-bit row pass for the traceback kernel.
// Same structure as the NM kernel's fused_row_pass: G stays in registers
// between the two halves (the Gr plane is gone), the E prefix keeps
// ascending-j order, and every int16 op matches the original two-pass form
// bit for bit.  The 32 per-lane direction bytes of each j row are packed
// and stored in one shot.
inline void fused_tb_row_pass_scalar(
    TbScratch& sc, const int16_t* qc, const int16_t* dl,
    const int16_t* lrow16, const int16_t* tlen16, int32_t r, int32_t band,
    uint8_t* drow_base, int16_t* bv, int16_t* bqe, int16_t* bj) {
    const int stride = PBLK;
    int16_t* Hb = sc.H.data();
    int16_t* Fb = sc.F.data();
    const int16_t* tcb = sc.tc.data();
    int16_t run_v[PBLK], gprev[PBLK];
    // rotating snapshots of the previous row's old H at j and j-1 (the
    // diagonal read); planes are updated in place like the NM kernel
    int16_t snapH[2][PBLK];
    for (int p = 0; p < PBLK; p++) { run_v[p] = NEG; gprev[p] = 0; }
    int cur = 0;
    for (int32_t j = 0; j < band; j++) {
        const size_t o0 = (size_t)j * stride;
        const size_t o1 = o0 + stride;
        const int16_t mjpos = (int16_t)-(int16_t)(j > 0);
        uint8_t* __restrict dj = drow_base + (size_t)j * stride;
        for (int p = 0; p < PBLK; p++) snapH[cur][p] = Hb[o0 + p];
        const int16_t* Hj = snapH[cur];
        const int16_t* Hm = (j > 0) ? snapH[cur ^ 1] : snapH[cur];
#ifdef _OPENMP
#pragma omp simd
#endif
        for (int p = 0; p < PBLK; p++) {
            const int16_t md1 = (int16_t)-(int16_t)(dl[p] == 1);
            const int16_t col = (int16_t)(lrow16[p] + j);
            const int16_t Hup = SEL16(md1, Hb[o1 + p], Hj[p]);
            const int16_t Fup = SEL16(md1, Fb[o1 + p], Fb[o0 + p]);
            const int16_t mdiag = (int16_t)(md1 | mjpos);
            const int16_t medge = (int16_t)(~mdiag & (int16_t)-(int16_t)(col == 0));
            const int16_t Hd0 = SEL16(md1, Hj[p], Hm[p]);
            const int16_t Hdiag = SEL16(mdiag, Hd0, (int16_t)(~medge & (int16_t)NEG));
            const int16_t tcv = tcb[o0 + p];
            const int16_t mmatch = (int16_t)-(int16_t)((tcv == qc[p]) & (qc[p] < 4) & (tcv < 4));
            const int16_t sv = SEL16(mmatch, (int16_t)MATCH, (int16_t)MISMATCH);
            const int16_t hgo = (int16_t)(Hup - GAP_OPEN);
            int16_t f = (int16_t)(std::max<int16_t>(hgo, Fup) - GAP_EXT);
            f = std::max<int16_t>(f, (int16_t)NEG);
            const int16_t gd = (int16_t)(Hdiag + sv);
            const int16_t g = std::max<int16_t>(std::max<int16_t>(0, gd), f);
            Fb[o0 + p] = f;
            uint8_t d = (uint8_t)(T_F_FROM_H &
                    (uint8_t)-(int8_t)(f == (int16_t)(Hup - GAP_OPEN - GAP_EXT)));
            // E prefix + H + remaining bits (same-row consumption of g)
            int16_t e = (int16_t)(run_v[p] - GAP_OPEN - GAP_EXT * j);
            e = std::max<int16_t>(e, (int16_t)NEG);
            e = SEL16(mjpos, e, (int16_t)NEG);
            const int16_t mvalid = (int16_t)-(int16_t)(col < tlen16[p]);
            const int16_t gpost = SEL16(mvalid, g, (int16_t)NEG);
            const int16_t h0 = std::max<int16_t>(g, e);
            const int16_t h = SEL16(mvalid, h0, (int16_t)NEG);
            Hb[o0 + p] = h;
            d |= (uint8_t)(T_H_IS_G & (uint8_t)-(int8_t)(h == gpost));
            d |= (uint8_t)(T_G_ZERO & (uint8_t)-(int8_t)(gpost == 0));
            d |= (uint8_t)(T_G_IS_F & (uint8_t)-(int8_t)(gpost == f));
            d |= (uint8_t)(T_E_FROM_G & (uint8_t)(mjpos &
                 (int16_t)-(int16_t)(e == (int16_t)(gprev[p] - GAP_OPEN - GAP_EXT))));
            dj[p] = d;
            // prefix update with PRE-override g (oracle convention)
            const int16_t cand = (int16_t)(g + GAP_EXT * j);
            const int16_t mtake = (int16_t)-(int16_t)(cand >= run_v[p]);
            run_v[p] = SEL16(mtake, cand, run_v[p]);
            gprev[p] = gpost;
            // per-lane best: strict > keeps earliest (row, j)
            const int16_t mb = (int16_t)-(int16_t)(h > bv[p]);
            bv[p] = SEL16(mb, h, bv[p]);
            bqe[p] = SEL16(mb, (int16_t)r, bqe[p]);
            bj[p] = SEL16(mb, (int16_t)j, bj[p]);
        }
        cur ^= 1;
    }
}

#if defined(__AVX512BW__)
// AVX-512BW specialization: one zmm of 32 int16 lanes, k-mask compares,
// rolling H/F plane rows, direction bytes built as u16 then narrowed with
// vpmovwb into one 32-byte store per j.  Op-for-op identical to the scalar
// form above, so results (and the stored dir bytes) are bit-identical.
inline void fused_tb_row_pass_avx512(
    TbScratch& sc, const int16_t* qc, const int16_t* dl,
    const int16_t* lrow16, const int16_t* tlen16, int32_t r, int32_t band,
    uint8_t* drow_base, int16_t* bv, int16_t* bqe, int16_t* bj) {
    const int stride = PBLK;
    // in-place plane updates; old j-1/j/j+1 values live in the rolling
    // registers below
    int16_t* Hb = sc.H.data();
    int16_t* Fb = sc.F.data();
    const int16_t* tcb = sc.tc.data();
    auto LDU = [stride](const int16_t* p, int32_t j) {
        return _mm512_loadu_si512((const void*)(p + (size_t)j * stride));
    };
    auto STU = [stride](int16_t* p, int32_t j, __m512i v) {
        _mm512_storeu_si512((void*)(p + (size_t)j * stride), v);
    };
    const __m512i vneg = _mm512_set1_epi16((short)NEG);
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vone = _mm512_set1_epi16(1);
    const __m512i vfour = _mm512_set1_epi16(4);
    const __m512i vmatch = _mm512_set1_epi16((short)MATCH);
    const __m512i vmism = _mm512_set1_epi16((short)MISMATCH);
    const __m512i vgo = _mm512_set1_epi16((short)GAP_OPEN);
    const __m512i vge = _mm512_set1_epi16((short)GAP_EXT);
    const __m512i vgoe = _mm512_add_epi16(vgo, vge);
    const __m512i vr = _mm512_set1_epi16((short)r);
    const __m512i vqc = _mm512_loadu_si512((const void*)qc);
    const __m512i vdl = _mm512_loadu_si512((const void*)dl);
    const __m512i vtlen = _mm512_loadu_si512((const void*)tlen16);
    const __mmask32 kd1 = _mm512_cmpeq_epi16_mask(vdl, vone);
    const __m512i vb_fh = _mm512_set1_epi16((short)T_F_FROM_H);
    const __m512i vb_hg = _mm512_set1_epi16((short)T_H_IS_G);
    const __m512i vb_gz = _mm512_set1_epi16((short)T_G_ZERO);
    const __m512i vb_gf = _mm512_set1_epi16((short)T_G_IS_F);
    const __m512i vb_eg = _mm512_set1_epi16((short)T_E_FROM_G);

    __m512i vrunv = vneg, vgprev = vzero;
    __m512i vbv = _mm512_loadu_si512((const void*)bv);
    __m512i vbqe = _mm512_loadu_si512((const void*)bqe);
    __m512i vbj = _mm512_loadu_si512((const void*)bj);

    __m512i hC = LDU(Hb, 0), hN = LDU(Hb, 1), hP = hC;
    __m512i fC = LDU(Fb, 0), fN = LDU(Fb, 1);
    __m512i vcol = _mm512_loadu_si512((const void*)lrow16);
    __m512i vextj = vzero;  // GAP_EXT * j
    __m512i vj = vzero;     // j

    for (int32_t j = 0; j < band; j++) {
        if (j > 0) {
            hP = hC; hC = hN; hN = LDU(Hb, j + 1);
            fC = fN; fN = LDU(Fb, j + 1);
            vcol = _mm512_add_epi16(vcol, vone);
            vextj = _mm512_add_epi16(vextj, vge);
            vj = _mm512_add_epi16(vj, vone);
        }
        const __m512i vHup = _mm512_mask_blend_epi16(kd1, hC, hN);
        const __m512i vFup = _mm512_mask_blend_epi16(kd1, fC, fN);
        const __m512i vHd0 = _mm512_mask_blend_epi16(kd1, hP, hC);
        __m512i vHdiag;
        if (j > 0) {
            vHdiag = vHd0;
        } else {
            const __mmask32 kcol0 = _mm512_cmpeq_epi16_mask(vcol, vzero);
            const __mmask32 kedge = _kandn_mask32(kd1, kcol0);
            vHdiag = _mm512_mask_blend_epi16(
                kd1, _mm512_maskz_mov_epi16(_knot_mask32(kedge), vneg), vHd0);
        }
        const __m512i vtc = LDU(tcb, j);
        const __mmask32 kmm = _kand_mask32(
            _mm512_cmpeq_epi16_mask(vtc, vqc),
            _kand_mask32(_mm512_cmplt_epi16_mask(vqc, vfour),
                         _mm512_cmplt_epi16_mask(vtc, vfour)));
        const __m512i vs = _mm512_mask_blend_epi16(kmm, vmism, vmatch);
        const __m512i vhgo = _mm512_sub_epi16(vHup, vgo);
        __m512i vf = _mm512_sub_epi16(_mm512_max_epi16(vhgo, vFup), vge);
        vf = _mm512_max_epi16(vf, vneg);
        const __m512i vgd = _mm512_add_epi16(vHdiag, vs);
        const __m512i vg = _mm512_max_epi16(_mm512_max_epi16(vzero, vgd), vf);
        STU(Fb, j, vf);
        const __mmask32 kffh =
            _mm512_cmpeq_epi16_mask(vf, _mm512_sub_epi16(vHup, vgoe));
        __m512i vd = _mm512_maskz_mov_epi16(kffh, vb_fh);
        // E prefix + H + remaining bits
        __m512i ve;
        __mmask32 keg = 0;
        if (j > 0) {
            ve = _mm512_sub_epi16(vrunv, _mm512_add_epi16(vgo, vextj));
            ve = _mm512_max_epi16(ve, vneg);
            keg = _mm512_cmpeq_epi16_mask(ve, _mm512_sub_epi16(vgprev, vgoe));
        } else {
            ve = vneg;
        }
        const __mmask32 kvalid = _mm512_cmplt_epi16_mask(vcol, vtlen);
        const __m512i vgpost = _mm512_mask_blend_epi16(kvalid, vneg, vg);
        const __m512i vh0 = _mm512_max_epi16(vg, ve);
        const __m512i vh = _mm512_mask_blend_epi16(kvalid, vneg, vh0);
        STU(Hb, j, vh);
        // fused masked adds: the direction bits are disjoint powers of two
        // and each is set at most once, so a masked vpaddw == the or — one
        // instruction per bit instead of maskz-mov + or (AVX-512BW has no
        // 16-bit-masked OR)
        vd = _mm512_mask_add_epi16(vd,
            _mm512_cmpeq_epi16_mask(vh, vgpost), vd, vb_hg);
        vd = _mm512_mask_add_epi16(vd,
            _mm512_cmpeq_epi16_mask(vgpost, vzero), vd, vb_gz);
        vd = _mm512_mask_add_epi16(vd,
            _mm512_cmpeq_epi16_mask(vgpost, vf), vd, vb_gf);
        vd = _mm512_mask_add_epi16(vd, keg, vd, vb_eg);
        _mm256_stream_si256((__m256i*)(drow_base + (size_t)j * stride),
                            _mm512_cvtepi16_epi8(vd));
        const __m512i vcand = _mm512_add_epi16(vg, vextj);
        const __mmask32 ktake =
            _mm512_cmp_epi16_mask(vrunv, vcand, _MM_CMPINT_LE);
        vrunv = _mm512_mask_blend_epi16(ktake, vrunv, vcand);
        vgprev = vgpost;
        const __mmask32 kb = _mm512_cmpgt_epi16_mask(vh, vbv);
        vbv = _mm512_mask_blend_epi16(kb, vbv, vh);
        vbqe = _mm512_mask_blend_epi16(kb, vbqe, vr);
        vbj = _mm512_mask_blend_epi16(kb, vbj, vj);
    }
    _mm512_storeu_si512((void*)bv, vbv);
    _mm512_storeu_si512((void*)bqe, vbqe);
    _mm512_storeu_si512((void*)bj, vbj);
}
#endif  // __AVX512BW__

inline void fused_tb_row_pass(
    TbScratch& sc, const int16_t* qc, const int16_t* dl,
    const int16_t* lrow16, const int16_t* tlen16, int32_t r, int32_t band,
    uint8_t* drow_base, int16_t* bv, int16_t* bqe, int16_t* bj) {
#if defined(__AVX512BW__)
    fused_tb_row_pass_avx512(sc, qc, dl, lrow16, tlen16, r, band,
                             drow_base, bv, bqe, bj);
#else
    fused_tb_row_pass_scalar(sc, qc, dl, lrow16, tlen16, r, band,
                             drow_base, bv, bqe, bj);
#endif
}

inline void tb_block(
    const uint8_t* const* q, const int32_t* qlen,
    const uint8_t* const* t, const int32_t* tlen,
    const int32_t* const* lo_raw,  // planner lo, len qlen per pair
    int np, int band, Result* res /* PBLK */,
    uint32_t* cigars /* PBLK * max_cigar */, int32_t max_cigar,
    TbScratch& sc) {
    const int stride = PBLK;
    const size_t plane = (size_t)(band + 1) * stride;
    sc.H.assign(plane, 0);
    sc.F.assign(plane, NEG);
    sc.tc.resize(plane);

    int32_t m_max = 0;
    for (int p = 0; p < np; p++) m_max = std::max(m_max, qlen[p]);
    // 64-byte-align the dirs base so the AVX-512 path can use streaming
    // stores (the full matrix is written once and only a thin traceback
    // path is read back -- NT stores skip the RFO and cache pollution)
    sc.dirs.resize((size_t)m_max * band * stride + 64);
    uint8_t* dirs = (uint8_t*)(((uintptr_t)sc.dirs.data() + 63) & ~(uintptr_t)63);

    int16_t bv[PBLK], bqe[PBLK], bj[PBLK];
    for (int p = 0; p < PBLK; p++) { bv[p] = 0; bqe[p] = 0; bj[p] = 0; }

    int16_t qc[PBLK], dl[PBLK], lrow16[PBLK], tlen16[PBLK];
    uint8_t regather[PBLK];
    int32_t lrow[PBLK];
    for (int p = 0; p < PBLK; p++) tlen16[p] = (int16_t)tlen[p < np ? p : 0];

    for (int32_t r = 1; r <= m_max; r++) {
        bool any_jump = false;
        for (int p = 0; p < np; p++) {
            const int32_t m = qlen[p];
            const int32_t ri = std::min(r, m);
            const int32_t lr = (int32_t)lo_raw[p][ri - 1];
            const int32_t lprev = (r <= 1 || r > m) ? lr : (int32_t)lo_raw[p][ri - 2];
            qc[p] = (r <= m) ? (int16_t)q[p][r - 1] : (int16_t)5;
            lrow[p] = lr;
            const int32_t d = lr - lprev;
            dl[p] = (int16_t)d;
            if (d > 1) any_jump = true;
            lrow16[p] = (int16_t)lr;
            regather[p] = 0;
        }
        if (any_jump) {
            int16_t* planes_neg[2] = { sc.H.data(), sc.F.data() };
            for (int p = 0; p < np; p++) {
                const int32_t d = dl[p];
                if (d <= 1) continue;
                const int32_t sh = d - 1;
                for (int x = 0; x < 2; x++) {
                    int16_t* pl = planes_neg[x];
                    for (int32_t j = 0; j + sh < band + 1; j++)
                        pl[(size_t)j * PBLK + p] = pl[(size_t)(j + sh) * PBLK + p];
                    for (int32_t j = std::max(0, band + 1 - sh); j < band + 1; j++)
                        pl[(size_t)j * PBLK + p] = NEG;
                }
                dl[p] = 1;
                regather[p] = 1;
            }
        }

        // target window (same incremental scheme as sw_nm_batch)
        if (r == 1) {
            for (int32_t j = 0; j < band; j++) {
                int16_t* tcj = &sc.tc[(size_t)j * stride];
                for (int p = 0; p < np; p++) {
                    int64_t col = lrow[p] + j;
                    if (col >= tlen[p]) col = tlen[p] - 1;
                    tcj[p] = (col >= 0) ? (int16_t)t[p][col] : (int16_t)255;
                }
            }
        } else {
            int16_t* __restrict tcb = sc.tc.data();
            int16_t md1v[PBLK];
            for (int p = 0; p < PBLK; p++)
                md1v[p] = (int16_t)-(int16_t)(dl[p] == 1 && !regather[p]);
            for (int32_t j = 0; j < band - 1; j++) {
                const size_t o0 = (size_t)j * stride;
                const size_t o1 = o0 + stride;
#ifdef _OPENMP
#pragma omp simd
#endif
                for (int p = 0; p < PBLK; p++)
                    tcb[o0 + p] = SEL16(md1v[p], tcb[o1 + p], tcb[o0 + p]);
            }
            int16_t* tclast = &sc.tc[(size_t)(band - 1) * stride];
            for (int p = 0; p < np; p++) {
                if (regather[p]) {
                    for (int32_t j = 0; j < band; j++) {
                        int64_t col = lrow[p] + j;
                        if (col >= tlen[p]) col = tlen[p] - 1;
                        sc.tc[(size_t)j * stride + p] = (int16_t)t[p][col];
                    }
                } else if (dl[p] == 1) {
                    int64_t col = lrow[p] + band - 1;
                    if (col >= tlen[p]) col = tlen[p] - 1;
                    tclast[p] = (int16_t)t[p][col];
                }
            }
        }

        uint8_t* __restrict drow_base = dirs + (size_t)(r - 1) * band * stride;

        // fused F/G + E-prefix + direction-bit pass (AVX-512BW where
        // available, scalar fallback; both bit-identical)
        fused_tb_row_pass(sc, qc, dl, lrow16, tlen16, r, band, drow_base,
                          bv, bqe, bj);
        // in-place update; fill slots at j = band keep their init values
    }
#if defined(__AVX512BW__)
    _mm_sfence();  // NT direction-byte stores must land before readback
#endif

    // per-pair scalar traceback over direction bytes
    for (int p = 0; p < np; p++) {
        Result* rs = &res[p];
        rs->score = bv[p];
        rs->cigar_len = 0;
        rs->overflow = 0;
        if (bv[p] <= 0) continue;
        const int32_t* lp = lo_raw[p];
        auto lo_full = [&](int32_t rr) -> int64_t {
            return (rr <= 0) ? lp[0] : lp[rr - 1];
        };
        std::vector<uint8_t>& ops = sc.ops;
        ops.clear();
        int32_t r = bqe[p], j = bj[p];
        const int32_t best_r = r, best_j = j;
        int state = 0;
        while (r > 0 && j >= 0 && j < band) {
            const int32_t d_l = (int32_t)(lo_full(r) - lo_full(r - 1));
            const uint8_t d = dirs[((size_t)(r - 1) * band + j) * PBLK + p];
            if (state == 0) { state = (d & T_H_IS_G) ? 1 : 2; continue; }
            if (state == 1) {
                if (d & T_G_ZERO) break;
                if (d & T_G_IS_F) { state = 3; continue; }
                ops.push_back(0);
                r -= 1;
                j = j + d_l - 1;
                state = 0;
                if (j < 0) break;
                continue;
            }
            if (state == 2) {
                ops.push_back(2);
                if (d & T_E_FROM_G) state = 1;
                j -= 1;
                continue;
            }
            ops.push_back(1);
            if (d & T_F_FROM_H) state = 0;
            r -= 1;
            j = j + d_l;
            if (j >= band) break;
        }

        int32_t q_len2 = 0, t_len2 = 0;
        for (uint8_t o : ops) {
            if (o != 2) q_len2++;
            if (o != 1) t_len2++;
        }
        const int32_t q_end = best_r;
        const int64_t t_end = lo_full(best_r) + best_j + 1;
        const int32_t q_start = q_end - q_len2;
        const int64_t t_start = t_end - t_len2;
        rs->q0 = q_start; rs->q1 = q_end;
        rs->t0 = (int32_t)t_start; rs->t1 = (int32_t)t_end;

        int32_t nm = 0, clen = 0;
        int64_t qp2 = q_start, tp2 = t_start;
        uint32_t* cig = cigars + (size_t)p * max_cigar;
        for (int64_t i = (int64_t)ops.size() - 1; i >= 0;) {
            const uint8_t op = ops[i];
            int64_t jend = i;
            while (jend >= 0 && ops[jend] == op) jend--;
            const int32_t len = (int32_t)(i - jend);
            if (op == 0) {
                for (int32_t x = 0; x < len; x++) {
                    const uint8_t qb = q[p][qp2 + x], tb = t[p][tp2 + x];
                    if (qb != tb || (qb == 4 && tb == 4)) nm++;
                }
                qp2 += len; tp2 += len;
            } else if (op == 1) { nm += len; qp2 += len; }
            else { nm += len; tp2 += len; }
            if (clen < max_cigar) cig[clen] = ((uint32_t)len << 4) | op;
            else rs->overflow = 1;
            clen++;
            i = jend;
        }
        rs->nm = nm;
        rs->cigar_len = std::min(clen, max_cigar);
    }
}

}  // namespace

extern "C" {

// Full traceback batch on raw planner bands; drop-in results vs
// sw_banded_batch.  out_meta: (B, 8) int32 like sw_banded_batch.
void sw_tb_batch(
    const uint8_t* q, const int64_t* q_off, const int32_t* q_len,
    const uint8_t* t, const int64_t* t_off, const int32_t* t_len,
    const int32_t* lo, const int64_t* lo_off,
    int32_t n_pairs, int32_t band,
    int32_t* out_meta, uint32_t* out_cigar, int32_t max_cigar,
    int32_t n_threads) {
    const int32_t n_blocks = (n_pairs + PBLK - 1) / PBLK;
#ifdef _OPENMP
    const int nt_ = (n_threads > 0) ? n_threads
                    : (n_blocks > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel num_threads(nt_)
#endif
    {
        TbScratch sc;
        const uint8_t* qp[PBLK];
        const uint8_t* tp[PBLK];
        const int32_t* lop[PBLK];
        int32_t ql[PBLK], tl[PBLK];
        Result blk_res[PBLK];
        std::vector<uint32_t> blk_cig;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int32_t b = 0; b < n_blocks; b++) {
            const int32_t start = b * PBLK;
            const int np = std::min<int32_t>(PBLK, n_pairs - start);
            for (int i = 0; i < PBLK; i++) {
                const int32_t src = (i < np) ? start + i : start;
                qp[i] = q + q_off[src];
                tp[i] = t + t_off[src];
                lop[i] = lo + lo_off[src];
                ql[i] = q_len[src];
                tl[i] = t_len[src];
            }
            blk_cig.assign((size_t)PBLK * max_cigar, 0);
            tb_block(qp, ql, tp, tl, lop, np, band, blk_res, blk_cig.data(),
                     max_cigar, sc);
            for (int i = 0; i < np; i++) {
                int32_t* mrow = out_meta + (size_t)(start + i) * 8;
                mrow[0] = blk_res[i].score; mrow[1] = blk_res[i].q0;
                mrow[2] = blk_res[i].q1; mrow[3] = blk_res[i].t0;
                mrow[4] = blk_res[i].t1; mrow[5] = blk_res[i].nm;
                mrow[6] = blk_res[i].cigar_len; mrow[7] = blk_res[i].overflow;
                std::memcpy(out_cigar + (size_t)(start + i) * max_cigar,
                            blk_cig.data() + (size_t)i * max_cigar,
                            (size_t)max_cigar * sizeof(uint32_t));
            }
        }
    }
}

}  // extern "C"

