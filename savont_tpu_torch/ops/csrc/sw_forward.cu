// Kernel 1: banded affine local Smith-Waterman forward pass, one thread per
// (query, target) pair, for sm_90a.
//
// Replaces savont_tpu/ops/align_pallas.py:_sw_kernel_with_init, the Pallas
// TPU kernel, in both of its modes:
//   NM mode       out (B, 4) int32: score, q_end, t_end, nm per pair (the NM
//                 of the winning path rides along as metadata, as in
//                 align_jax.sw_forward_meta);
//   payload mode  out (3, B) int32: score, ri, bj (bj = band lane of the best
//                 cell), plus payload (B, Lq, band) uint8 with one traceback
//                 decision byte per cell: bit0 use_g, bit1 g_zero, bit2 g_f,
//                 bit3 exitE, bit4 from_h, bit5 mismatch (align_jax.
//                 _forward_payload's layout; one byte per cell, not the TPU's
//                 four rows per i32 word).
//
// Corridors are the RAW planner bands: any non-decreasing per-row advance
// dl >= 0.  "up" is column j+dl of the previous row and "diag" column
// j+dl-1, the barrel-shift semantics of align_jax.sw_forward_meta(
// smooth=False) / _forward_payload, so no corridor smoothing, lag gate or
// side path is needed.  Tie rules (the contract with the host oracle):
// F prefers the H origin (>=); G ranks zero, then F, then diagonal; the E
// prefix max takes the current element on >= (nearest origin); H prefers G
// (>=); the best cell updates on strict > in row-major order (max value,
// then earliest row, then lowest lane); column 0 has a free left edge; query
// padding (code 5) and target padding (code 6) never match.  Cells past the
// target end read the last target code and have H = NEG, as in the JAX
// reference, so payload bytes agree everywhere.
//
// What bounds it on the H100: the integer issue rate of the per-cell
// max/add/select chain (about 30 integer ops per cell) and, in payload mode,
// the 1-byte-per-cell payload write.  This simple design does nothing about
// either yet, on purpose: one thread walks its pair's band sequentially
// (the E prefix max is a running max), the previous row's H/F(/nm) planes
// sit in thread-local memory and are updated in place, and the card is
// filled only as far as the batch has pairs.  Warp-per-pair with the band
// across lanes, DPX max3, and int16x2 planes are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -20000;
constexpr int kThreads = 64;

struct Scoring {
  int match, mismatch, gap_open, gap_ext;
};

template <int MAXB, bool PAYLOAD>
__global__ void __launch_bounds__(kThreads)
sw_forward_kernel(const int* __restrict__ q, const int* __restrict__ t,
                  const int* __restrict__ lo, const int* __restrict__ tlens,
                  int B, int Lq, int Lt, int band, Scoring sc,
                  int* __restrict__ out, uint8_t* __restrict__ payload) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int NMB = PAYLOAD ? 1 : MAXB;  // nm planes only in NM mode
  int H[MAXB], F[MAXB], NMH[NMB], NMF[NMB];

  const int* qb = q + (size_t)b * Lq;
  const int* tb = t + (size_t)b * Lt;
  const int* lob = lo + (size_t)b * (Lq + 1);
  const int tlen = tlens[b];
  const int tlast = tlen > 0 ? tlen - 1 : 0;
  const int go = sc.gap_open, ge = sc.gap_ext;

  for (int j = 0; j < band; ++j) {
    H[j] = 0;
    F[j] = kNeg;
    if constexpr (!PAYLOAD) {
      NMH[j] = 0;
      NMF[j] = 0;
    }
  }
  int best_v = 0, best_r = 0, best_j = 0, best_te = 0, best_nm = 0;
  int lo_prev = lob[0];

  for (int r = 1; r <= Lq; ++r) {
    const int qc = qb[r - 1];
    const int l = lob[r];
    const int dl = l - lo_prev;
    lo_prev = l;
    // E prefix state over lanes j' < j: max of G[j'] + ge*j' (ties -> the
    // later lane) and, in NM mode, the nm metadata nmg[j'] - j' beside it
    int run_v = kNeg, run_m = 0;
    // previous row's H / nm at lane j-1, saved before the in-place update
    // overwrote it (the diagonal source when dl == 0)
    int old_h = kNeg, old_nm = 0;
    int g_left = kNeg;  // this row's G at lane j-1 (payload exitE bit)
    uint8_t* prow = PAYLOAD ? payload + ((size_t)b * Lq + (r - 1)) * band : nullptr;

    for (int j = 0; j < band; ++j) {
      const int col = l + j;
      const int tc = tb[min(col, tlast)];
      const bool is_match = (tc == qc) && (qc < 4) && (tc < 4);
      const int s = is_match ? sc.match : sc.mismatch;

      // previous-row sources: up = lane j+dl, diag = lane j+dl-1.  In-place
      // update is safe: lanes >= j are still the previous row's, and lane
      // j-1 (needed only when dl == 0) was saved in old_h / old_nm.
      const int u = j + dl;
      const bool up_in = u < band;
      const int h_up = up_in ? H[u] : kNeg;
      const int f_up = up_in ? F[u] : kNeg;
      int h_diag, nm_diag = 0;
      if (dl == 0) {
        h_diag = old_h;
        if constexpr (!PAYLOAD) nm_diag = old_nm;
      } else {
        const bool d_in = u - 1 < band;
        h_diag = d_in ? H[u - 1] : kNeg;
        if constexpr (!PAYLOAD) nm_diag = d_in ? NMH[u - 1] : 0;
      }
      if (j == 0 && col == 0) {  // free left edge at target column 0
        h_diag = 0;
        nm_diag = 0;
      }

      const bool from_h = (h_up - go) >= f_up;
      const int f = max(max(h_up - go, f_up) - ge, kNeg);
      const int g = max(max(0, h_diag + s), f);
      const bool g_zero = g == 0;
      const bool g_f = !g_zero && g == f;
      const int e = max(run_v - go - ge * j, kNeg);
      const bool use_g = g >= e;
      int h = use_g ? g : e;
      if (col >= tlen) h = kNeg;

      int nmh_n = 0, nmf_n = 0;
      if constexpr (!PAYLOAD) {
        nmf_n = (from_h ? (up_in ? NMH[u] : 0) : (up_in ? NMF[u] : 0)) + 1;
        const int nmg = g_zero ? 0 : (g_f ? nmf_n : nm_diag + (is_match ? 0 : 1));
        nmh_n = use_g ? nmg : run_m + j;
        if (g + ge * j >= run_v) run_m = nmg - j;
        old_nm = NMH[j];
        NMH[j] = nmh_n;
        NMF[j] = nmf_n;
      } else {
        const bool exit_e = e == g_left - go - ge;
        prow[j] = (uint8_t)((use_g ? 1 : 0) | (g_zero ? 2 : 0) | (g_f ? 4 : 0) |
                            (exit_e ? 8 : 0) | (from_h ? 16 : 0) | (is_match ? 0 : 32));
        g_left = g;
      }
      run_v = max(run_v, g + ge * j);
      old_h = H[j];
      H[j] = h;
      F[j] = f;

      if (h > best_v) {
        best_v = h;
        best_r = r;
        best_j = j;
        best_te = col + 1;
        best_nm = nmh_n;
      }
    }
  }

  if constexpr (PAYLOAD) {
    out[b] = best_v;
    out[B + b] = best_r;
    out[2 * B + b] = best_j;
  } else {
    int* o = out + (size_t)b * 4;
    o[0] = best_v;
    o[1] = best_r;
    o[2] = best_te;
    o[3] = best_nm;
  }
}

template <int MAXB>
void launch(bool payload_mode, dim3 grid, cudaStream_t stream, const int* q,
            const int* t, const int* lo, const int* tlens, int B, int Lq, int Lt,
            int band, Scoring sc, int* out, uint8_t* payload) {
  if (payload_mode) {
    sw_forward_kernel<MAXB, true><<<grid, kThreads, 0, stream>>>(
        q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  } else {
    sw_forward_kernel<MAXB, false><<<grid, kThreads, 0, stream>>>(
        q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  }
}

}  // namespace

// Launches kernel 1 on `stream` over B pairs.  All pointers are device
// pointers to contiguous int32 tensors (payload: uint8):
//   q (B, Lq), t (B, Lt), lo (B, Lq+1), tlens (B,);
//   NM mode: out (B, 4); payload mode: out (3, B) and payload (B, Lq, band).
// Allocates nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int sw_forward_launch(const int* q, const int* t, const int* lo,
                                 const int* tlens, int B, int Lq, int Lt, int band,
                                 int match, int mismatch, int gap_open, int gap_ext,
                                 int emit_payload, int* out, unsigned char* payload,
                                 void* stream) {
  if (B <= 0) return 0;
  if (band < 1 || band > 256 || Lq < 1 || Lt < 1) return (int)cudaErrorInvalidValue;
  const Scoring sc{match, mismatch, gap_open, gap_ext};
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const bool pm = emit_payload != 0;
  if (band <= 64) {
    launch<64>(pm, grid, s, q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  } else if (band <= 128) {
    launch<128>(pm, grid, s, q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  } else {
    launch<256>(pm, grid, s, q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  }
  return (int)cudaGetLastError();
}
