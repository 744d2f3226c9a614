// Kernel 1: banded affine local Smith-Waterman forward pass for sm_90a, one
// warp per (query, target) pair with the band across the warp's lanes.
//
// Replaces savont_tpu/ops/align_pallas.py:_sw_kernel_with_init, the Pallas
// TPU kernel, in both of its modes:
//   NM mode       out (B, 4) int32: score, q_end, t_end, nm per pair (the NM
//                 of the winning path rides along as metadata, as in
//                 align_jax.sw_forward_meta);
//   payload mode  out (3, B) int32: score, ri, bj (bj = band cell of the best
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
// (>=); the best cell is the maximum value, then the earliest row, then the
// lowest band cell; column 0 has a free left edge; query padding (code 5)
// and target padding (code 6) never match.  Cells past the target end read
// the last target code and have H = NEG, as in the JAX reference, so payload
// bytes agree everywhere.
//
// Layout.  Lane L of a pair's warp holds the CPL = ceil(band / 32) band
// cells j = L*CPL .. L*CPL+CPL-1 (CPL is a template parameter: 1, 2, 4, 8),
// and the H / F (and, in NM mode, nm) planes of the previous row live in
// registers, indexed only by unrolled constants.  Cells j >= band are
// padding: their H and F are NEG in every row, which is what a read past the
// band's end must give, and nothing they compute reaches a cell below them.
//   - The per-row advance dl is uniform across the warp.  dl == 0 and
//     dl == 1 are straight-line code: up / diag are the plane itself and its
//     shift by one cell, a register move plus one shuffle for the block's
//     edge cell.  Any other dl goes through one row of shared memory.
//   - The E prefix max over lower cells is a running max inside the lane and
//     a 5-step shuffle scan of the lanes' totals.  Payload mode scans the
//     value; NM mode scans (value, nm metadata) pairs and keeps the later
//     cell on equal values.
//   - Every cell keeps its own best on strict >, which records its earliest
//     row; after the last row one lexicographic reduce over the warp gives
//     the winner.  t_end is recovered from the winner's row.
//   - q and lo are read 32 rows at a time, one coalesced load per plane, and
//     handed out by shuffle; the next 32 rows are in flight meanwhile.  Each
//     lane loads its target codes one row ahead.
//   - Payload bytes are staged in shared memory, 32 rows at a time, and
//     written as 16-byte vectors; the pair's payload is one contiguous
//     stream, so a remainder below 16 bytes is carried to the next flush and
//     single bytes are stored only at an unaligned start or end of the pair.
//
// What bounds it on the H100: instruction issue.  A warp-row at band 48 is
// about 190 (payload) or 240 (NM) SASS instructions for 64 cell slots, most
// of them on the integer ALU pipe: the max / add chain, the compares and
// selects behind the six payload bits or the nm planes, and the 5-step scan.
// The planes never touch local memory, the payload leaves in 16-byte
// vectors, and the bytes (one per cell in payload mode) are a sixth of the
// kernel's time.  Four warps per block, so a batch of a few thousand pairs
// gives every SM several blocks; a batch below about 500 pairs leaves SMs
// idle.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -20000;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;  // rows per chunk of q / lo and per payload flush
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
  int match, mismatch, gap_open, gap_ext;
};

// bytes of payload staging per warp: kRows rows, an unaligned start (< 16)
// or a carried remainder (< 16), rounded so every warp's buffer is aligned
__host__ __device__ constexpr int stage_stride(int band) { return kRows * band + 32; }

// Up / diag sources of one plane for a row advance dl >= 2 (clamped to 512),
// through the warp's row of shared memory.
template <int CPL>
__device__ __forceinline__ void gather_general(int* rb, const int (&P)[CPL], int dl, int fill,
                                               int lane, int (&up)[CPL], int (&dg)[CPL]) {
  constexpr int W = 32 * CPL;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < CPL; ++c) rb[lane * CPL + c] = P[c];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int u = lane * CPL + c + dl;
    up[c] = u < W ? rb[u] : fill;
    dg[c] = u - 1 < W ? rb[u - 1] : fill;
  }
}

// Stores a lane's CPL payload bytes to shared memory at `addr` (a shared-
// space address, aligned to CPL) in one instruction.
template <int CPL>
__device__ __forceinline__ void sts_cells(uint32_t addr, const unsigned (&b)[CPL]) {
  if constexpr (CPL == 1) {
    asm volatile("st.shared.u8 [%0], %1;" ::"r"(addr), "r"(b[0]) : "memory");
  } else if constexpr (CPL == 2) {
    asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"((unsigned short)(b[0] | b[1] << 8))
                 : "memory");
  } else {
    unsigned w[CPL / 4];
#pragma unroll
    for (int k = 0; k < CPL / 4; ++k)
      w[k] = b[4 * k] | b[4 * k + 1] << 8 | b[4 * k + 2] << 16 | b[4 * k + 3] << 24;
    if constexpr (CPL == 4) {
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(w[0]) : "memory");
    } else {
      asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(w[0]), "r"(w[CPL / 4 - 1])
                   : "memory");
    }
  }
}

// Writes the staged payload bytes st[a .. cnt) to global memory, where
// gbase + x is the (16-byte aligned) address of st[0]'s byte x.  Whole
// 16-byte vectors go out as such; bytes before the first aligned address go
// out singly; a remainder is stored singly at the pair's end (`last`) and
// otherwise moved to the buffer's start for the next flush.
__device__ __forceinline__ void flush_payload(unsigned char* st, unsigned char*& gbase, int& cnt,
                                              int& a, bool last, int lane) {
  __syncwarp();
  const int head_end = a > 0 ? min(cnt, 16) : 0;
  if (a + lane < head_end) gbase[a + lane] = st[a + lane];
  const int vend = cnt & ~15;
  for (int x = (a > 0 ? 16 : 0) + 16 * lane; x < vend; x += 16 * 32)
    *reinterpret_cast<uint4*>(gbase + x) = *reinterpret_cast<const uint4*>(st + x);
  const int tstart = max(vend, head_end);
  const int rem = cnt - tstart;  // < 16
  if (last) {
    if (lane < rem) gbase[tstart + lane] = st[tstart + lane];
  } else {
    unsigned char v = 0;
    if (lane < rem) v = st[tstart + lane];
    __syncwarp();
    if (lane < rem) st[lane] = v;
    gbase += tstart;
    cnt = rem;
    a = 0;
  }
  __syncwarp();
}

template <int CPL, bool PAYLOAD>
__global__ void __launch_bounds__(kThreads)
sw_forward_kernel(const int* __restrict__ q, const int* __restrict__ t,
                  const int* __restrict__ lo, const int* __restrict__ tlens,
                  int B, int Lq, int Lt, int band, Scoring sc,
                  int* __restrict__ out, unsigned char* __restrict__ payload) {
  extern __shared__ __align__(16) unsigned char stage_all[];
  __shared__ int rowbuf[kWarps][32 * CPL];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warps leave; the kernel has no block barrier

  const int* qb = q + (size_t)b * Lq;
  const int* tb = t + (size_t)b * Lt;
  asm volatile("" : "+l"(tb));  // keep the row's base in registers: one IMAD.WIDE per load
  const int* lob = lo + (size_t)b * (Lq + 1);
  const int tlen = tlens[b];
  const int tlast = tlen > 0 ? tlen - 1 : 0;
  const int go = sc.gap_open, ge = sc.gap_ext;
  const int j0 = lane * CPL;
  int* rb = rowbuf[warp];

  // planes of the previous row, each cell's best, and thr: H = NEG where
  // lo + j >= tlen (past the target's end) and in the padding cells
  int H[CPL], F[CPL], NH[CPL], NF[CPL], bv[CPL], br[CPL], bn[CPL], thr[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const bool active = j0 + c < band;
    H[c] = active ? 0 : kNeg;
    F[c] = kNeg;
    NH[c] = NF[c] = 0;
    bv[c] = br[c] = bn[c] = 0;
    thr[c] = active ? tlen - (j0 + c) : INT_MIN;
    asm volatile("" : "+r"(thr[c]));  // a register, not recomputed in every row
  }

  // payload staging: st[x] is the byte at global address gbase + x
  unsigned char* st = nullptr;
  unsigned char* gbase = nullptr;
  int cnt = 0, align0 = 0;
  uint32_t st_lane = 0;  // shared-space address of st[j0]
  bool packed = false;   // a lane's CPL bytes of a row are one aligned store
  if constexpr (PAYLOAD) {
    st = stage_all + (size_t)warp * stage_stride(band);
    unsigned char* gp = payload + (size_t)b * Lq * band;
    align0 = (int)(reinterpret_cast<uintptr_t>(gp) & 15);
    gbase = gp - align0;
    cnt = align0;
    st_lane = (uint32_t)__cvta_generic_to_shared(st) + j0;
    // every row then starts at a multiple of CPL (flushes move multiples
    // of 16), and a lane's cells are all inside the band or all padding
    packed = align0 % CPL == 0 && band % CPL == 0;
  }

  // lane i of (qv, lv) holds q[r0 + i] and lo[r0 + 1 + i] of the chunk of
  // rows r0+1 .. r0+32; (qn, ln) the next chunk's
  int qv = lane < Lq ? qb[lane] : 5;
  int lv = lob[min(1 + lane, Lq)];
  int lo_prev = lob[0];
  int l = __shfl_sync(kFull, lv, 0);
  int tcn[CPL];  // target codes of the coming row
#pragma unroll
  for (int c = 0; c < CPL; ++c) tcn[c] = __ldg(tb + min(l + j0 + c, tlast));

  for (int r0 = 0; r0 < Lq; r0 += kRows) {
    const int nxt = r0 + kRows + lane;
    const int qn = nxt < Lq ? qb[nxt] : 5;
    const int ln = lob[min(nxt + 1, Lq)];
    const int n = min(kRows, Lq - r0);

    for (int i = 0; i < n; ++i) {
      const int r = r0 + i + 1;
      const int qc = __shfl_sync(kFull, qv, i);
      const int l_next = __shfl_sync(kFull, i < 31 ? lv : ln, (i + 1) & 31);
      int tc[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        tc[c] = tcn[c];
        tcn[c] = __ldg(tb + min(l_next + j0 + c, tlast));
      }
      const int dl = l - lo_prev;

      // previous-row sources: up = cell j+dl, diag = cell j+dl-1
      int hu[CPL], fu[CPL], hd[CPL], nhu[CPL], nfu[CPL], nhd[CPL];
      if (dl == 0) {
        int eh = __shfl_up_sync(kFull, H[CPL - 1], 1);
        if (lane == 0) eh = kNeg;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          hu[c] = H[c];
          fu[c] = F[c];
          hd[c] = c > 0 ? H[c > 0 ? c - 1 : 0] : eh;
        }
        if constexpr (!PAYLOAD) {
          int en = __shfl_up_sync(kFull, NH[CPL - 1], 1);
          if (lane == 0) en = 0;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            nhu[c] = NH[c];
            nfu[c] = NF[c];
            nhd[c] = c > 0 ? NH[c > 0 ? c - 1 : 0] : en;
          }
        }
      } else if (dl == 1) {
        int eh = __shfl_down_sync(kFull, H[0], 1);
        int ef = __shfl_down_sync(kFull, F[0], 1);
        if (lane == 31) eh = ef = kNeg;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          hd[c] = H[c];
          hu[c] = c < CPL - 1 ? H[c < CPL - 1 ? c + 1 : c] : eh;
          fu[c] = c < CPL - 1 ? F[c < CPL - 1 ? c + 1 : c] : ef;
        }
        if constexpr (!PAYLOAD) {
          int enh = __shfl_down_sync(kFull, NH[0], 1);
          int enf = __shfl_down_sync(kFull, NF[0], 1);
          if (lane == 31) enh = enf = 0;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            nhd[c] = NH[c];
            nhu[c] = c < CPL - 1 ? NH[c < CPL - 1 ? c + 1 : c] : enh;
            nfu[c] = c < CPL - 1 ? NF[c < CPL - 1 ? c + 1 : c] : enf;
          }
        }
      } else {
        const int dlc = min(dl, 512);  // beyond the band everything is fill
        int unused[CPL];
        gather_general<CPL>(rb, H, dlc, kNeg, lane, hu, hd);
        gather_general<CPL>(rb, F, dlc, kNeg, lane, fu, unused);
        if constexpr (!PAYLOAD) {
          gather_general<CPL>(rb, NH, dlc, 0, lane, nhu, nhd);
          gather_general<CPL>(rb, NF, dlc, 0, lane, nfu, unused);
        }
      }
      if (lane == 0 && l == 0) {  // free left edge at target column 0
        hd[0] = 0;
        if constexpr (!PAYLOAD) nhd[0] = 0;
      }

      // F and G of this row, and the E scan's inputs g + ge*j
      const int qe = qc < 4 ? qc : -1;  // target codes are >= 0
      int g[CPL], f[CPL], nmg[CPL], nfn[CPL];
      unsigned bits[CPL];
      int pv = kNeg, pm = 0;      // running (value, nm metadata) of the lane
      int lxv[CPL], lxm[CPL];     // the same before each cell
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const bool is_match = tc[c] == qe;
        const int s = is_match ? sc.match : sc.mismatch;
        const int x = hu[c] - go;
        const bool from_h = x >= fu[c];
        f[c] = max(max(x, fu[c]) - ge, kNeg);
        // in this order on purpose: written max(max(diag, f), 0), ptxas 12.x
        // read g == f off the predicate output of a VIMNMX.RELU and g_f came
        // out true where diag > f (chip_smoke.py's edge phase holds the line)
        g[c] = max(max(0, hd[c] + s), f[c]);
        const bool g_zero = g[c] == 0;
        const bool g_f = !g_zero && g[c] == f[c];
        const int sv = g[c] + ge * (j0 + c);
        lxv[c] = pv;
        if constexpr (PAYLOAD) {
          bits[c] = (g_zero ? 2u : 0u) | (g_f ? 4u : 0u) | (from_h ? 16u : 0u) |
                    (is_match ? 0u : 32u);
          pv = max(pv, sv);
        } else {
          nfn[c] = (from_h ? nhu[c] : nfu[c]) + 1;
          nmg[c] = g_zero ? 0 : (g_f ? nfn[c] : nhd[c] + (is_match ? 0 : 1));
          lxm[c] = pm;
          if (sv >= pv) {  // ties keep the later cell
            pv = sv;
            pm = nmg[c] - (j0 + c);
          }
        }
      }

      // inclusive scan of the lanes' totals, then the lanes below.  A lane
      // below d gets its own value back from the shuffle, which changes
      // nothing, so no step needs a guard
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int ov = __shfl_up_sync(kFull, pv, d);
        if constexpr (PAYLOAD) {
          pv = max(pv, ov);
        } else {
          const int om = __shfl_up_sync(kFull, pm, d);
          if (ov > pv) {
            pv = ov;
            pm = om;
          }
        }
      }
      int ev = __shfl_up_sync(kFull, pv, 1);
      int em = 0;
      if constexpr (!PAYLOAD) em = __shfl_up_sync(kFull, pm, 1);
      if (lane == 0) {
        ev = kNeg;
        em = 0;
      }
      int gl = 0;  // this row's G at cell j-1 of the lane's first cell
      if constexpr (PAYLOAD) {
        gl = __shfl_up_sync(kFull, g[CPL - 1], 1);
        if (lane == 0) gl = kNeg;
      }

      // E, H, the payload byte or the nm planes, and each cell's best
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = j0 + c;
        const bool own = lxv[c] >= ev;  // ties keep the later cell
        const int run_v = own ? lxv[c] : ev;
        const int e = max(run_v - (go + ge * j), kNeg);
        const bool use_g = g[c] >= e;
        int h = max(g[c], e);
        if (l >= thr[c]) h = kNeg;
        int nmh = 0;
        if constexpr (PAYLOAD) {
          const int g_left = c > 0 ? g[c > 0 ? c - 1 : 0] : gl;
          const bool exit_e = e == g_left - go - ge;
          bits[c] |= (use_g ? 1u : 0u) | (exit_e ? 8u : 0u);
        } else {
          const int run_m = own ? lxm[c] : em;
          nmh = use_g ? nmg[c] : run_m + j;
          NH[c] = nmh;
          NF[c] = nfn[c];
        }
        if (h > bv[c]) {
          bv[c] = h;
          br[c] = r;
          if constexpr (!PAYLOAD) bn[c] = nmh;
        }
        H[c] = h;
        F[c] = f[c];
      }
      if constexpr (PAYLOAD) {
        if (packed) {
          if (j0 < band) sts_cells<CPL>(st_lane + cnt, bits);
        } else {
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const unsigned one[1] = {bits[c]};
            if (j0 + c < band) sts_cells<1>(st_lane + cnt + c, one);
          }
        }
        cnt += band;
      }
      lo_prev = l;
      l = l_next;
    }

    if constexpr (PAYLOAD) flush_payload(st, gbase, cnt, align0, r0 + kRows >= Lq, lane);
    qv = qn;
    lv = ln;
  }

  // the winner: max value, then earliest row, then lowest cell
  int v = bv[0], rr = br[0], jj = j0, nn = bn[0];
#pragma unroll
  for (int c = 1; c < CPL; ++c) {
    if (bv[c] > v || (bv[c] == v && br[c] < rr)) {
      v = bv[c];
      rr = br[c];
      jj = j0 + c;
      nn = bn[c];
    }
  }
  const int vmax = __reduce_max_sync(kFull, v);
  const int rmin = __reduce_min_sync(kFull, v == vmax ? rr : INT_MAX);
  const bool cand = v == vmax && rr == rmin;
  const int jmin = __reduce_min_sync(kFull, cand ? jj : INT_MAX);
  if (cand && jj == jmin) {
    if constexpr (PAYLOAD) {
      out[b] = vmax;
      out[B + b] = rmin;
      out[2 * B + b] = jmin;
    } else {
      int* o = out + (size_t)b * 4;
      o[0] = vmax;
      o[1] = rmin;
      o[2] = vmax > 0 ? lob[rmin] + jmin + 1 : 0;
      o[3] = nn;
    }
  }
}

template <int CPL>
void launch(bool payload_mode, dim3 grid, cudaStream_t stream, const int* q,
            const int* t, const int* lo, const int* tlens, int B, int Lq, int Lt,
            int band, Scoring sc, int* out, unsigned char* payload) {
  if (payload_mode) {
    sw_forward_kernel<CPL, true><<<grid, kThreads, kWarps * stage_stride(band), stream>>>(
        q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  } else {
    sw_forward_kernel<CPL, false><<<grid, kThreads, 0, stream>>>(
        q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  }
}

}  // namespace

// Launches kernel 1 on `stream` over B pairs.  All pointers are device
// pointers to contiguous int32 tensors (payload: uint8):
//   q (B, Lq), t (B, Lt), lo (B, Lq+1), tlens (B,);
//   NM mode: out (B, 4); payload mode: out (3, B) and payload (B, Lq, band).
// The cells per lane follow from the band: 1 up to band 32, 2 up to 64, 4 up
// to 128, 8 up to 256.  Allocates nothing and does not synchronise.  Returns
// cudaGetLastError().
extern "C" int sw_forward_launch(const int* q, const int* t, const int* lo,
                                 const int* tlens, int B, int Lq, int Lt, int band,
                                 int match, int mismatch, int gap_open, int gap_ext,
                                 int emit_payload, int* out, unsigned char* payload,
                                 void* stream) {
  if (B <= 0) return 0;
  if (band < 1 || band > 256 || Lq < 1 || Lt < 1) return (int)cudaErrorInvalidValue;
  const Scoring sc{match, mismatch, gap_open, gap_ext};
  const dim3 grid((B + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  const bool pm = emit_payload != 0;
  if (band <= 32) {
    launch<1>(pm, grid, s, q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  } else if (band <= 64) {
    launch<2>(pm, grid, s, q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  } else if (band <= 128) {
    launch<4>(pm, grid, s, q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  } else {
    launch<8>(pm, grid, s, q, t, lo, tlens, B, Lq, Lt, band, sc, out, payload);
  }
  return (int)cudaGetLastError();
}
