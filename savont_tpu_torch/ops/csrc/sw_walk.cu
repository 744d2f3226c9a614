// Kernel 2: traceback walk + CIGAR run-length encoding, one thread per pair,
// for sm_90a.
//
// Replaces the XLA walk state machine savont_tpu/ops/align_jax.py:_walk_ops
// and the run-length encoding of sw_traceback_from_payload (the device half
// of align_pallas.sw_traceback_pallas_jobs).  Each thread starts at its
// pair's best cell (ri, bj) in state H and replays the host traceback
// (ops/align.py _traceback) from the payload bytes of kernel 1: H goes to G
// (use_g) or E; G stops on g_zero, goes to F on g_f, else steps diagonally;
// E steps left and exits to G on exitE when j-1 >= 0; F steps up and exits
// to H on from_h when the up lane j+dl is inside the band.  The walk stops
// at r <= 0, j < 0, j >= band or after ops_max ops.  Runs are collected
// backward, then reversed in place, packed as (len << 4) | op (0 match /
// mismatch, 1 insertion, 2 deletion).  n_runs may exceed maxrun: the pair
// then overflowed, its CIGAR row is all zeros and the caller re-runs it on
// the host.  The TPU's K-row payload window (a gather workaround) is not
// needed: a thread reads its own payload bytes directly.
//
// What bounds it on the H100: the dependent chain of one payload-byte load
// per step (a scattered 1-byte read, latency-bound) over a path of about
// Lq + indels steps.  This simple design does nothing about it yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int ST_H = 0, ST_G = 1, ST_E = 2, ST_F = 3;

__global__ void __launch_bounds__(kThreads)
sw_walk_kernel(const uint8_t* __restrict__ payload, const int* __restrict__ lo,
               const int* __restrict__ score, const int* __restrict__ ri,
               const int* __restrict__ bj, int B, int Lq, int band, int ops_max,
               int maxrun, int* __restrict__ cigar, int* __restrict__ meta) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* pb = payload + (size_t)b * Lq * band;
  const int* lob = lo + (size_t)b * (Lq + 1);
  int* cg = cigar + (size_t)b * maxrun;

  const int r0 = ri[b], j0 = bj[b];
  int r = r0, j = j0, st = ST_H;
  int cnt = 0, nm = 0, nins = 0, ndel = 0;
  int n_runs = 0, run_op = -1, run_len = 0;
  bool done = score[b] <= 0;
  while (!done) {
    const int p = pb[(size_t)(r - 1) * band + j];
    const int dl = lob[r] - lob[r - 1];
    const int st1 = st == ST_H ? ((p & 1) ? ST_G : ST_E) : st;
    if (st1 == ST_G && (p & 2)) break;  // G == 0: the local alignment starts here
    const int st2 = (st1 == ST_G && (p & 4)) ? ST_F : st1;
    const int op = st2 == ST_G ? 0 : (st2 == ST_F ? 1 : 2);
    if (op == run_op) {
      ++run_len;
    } else {
      if (run_len > 0) {
        if (n_runs < maxrun) cg[n_runs] = (run_len << 4) | run_op;
        ++n_runs;
      }
      run_op = op;
      run_len = 1;
    }
    nm += op == 0 ? ((p >> 5) & 1) : 1;
    nins += op == 1;
    ndel += op == 2;
    ++cnt;

    const int up = j + dl;
    if (op == 0) {
      r -= 1;
      j = up - 1;
      st = ST_H;
    } else if (op == 1) {
      r -= 1;
      j = up;
      st = ((p & 16) && up < band) ? ST_H : ST_F;
    } else {
      st = ((p & 8) && j - 1 >= 0) ? ST_G : ST_E;
      j -= 1;
    }
    done = r <= 0 || j < 0 || j >= band || cnt >= ops_max;
  }
  if (run_len > 0) {
    if (n_runs < maxrun) cg[n_runs] = (run_len << 4) | run_op;
    ++n_runs;
  }
  if (n_runs <= maxrun) {
    for (int a = 0, z = n_runs - 1; a < z; ++a, --z) {
      const int tmp = cg[a];
      cg[a] = cg[z];
      cg[z] = tmp;
    }
    for (int k = n_runs; k < maxrun; ++k) cg[k] = 0;
  } else {
    for (int k = 0; k < maxrun; ++k) cg[k] = 0;
  }

  const int t_end = lob[min(max(r0, 0), Lq)] + j0 + 1;
  int* m = meta + (size_t)b * 6;
  m[0] = n_runs;
  m[1] = r0 - (cnt - ndel);  // q_start
  m[2] = r0;                 // q_end
  m[3] = t_end - (cnt - nins);
  m[4] = t_end;
  m[5] = nm;
}

}  // namespace

// Launches kernel 2 on `stream` over B pairs.  Device pointers to contiguous
// tensors: payload (B, Lq, band) uint8, lo (B, Lq+1) int32, score / ri / bj
// (B,) int32; outputs cigar (B, maxrun) int32 holding the packed u32 runs and
// meta (B, 6) int32: n_runs, q_start, q_end, t_start, t_end, nm.
// Allocates nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int sw_walk_launch(const unsigned char* payload, const int* lo,
                              const int* score, const int* ri, const int* bj, int B,
                              int Lq, int band, int ops_max, int maxrun, int* cigar,
                              int* meta, void* stream) {
  if (B <= 0) return 0;
  if (band < 1 || Lq < 1 || maxrun < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kThreads - 1) / kThreads);
  sw_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      payload, lo, score, ri, bj, B, Lq, band, ops_max, maxrun, cigar, meta);
  return (int)cudaGetLastError();
}
