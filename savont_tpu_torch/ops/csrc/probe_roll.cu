// Row-rotate probe, for sm_90a: what kernel 1 pays to move its band by one
// cell per DP row, measured in kernel 1's own layout.
//
// Replaces the Pallas bodies of scripts/pallas_probe_roll.py:24 `mk` (modes
// add / roll / concat): an int32 (64, 128) tile and `steps` dependent steps
// of x = roll(x, 1, axis 0) + 1 (or x = x + 1 for `add`), so every mode that
// rolls returns roll(x, steps % 64, 0) + steps and `add` returns x + steps.
// The TPU probe's tile is one of `tiles` independent tiles: one tile checks
// equality, many fill the card for the timed runs.
//
// Layout, kernel 1's (sw_forward.cu: lane L holds CPL consecutive band
// cells): a thread holds K consecutive rows of one column in registers,
// indexed only by unrolled constants; K = 2 and 4 are kernel 1's CPL at band
// 48 and 128, K = 8 the widest.  A column's 64 rows span a segment of 64/K
// lanes, a warp holds K/2 columns.  A step is r[j] = r[j-1] + 1 for
// j = K-1 .. 1 and r[0] = edge + 1, where edge is r[K-1] of the segment's
// lane below (lane 0 takes the last lane's: the wrap from row 63 to row 0 is
// the rotate inside the segment, so no select).  The register move costs
// nothing: the rows' registers are renamed by one each step instead (see
// `step`), which repeats every K steps, so a loop trip is kTrip = 8 steps.
//   mode 0 add   the baseline: r[j] = r[j] + 1, the same layout;
//   mode 1 shfl  edge is one __shfl_sync over the segment: one shuffle per K
//                elements per step;
//   mode 2 smem  edge goes through shared memory: a warp-private slot per
//                lane, one store and one load per K elements, __syncwarp
//                between them, two slot sets in turn so that one barrier a
//                step suffices.  The Hopper counterpart of the TPU "concat"
//                body: slice and concat of a register-resident tile is a
//                renaming plus one edge value.
//
// The chain runs as written, one instruction per element per step.  Written
// as x + 1, ptxas folds the adds of unrolled steps into one (x + 2, ...); a
// trip of one step pays for the loop's counter and for register moves; and
// every + 1 is then a VIADD, on the integer ALU alone, at half the dispatch
// rate.  So + 1 is IMAD x * one + one or VIADDMNMX max(x + one, lo), with
// one == 1 and lo == INT_MIN passed at launch: no compiler can merge two of
// them without knowing those values.  IMAD runs on the FMA pipe, VIADDMNMX
// on the integer ALU, each at half the dispatch rate; half the registers
// take each, so together they can reach it.  An empty asm statement on
// every register each step keeps NVVM from merging steps too.  python -m
// savont_tpu_torch.probes.roll --sass DIR counts each trip's instructions.
//
// What bounds it: the N one-instruction steps per element at the card's
// dispatch rate; a register-resident roll moves no data, so the rolls add
// nothing to the bound.  Beside it (probes/roll.py `floors`): the shuffle
// pipe (shfl), the shared-memory bandwidth (smem) and the issue of each
// trip's instructions.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;
constexpr int kCols = 128;
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kTrip = 8;       // steps a loop trip: a multiple of every K
enum { kAdd = 0, kShfl = 1, kSmem = 2 };

// One step of the chain, u = t % kTrip (a constant once unrolled).  After t
// steps R[p] holds row seg*K + (p + t) % K (add: row seg*K + p), so step t
// is in place: every register takes its own + 1, except R[e],
// e = (-t-1) mod K, which holds row K-1: it goes to the segment's lane above
// and takes edge + 1, the row K-1 of the lane below.  `wslot` and `rslot`
// are this lane's slot and the lane below's in the first of the two sets.
template <int K, int MODE>
__device__ __forceinline__ void step(int (&R)[K], int u, int src, int* wslot,
                                     const int* rslot, int one, int lo) {
  const int e = K - 1 - u % K;
  int edge = 0;
  if constexpr (MODE == kShfl) {
    edge = __shfl_sync(0xffffffffu, R[e], src, kRows / K);
  } else if constexpr (MODE == kSmem) {
    wslot[(u & 1) * kThreads] = R[e];
    __syncwarp();
    edge = rslot[(u & 1) * kThreads];
  }
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const int v = MODE != kAdd && p == e ? edge : R[p];
    // + 1 as one instruction that no compiler can merge with the next step's,
    // as one == 1 and lo == INT_MIN are not known to it: IMAD on the FMA pipe
    // for even p, VIADDMNMX (max(v + one, lo)) on the integer ALU for odd p
    if (p % 2 == 0) {
      asm("mad.lo.s32 %0, %1, %2, %2;" : "=r"(R[p]) : "r"(v), "r"(one));
    } else {
      R[p] = __viaddmax_s32(v, one, lo);
    }
    asm volatile("" : "+r"(R[p]));
  }
}

template <int K, int MODE>
__global__ void __launch_bounds__(kThreads)
probe_roll_kernel(const int* __restrict__ x, int* __restrict__ out, int tiles, int steps,
                  int one, int lo) {
  constexpr int kSeg = kRows / K;  // lanes a column spans
  constexpr int kColsPerBlock = kThreads / kSeg;
  __shared__ int slot[2][kThreads];  // smem mode: the edge values, two sets
  const int seg = threadIdx.x % kSeg;
  const int col_all = blockIdx.x * kColsPerBlock + threadIdx.x / kSeg;
  const int tile = col_all / kCols, col = col_all % kCols;
  if (tile >= tiles) return;  // uniform over the block: 128 % kColsPerBlock == 0
  const size_t at = (size_t)tile * kRows * kCols + (size_t)seg * K * kCols + col;
  const int src = (seg + kSeg - 1) % kSeg;  // the lane below, within the segment
  int* wslot = &slot[0][threadIdx.x];
  const int* rslot = &slot[0][threadIdx.x - seg + src];
  int R[K];
#pragma unroll
  for (int p = 0; p < K; ++p) R[p] = x[at + (size_t)p * kCols];
#pragma unroll 1
  for (int q = steps / kTrip; q > 0; --q) {
#pragma unroll
    for (int u = 0; u < kTrip; ++u) step<K, MODE>(R, u, src, wslot, rslot, one, lo);
  }
  const int rem = steps % kTrip;
#pragma unroll
  for (int u = 0; u < kTrip - 1; ++u) {
    if (u < rem) step<K, MODE>(R, u, src, wslot, rslot, one, lo);
  }
  const int shift = MODE == kAdd ? 0 : rem % K;  // steps % K, as K divides kTrip
#pragma unroll
  for (int p = 0; p < K; ++p) out[at + (size_t)((p + shift) % K) * kCols] = R[p];
}

template <int K>
void launch(int mode, const int* x, int* out, int tiles, int steps, cudaStream_t s) {
  const int grid = tiles * (kCols / (kThreads / (kRows / K)));
  const int one = 1, lo = INT_MIN;
  if (mode == kAdd) {
    probe_roll_kernel<K, kAdd><<<grid, kThreads, 0, s>>>(x, out, tiles, steps, one, lo);
  } else if (mode == kShfl) {
    probe_roll_kernel<K, kShfl><<<grid, kThreads, 0, s>>>(x, out, tiles, steps, one, lo);
  } else {
    probe_roll_kernel<K, kSmem><<<grid, kThreads, 0, s>>>(x, out, tiles, steps, one, lo);
  }
}

}  // namespace

// Launches mode `mode` (0 add, 1 shfl, 2 smem) with K = `k` rows a thread
// (2, 4 or 8) on `stream`: x and out are contiguous (tiles, 64, 128) int32
// device tensors.  Allocates nothing and does not synchronise.  Returns
// cudaGetLastError().
extern "C" int probe_roll_launch(int mode, int k, const int* x, int* out, int tiles, int steps,
                                 void* stream) {
  if (mode < 0 || mode > 2 || steps < 0 || (k != 2 && k != 4 && k != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 2) {
    launch<2>(mode, x, out, tiles, steps, s);
  } else if (k == 4) {
    launch<4>(mode, x, out, tiles, steps, s);
  } else {
    launch<8>(mode, x, out, tiles, steps, s);
  }
  return (int)cudaGetLastError();
}
