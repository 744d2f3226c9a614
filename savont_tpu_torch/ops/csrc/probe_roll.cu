// Row-rotate probe, for sm_90a: what a band-across-lanes kernel 1 would pay
// to move its band by one lane per DP row.
//
// Replaces the Pallas bodies of scripts/pallas_probe_roll.py:24 `mk` (modes
// add / roll / concat): an int32 (64, 128) tile and `steps` dependent steps
// of x = roll(x, 1, axis 0) + 1 (or x = x + 1 for `add`), so every mode that
// rolls returns roll(x, steps % 64, 0) + steps and `add` returns x + steps.
//   mode 0 add   the baseline: the add alone, same layout as shfl;
//   mode 1 shfl  the 64 rows of a column live in one warp, two registers per
//                lane (rows i and i + 32 in lane i): a roll is two
//                __shfl_sync rotates plus a swap of the two registers in
//                lane 0.  Two registers per lane and not two warps, because
//                a shuffle cannot cross warps: a band wider than 32 lanes
//                has to fold onto the lanes this way;
//   mode 2 smem  the other way to rotate on this card: one thread per
//                element, store to shared memory, __syncthreads, load the
//                row above (two buffers in turn, so one barrier per step).
// The steps are a kernel argument and an empty asm statement keeps x opaque
// inside the loop, so the compiler cannot replace the loop by x + steps.
// The TPU probe's tile is one of `tiles` independent tiles: one tile checks
// equality, many fill the card for the timed runs.
//
// What bounds it: the dependent chain, 1 add (+ 2 shuffles and 2 selects, or
// a shared-memory round trip and a barrier) per step; its 64 KB of traffic
// per tile do not matter.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;
constexpr int kCols = 128;
constexpr int kWarpsPerBlock = 8;   // add / shfl: one column per warp
constexpr int kSmemCols = 16;       // smem: 64 rows x 16 columns per block

__device__ __forceinline__ int inc(int v) { return (int)((uint32_t)v + 1u); }

template <bool ROLL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
probe_roll_warp(const int* __restrict__ x, int* __restrict__ out, int tiles, int steps) {
  const int lane = threadIdx.x;
  const int col_all = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  const int tile = col_all / kCols, col = col_all % kCols;
  if (tile >= tiles) return;
  const int* xt = x + (size_t)tile * kRows * kCols;
  int* ot = out + (size_t)tile * kRows * kCols;
  int a = xt[lane * kCols + col];          // row lane
  int b = xt[(lane + 32) * kCols + col];   // row lane + 32
  const int src = (lane - 1) & 31;
  for (int s = 0; s < steps; ++s) {
    if (ROLL) {
      const int ra = __shfl_sync(0xffffffffu, a, src);
      const int rb = __shfl_sync(0xffffffffu, b, src);
      a = inc(lane == 0 ? rb : ra);  // row 0 takes row 63, row i takes row i - 1
      b = inc(lane == 0 ? ra : rb);  // row 32 takes row 31
    } else {
      a = inc(a);
      b = inc(b);
    }
    asm volatile("" : "+r"(a), "+r"(b));
  }
  ot[lane * kCols + col] = a;
  ot[(lane + 32) * kCols + col] = b;
}

__global__ void __launch_bounds__(kRows * kSmemCols)
probe_roll_smem(const int* __restrict__ x, int* __restrict__ out, int tiles, int steps) {
  __shared__ int buf[2][kRows][kSmemCols];
  const int c = threadIdx.x, r = threadIdx.y;
  const int col_all = blockIdx.x * kSmemCols + c;
  const int tile = col_all / kCols, col = col_all % kCols;
  if (tile >= tiles) return;  // uniform over the block: 128 % kSmemCols == 0
  const size_t at = (size_t)tile * kRows * kCols + r * kCols + col;
  int v = x[at];
  const int up = (r - 1) & (kRows - 1);
  for (int s = 0; s < steps; ++s) {
    buf[s & 1][r][c] = v;
    __syncthreads();
    v = inc(buf[s & 1][up][c]);
    asm volatile("" : "+r"(v));
  }
  out[at] = v;
}

}  // namespace

// Launches mode `mode` (0 add, 1 shfl, 2 smem) on `stream`: x and out are
// contiguous (tiles, 64, 128) int32 device tensors.  Allocates nothing and
// does not synchronise.  Returns cudaGetLastError().
extern "C" int probe_roll_launch(int mode, const int* x, int* out, int tiles, int steps,
                                 void* stream) {
  if (tiles <= 0) return 0;
  if (mode < 0 || mode > 2 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 2) {
    const dim3 block(kSmemCols, kRows);
    probe_roll_smem<<<tiles * (kCols / kSmemCols), block, 0, s>>>(x, out, tiles, steps);
  } else {
    const dim3 block(32, kWarpsPerBlock);
    const dim3 grid(tiles * (kCols / kWarpsPerBlock));
    if (mode == 1) {
      probe_roll_warp<true><<<grid, block, 0, s>>>(x, out, tiles, steps);
    } else {
      probe_roll_warp<false><<<grid, block, 0, s>>>(x, out, tiles, steps);
    }
  }
  return (int)cudaGetLastError();
}
