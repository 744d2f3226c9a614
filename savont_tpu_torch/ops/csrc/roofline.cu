// Integer roofline probe of the card, for sm_90a: how many int32 max / add
// operations per second the SMs execute, the rate that bounds kernel 1.
//
// Replaces the three Pallas bodies of scripts/pallas_roofline.py:121 `build`
// (the JAX package's VPU peak probe on a (64, 128) int32 VMEM tile):
//   kind 0, peak   (`peak_kernel` :43)      a dependent chain per element,
//                  x = max(x, y); y = y + x, 16 ops per iteration;
//   kind 1, ilp    (`peak_ilp_kernel` :59)  4 independent chains per element
//                  (x + c, y ^ c for c = 0..3), the same 16 ops on each;
//   kind 2, swar   (`swar_kernel` :87)      two 16-bit halves per int32:
//                  x = max per unsigned half (__vmaxu2), y = y + x per half
//                  mod 2^16 (__vadd2), the TPU body's masked max and
//                  carry-isolated add, value for value.
// Each writes out = x + y (for ilp the wrapping sum over the chains).
//
// Each thread carries one element's chains in registers for a runtime count
// of iterations, so the compiler can neither fold nor shorten the chain;
// the outer loop is unrolled by 4 (`python -m savont_tpu_torch.probes.roofline
// --sass` counts the instructions per iteration).  Adds are done in uint32
// and maxima on the int32 values, so the results equal PyTorch's wrapping
// int32 arithmetic (signed overflow is undefined in C++).
//
// What bounds it: the SMs' instruction rate, nothing else (3 int32 words
// per element cross device memory).  The wrapper fills the card (every SM
// holds its full 2,048 resident threads) or one SM (one block).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInner = 16;  // source operations per iteration, as in the TPU probe
constexpr int kChains = 4;  // independent chains of the ilp body

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__global__ void __launch_bounds__(1024, 2)
roofline_peak(const int* __restrict__ x0, const int* __restrict__ y0,
              int* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = x0[i], y = y0[i];
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kInner / 2; ++k) {
      x = max(x, y);
      y = add_wrap(y, x);
    }
  }
  out[i] = add_wrap(x, y);
}

__global__ void __launch_bounds__(1024, 2)
roofline_ilp(const int* __restrict__ x0, const int* __restrict__ y0,
             int* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int xs[kChains], ys[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    xs[c] = add_wrap(x0[i], c);
    ys[c] = y0[i] ^ c;
  }
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kInner / 2; ++k) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) xs[c] = max(xs[c], ys[c]);
#pragma unroll
      for (int c = 0; c < kChains; ++c) ys[c] = add_wrap(ys[c], xs[c]);
    }
  }
  int acc = add_wrap(xs[0], ys[0]);
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc = add_wrap(add_wrap(acc, xs[c]), ys[c]);
  out[i] = acc;
}

__global__ void __launch_bounds__(1024, 2)
roofline_swar(const int* __restrict__ x0, const int* __restrict__ y0,
              int* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned x = (unsigned)x0[i], y = (unsigned)y0[i];
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kInner / 2; ++k) {
      x = __vmaxu2(x, y);
      y = __vadd2(y, x);
    }
  }
  out[i] = (int)(x + y);
}

}  // namespace

// Launches roofline body `kind` (0 peak, 1 ilp, 2 swar) on `stream` over n
// elements, `threads` per block (at most 1,024): x0 / y0 / out are device
// pointers to contiguous int32 vectors of n.  Allocates nothing and does not
// synchronise.  Returns cudaGetLastError().
extern "C" int roofline_launch(int kind, const int* x0, const int* y0, int* out, int n,
                               int iters, int threads, void* stream) {
  if (n <= 0) return 0;
  if (iters < 0 || threads < 32 || threads > 1024 || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) {
    roofline_peak<<<grid, threads, 0, s>>>(x0, y0, out, n, iters);
  } else if (kind == 1) {
    roofline_ilp<<<grid, threads, 0, s>>>(x0, y0, out, n, iters);
  } else {
    roofline_swar<<<grid, threads, 0, s>>>(x0, y0, out, n, iters);
  }
  return (int)cudaGetLastError();
}
