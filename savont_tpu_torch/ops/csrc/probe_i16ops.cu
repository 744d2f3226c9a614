// 16-bit SIMD-in-a-word probe, for sm_90a: what the int16 operations of a
// two-values-per-register kernel 1 cost on Hopper.
//
// Replaces the six Pallas bodies of scripts/pallas_probe_i16ops.py:21 `run`
// (bodies :44-49), each int16 (64, 128) x, y -> int32 (64, 128), and adds a
// seventh for the DPX three-input form kernel 1's max/add chain would use:
//   op 0 max     signed max                         __vmaxs2
//   op 1 lt      x < y as 0 / 1                     __vsetlts2
//   op 2 eq      x == y as 0 / 1                    __vseteq2
//   op 3 select  where(x < y, x, y)                 __vcmplts2 mask, and / or
//   op 4 sra15   (x - y) >> 15, arithmetic, on the wrapping difference
//                                                   __vsub2, then its sign
//                                                   mask (__vcmplts2 with 0)
//   op 5 bitsel  m = (y - x - 1) >> 15; (m & x) | (~m & y)
//   op 6 dpx     max(x + y, z)                      __viaddmax_s16x2
// Two neighbouring int16 values of a row are one 32-bit word, and the two
// results are written sign-extended to int32, as the TPU probe widens them.
//
// The element pass (iters == 0, exactly the TPU body) reads 16 bytes of x
// and of y (and of z for dpx) per thread, eight values in four words, and
// writes two 16-byte vectors of int32.  Words past the last whole vector,
// and tensors whose storage is not aligned to 16 bytes, go through the
// word-wise kernel, one word per thread, in the same launch function.
//
// With iters > 0 the word-wise kernel is a timed chain, built like
// roofline.cu's, one dependent chain per thread:
//   r = op(x, y, z);  repeat iters times:  y = y + r (mod 2^16);  r = op(r, y, z)
// The count is a kernel argument and r is stored, so nothing folds.  `python -m
// savont_tpu_torch.probes.i16ops --sass DIR` counts the instructions of the
// loop, which says whether an op is one instruction or a sequence.
//
// What bounds it: at iters == 0 bytes (per element 4 in, 6 for dpx, and 4 out),
// which is why the element pass moves 16 bytes per access; in the timed
// chain the SMs' instruction rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOps = 7;

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b, uint32_t c) {
  if (OP == 0) return __vmaxs2(a, b);
  if (OP == 1) return __vsetlts2(a, b);
  if (OP == 2) return __vseteq2(a, b);
  if (OP == 3) {
    const uint32_t m = __vcmplts2(a, b);
    return (a & m) | (b & ~m);
  }
  if (OP == 4) return __vcmplts2(__vsub2(a, b), 0u);
  if (OP == 5) {
    const uint32_t m = __vcmplts2(__vsub2(__vsub2(b, a), 0x00010001u), 0u);
    return (m & a) | (~m & b);
  }
  return __viaddmax_s16x2(a, b, c);
}

template <int OP>
__global__ void __launch_bounds__(1024, 2)
probe_i16_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ z, int2* __restrict__ out, int n_words,
                 int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  uint32_t yy = y[i];
  const uint32_t zz = OP == 6 ? z[i] : 0u;
  uint32_t r = apply<OP>(x[i], yy, zz);
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
    yy = __vadd2(yy, r);
    r = apply<OP>(r, yy, zz);
  }
  out[i] = make_int2((int)(int16_t)(r & 0xffffu), (int)(int16_t)(r >> 16));
}

__device__ __forceinline__ int4 widen(uint32_t a, uint32_t b) {
  return make_int4((int)(int16_t)(a & 0xffffu), (int)(int16_t)(a >> 16),
                   (int)(int16_t)(b & 0xffffu), (int)(int16_t)(b >> 16));
}

// The element pass: one 16-byte vector of x, y (and z) per thread.
template <int OP>
__global__ void __launch_bounds__(1024)
probe_i16_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                     const uint4* __restrict__ z, int4* __restrict__ out, int n_vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const uint4 a = x[i];
  const uint4 b = y[i];
  const uint4 c = OP == 6 ? z[i] : make_uint4(0u, 0u, 0u, 0u);
  out[2 * i] = widen(apply<OP>(a.x, b.x, c.x), apply<OP>(a.y, b.y, c.y));
  out[2 * i + 1] = widen(apply<OP>(a.z, b.z, c.z), apply<OP>(a.w, b.w, c.w));
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Launches op `op` (0..6, see above) on `stream` over n int16 elements (n
// even): x, y, z int16 vectors of n (z is read only by op 6), out int32 of n,
// contiguous device tensors, x, y, z aligned to 4 bytes and out to 8;
// `threads` per block.  With iters == 0 and storage aligned to 16 bytes the
// whole 16-byte vectors take the element pass and only the words after them
// the word-wise kernel; otherwise every word takes the word-wise kernel.
// Allocates nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int probe_i16ops_launch(int op, const void* x, const void* y, const void* z,
                                   int* out, int n, int iters, int threads, void* stream) {
  if (n <= 0) return 0;
  if (op < 0 || op >= kOps || (n & 1) || iters < 0 || threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = iters == 0 && aligned16(x) && aligned16(y) && aligned16(z) && aligned16(out);
  const int n_vec = wide ? n / 8 : 0;
  const int n_words = n / 2 - 4 * n_vec;  // what the word-wise kernel takes
  const dim3 vgrid((n_vec + threads - 1) / threads);
  const dim3 grid((n_words + threads - 1) / threads);
  const uint32_t* xw = (const uint32_t*)x + 4 * n_vec;
  const uint32_t* yw = (const uint32_t*)y + 4 * n_vec;
  const uint32_t* zw = (const uint32_t*)z + 4 * n_vec;
  int2* ow = (int2*)out + 4 * n_vec;
#define LAUNCH(OP)                                                                     \
  if (n_vec > 0)                                                                       \
    probe_i16_vec_kernel<OP><<<vgrid, threads, 0, s>>>(                                \
        (const uint4*)x, (const uint4*)y, (const uint4*)z, (int4*)out, n_vec);         \
  if (n_words > 0)                                                                     \
    probe_i16_kernel<OP><<<grid, threads, 0, s>>>(xw, yw, zw, ow, n_words, iters)
  switch (op) {
    case 0: LAUNCH(0); break;
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    case 5: LAUNCH(5); break;
    default: LAUNCH(6); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
