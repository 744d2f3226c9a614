// int16x2 packing probe, for sm_90a: two rows of an int16 column packed in
// one 32-bit register, and a roll by one row done as a halfword funnel shift
// between a word and its neighbour word.  It is the register layout a faster
// kernel 1 would use (two band rows per register).
//
// Replaces the Pallas body scripts/pallas_probe_bitcast.py:24 `kernel`: an
// int16 (64, 128) tile viewed as (32, 128) int32 words, where the low half
// of word m is row 2m and the high half row 2m+1 (the pairing of
// savont_tpu/ops/align_pallas.py:60-81).  Output int16 (192, 128):
//   rows   0..63   the column rolled by 2 rows: the word column rolled by 1;
//   rows  64..127  formula A, (w << 16) | (roll(w, 1) >>> 16): with this
//                  pairing it is the column rolled by 1 row;
//   rows 128..191  formula B, (w >>> 16) | (roll(w, 1) << 16): the opposite
//                  pairing, which is not a roll by 1.
//
// One thread per (word row m, column): the 32 word rows of a column are the
// 32 lanes of a warp, so the neighbour word comes from __shfl_sync with the
// wrap-around lane (m - 1) & 31.  Formula A is one __funnelshift_l, formula B
// one __byte_perm.  The (64, 128) tile of the TPU probe is one of `tiles`
// independent tiles, so the same kernel fills the card for a timed run.
//
// What bounds it: bytes (16 KB in, 48 KB out per tile; three integer
// instructions and one shuffle per word).  A lane reads its two rows with a
// stride of one row between lanes, which is uncoalesced; at these sizes the
// probe does nothing about it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;    // int16 rows of a tile
constexpr int kCols = 128;   // columns of a tile
constexpr int kColsPerBlock = 8;

__global__ void __launch_bounds__(32 * kColsPerBlock)
probe_bitcast_kernel(const int16_t* __restrict__ x, int16_t* __restrict__ out, int tiles) {
  const int m = threadIdx.x;  // word row = lane
  const int col_all = blockIdx.x * kColsPerBlock + threadIdx.y;
  const int tile = col_all / kCols, col = col_all % kCols;
  if (tile >= tiles) return;
  const int16_t* xt = x + (size_t)tile * kRows * kCols;
  int16_t* ot = out + (size_t)tile * 3 * kRows * kCols;

  const uint32_t lo = (uint16_t)xt[(2 * m) * kCols + col];
  const uint32_t hi = (uint16_t)xt[(2 * m + 1) * kCols + col];
  const uint32_t w = (hi << 16) | lo;
  const uint32_t wr = __shfl_sync(0xffffffffu, w, (m - 1) & 31);  // roll(w, 1) over word rows
  const uint32_t ya = __funnelshift_l(wr, w, 16);   // (w << 16) | (wr >> 16)
  const uint32_t yb = __byte_perm(w, wr, 0x5432);   // (w >> 16) | (wr << 16)

  const uint32_t words[3] = {wr, ya, yb};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ot[(k * kRows + 2 * m) * kCols + col] = (int16_t)(words[k] & 0xffffu);
    ot[(k * kRows + 2 * m + 1) * kCols + col] = (int16_t)(words[k] >> 16);
  }
}

}  // namespace

// Launches the probe on `stream` over `tiles` tiles: x (tiles, 64, 128) int16,
// out (tiles, 192, 128) int16, contiguous device tensors.  Allocates nothing
// and does not synchronise.  Returns cudaGetLastError().
extern "C" int probe_bitcast_launch(const int16_t* x, int16_t* out, int tiles, void* stream) {
  if (tiles <= 0) return 0;
  const dim3 block(32, kColsPerBlock);
  const dim3 grid(tiles * (kCols / kColsPerBlock));
  probe_bitcast_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, tiles);
  return (int)cudaGetLastError();
}
