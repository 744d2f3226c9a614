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
// The (64, 128) tile of the TPU probe is one of `tiles` independent tiles, so
// the same kernel fills the card for a timed run.
//
// What bounds it: bytes (16 KB in, 48 KB out per tile; a handful of integer
// instructions per word).  So the lanes lie along the columns and the word
// rows along a loop: a thread owns a strip of 8 columns, 16 bytes of a row,
// and kRowsPerThread consecutive word rows of it; 16 neighbouring lanes
// cover a 256-byte row, so every load and store of a warp is whole rows in
// 16-byte vectors.  A thread loads rows 2m and 2m+1 as two vectors and zips
// them into 8 words (byte permutes), keeps the word row before as
// roll(w, 1) in registers (the one before its first, with the wrap-around,
// is loaded up front), forms A by one __funnelshift_l and B by one
// __byte_perm per word, unzips and stores six vectors per word row.  The
// two formulas are written per word as the probe states them, not as the row
// permutations they happen to equal: what they compile to is what the probe
// shows (python -m savont_tpu_torch.probes.bitcast --sass DIR).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                                // int16 rows of a tile
constexpr int kCols = 128;                               // columns of a tile
constexpr int kWordRows = kRows / 2;
constexpr int kStrip = 8;                                // columns per thread: one 16-byte vector
constexpr int kStrips = kCols / kStrip;                  // vectors per row
constexpr int kRowsPerThread = 4;                        // word rows per thread
constexpr int kGroups = kWordRows / kRowsPerThread;
constexpr int kThreadsPerTile = kStrips * kGroups;
constexpr int kTilesPerBlock = 2;

// Rows 2m (low halves) and 2m+1 (high halves) of a strip -> its 8 words.
__device__ __forceinline__ void zip(const uint4& lo, const uint4& hi, uint32_t (&w)[kStrip]) {
  w[0] = __byte_perm(lo.x, hi.x, 0x5410);
  w[1] = __byte_perm(lo.x, hi.x, 0x7632);
  w[2] = __byte_perm(lo.y, hi.y, 0x5410);
  w[3] = __byte_perm(lo.y, hi.y, 0x7632);
  w[4] = __byte_perm(lo.z, hi.z, 0x5410);
  w[5] = __byte_perm(lo.z, hi.z, 0x7632);
  w[6] = __byte_perm(lo.w, hi.w, 0x5410);
  w[7] = __byte_perm(lo.w, hi.w, 0x7632);
}

// A strip's 8 words -> rows 2m and 2m+1 of an output block, one vector each.
__device__ __forceinline__ void unzip_store(const uint32_t (&w)[kStrip], uint4* even, uint4* odd) {
  *even = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                     __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
  *odd = make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                    __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
}

__global__ void __launch_bounds__(kThreadsPerTile * kTilesPerBlock)
probe_bitcast_kernel(const int16_t* __restrict__ x, int16_t* __restrict__ out, int tiles) {
  const int strip = threadIdx.x % kStrips;
  const int group = threadIdx.x / kStrips % kGroups;
  const int tile = blockIdx.x * kTilesPerBlock + threadIdx.x / kThreadsPerTile;
  if (tile >= tiles) return;
  // row r of the strip is xt[r * kStrips]; block k, row r of the output ot[(k * kRows + r) * kStrips]
  const uint4* xt = reinterpret_cast<const uint4*>(x + (size_t)tile * kRows * kCols) + strip;
  uint4* ot = reinterpret_cast<uint4*>(out + (size_t)tile * 3 * kRows * kCols) + strip;

  // every row this thread reads, loaded before anything is stored: the word
  // row before its first (word row 31 for the first group) and its own
  const int m0 = group * kRowsPerThread;
  uint4 rows[2 * (kRowsPerThread + 1)];
#pragma unroll
  for (int i = 0; i <= kRowsPerThread; ++i) {
    const int m = (m0 + i - 1) & (kWordRows - 1);
    rows[2 * i] = xt[(2 * m) * kStrips];
    rows[2 * i + 1] = xt[(2 * m + 1) * kStrips];
  }

  uint32_t wr[kStrip], w[kStrip], ya[kStrip], yb[kStrip];  // wr = roll(w, 1) over word rows
  zip(rows[0], rows[1], wr);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + i;
    zip(rows[2 * i + 2], rows[2 * i + 3], w);
#pragma unroll
    for (int c = 0; c < kStrip; ++c) {
      ya[c] = __funnelshift_l(wr[c], w[c], 16);   // (w << 16) | (wr >> 16)
      yb[c] = __byte_perm(w[c], wr[c], 0x5432);   // (w >> 16) | (wr << 16)
    }
    unzip_store(wr, ot + (0 * kRows + 2 * m) * kStrips, ot + (0 * kRows + 2 * m + 1) * kStrips);
    unzip_store(ya, ot + (1 * kRows + 2 * m) * kStrips, ot + (1 * kRows + 2 * m + 1) * kStrips);
    unzip_store(yb, ot + (2 * kRows + 2 * m) * kStrips, ot + (2 * kRows + 2 * m + 1) * kStrips);
#pragma unroll
    for (int c = 0; c < kStrip; ++c) wr[c] = w[c];
  }
}

}  // namespace

// Launches the probe on `stream` over `tiles` tiles: x (tiles, 64, 128) int16,
// out (tiles, 192, 128) int16, contiguous device tensors whose storage is
// 16-byte aligned (cudaErrorInvalidValue otherwise).  Allocates nothing and
// does not synchronise.  Returns cudaGetLastError().
extern "C" int probe_bitcast_launch(const int16_t* x, int16_t* out, int tiles, void* stream) {
  if (tiles <= 0) return 0;
  if (((uintptr_t)x | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  const dim3 grid((tiles + kTilesPerBlock - 1) / kTilesPerBlock);
  probe_bitcast_kernel<<<grid, kThreadsPerTile * kTilesPerBlock, 0, (cudaStream_t)stream>>>(
      x, out, tiles);
  return (int)cudaGetLastError();
}
