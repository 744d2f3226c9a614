// SINTAX scores for sm_90a (kernel 3): per (ASV, iteration) pair, the best
// reference key over a chunk of reference rows, max'ed into an accumulator.
//
// Replaces the XLA step savont_tpu/parallel/mesh.py:952
// sharded_sintax_scores (per_shard :977), the JAX package's device route of
// `sintax`.  For pair p and row r, score = how many of p's 32 subsampled
// 12-mers occur in row r (a slot that repeats counts each time), and
//   key = (score << 26) | (0x3FFFFFF - ridx[r])   if score > 0, else 0,
// an unsigned 32-bit value (a score of 32 sets bit 31).  acc[p] becomes
// max(acc[p], max_r key): a larger score wins and equal scores keep the
// earliest reference, the host stream's rule, in any order of rows, blocks
// and chunks.
//
// Inputs, the host stream's CSR form (ops/sintax_torch.py query_index):
//   keys (D,) int32   the sorted distinct query k-mers of the run's live slots
//   off (D+1,) int32  CSR offsets into pairs
//   pairs (M,) int32  one pair id per live slot (duplicates kept), ascending
//                     within a key
//   kmers (N,) int32  the chunk's reference rows back to back, each row's
//                     unique k-mers (below 2^24), then ROW_PAD (0x7FFFFFFF,
//                     a miss) to the row's capacity (kernel 6's rows,
//                     sintax_ref_kmers.cu); row_off (R+1,) int64
//   ridx (R,) int32   each row's ordinal among the kept references (< 2^26)
//
// What bounds it: bytes.  The function reads the rows once (at the
// classification cell's first chunk 5.9 M k-mers, 23.6 MB: 0.0071 ms at
// 3.35 TB/s); an exact lookup structure (a hash of the query k-mers) needs
// one probe per k-mer and one count increment per hit-list entry (17.9 M),
// which shared memory serves in less.  This design's own count is higher:
// each k-mer binary-searched among the D query k-mers, ceil(log2 D)
// dependent loads (13 at D = 7,340: 76.6 M), plus the increments.  On the
// card the kernel is bound by latency: the dependent search steps, the hit
// lists' loads from L2 and the shared-memory increments, so it wants as
// many warps an SM as it can get.  The design:
// - persistent blocks of 256 threads, as many as fit an SM, walk the rows
//   (r = blockIdx.x, + gridDim.x, ...);
// - at most kSmemKeys query keys sit in shared memory, staged once per
//   block (16 KB, so that 8 blocks fit an SM): with D above that, every
//   S-th key (S the least power of two that fits) and the last log2 S steps
//   of a search read the keys from L2 (all of D = 41,613 keys in a block
//   would leave one block an SM, too few warps to hide the loads);
// - a row's k-mers are read coalesced, 4 per thread searched in lockstep
//   (independent loads in flight); neighbouring lanes hold neighbouring
//   k-mers of the sorted row, so the first steps of a warp's searches are
//   broadcasts;
// - each hit walks its pair range and adds 1 to the pair's byte in shared
//   memory (4 counts to a word: a score of at most 32 never carries).  A
//   lane walks up to kWalkCap entries of its own hit; the rest of a longer
//   range (a k-mer held by every pair) the warp walks together;
// - after the row, one barrier; each thread turns the counts of the 16
//   pairs it owns into keys, max'es them into registers and clears them.
//   The counts alternate between two buffers, so one barrier a row suffices;
// - at the end one atomicMax per pair with a key.  Shared-memory integer
//   atomics give the same counts in any order: the result is exact and
//   deterministic.
// Pairs come in tiles of kPairTile (blockIdx.y); a block of tile t walks
// only the entries of its own pairs, found by binary search in a hit's
// range when there is more than one tile.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;                                  // k-mers a thread searches in lockstep
constexpr int kWordsPerThread = 4;                       // count words a thread owns
constexpr int kPairTile = 4 * kWordsPerThread * kThreads;  // 4,096 pairs a block
constexpr int kTileWords = kPairTile / 4;
constexpr int kCountBytes = 2 * kTileWords * 4;          // two buffers of byte counts
constexpr int kWalkCap = 8;                              // entries a lane walks alone
constexpr int kSmemKeys = 4096;                          // query keys a block stages at most
constexpr uint32_t kOrdMask = 0x3FFFFFFu;
// counts and staged keys stay under the 48 KB a block gets without opting in
static_assert(kCountBytes + kSmemKeys * 4 <= 48 * 1024, "kernel 3's shared memory");

__device__ __forceinline__ int key_at(const int* __restrict__ keys, int D, int i) {
  return i < D ? __ldg(keys + i) : INT_MAX;
}

// first index in [lo, hi) whose pair id is >= p (pairs ascend within a key)
__device__ __forceinline__ int pair_bound(const int* __restrict__ pairs, int lo, int hi, int p) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(pairs + mid) < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void bump(unsigned* cnt, int q) {
  atomicAdd(cnt + (q >> 2), 1u << ((q & 3) << 3));
}

__global__ void __launch_bounds__(kThreads)
sintax_rows_kernel(const int* __restrict__ keys, int D, const int* __restrict__ off,
                   const int* __restrict__ pairs, int P, const int* __restrict__ kmers,
                   const long long* __restrict__ row_off, const int* __restrict__ ridx, int R,
                   int log2s, int C, unsigned* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* cnt = reinterpret_cast<unsigned*>(smem);
  int* samp = reinterpret_cast<int*>(smem + kCountBytes);
  const int tid = threadIdx.x, lane = tid & 31;
  const int tiles = (P + kPairTile - 1) / kPairTile;
  const bool whole = tiles == 1;  // every entry of a hit range is this block's

  for (int i = tid; i < 2 * kTileWords; i += kThreads) cnt[i] = 0;
  for (int i = tid; i < C; i += kThreads) samp[i] = __ldg(keys + ((size_t)i << log2s));
  __syncthreads();

  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int p0 = tile * kPairTile;
    const int tile_words = (min(kPairTile, P - p0) + 3) >> 2;
    unsigned best[4 * kWordsPerThread];
#pragma unroll
    for (int i = 0; i < 4 * kWordsPerThread; i++) best[i] = 0;
    int buf = 0;
    for (int r = blockIdx.x; r < R; r += gridDim.x) {
      unsigned* c = cnt + buf * kTileWords;
      const long long b0 = row_off[r], n = row_off[r + 1] - b0;
      const int* row = kmers + b0;
      const unsigned ordk = kOrdMask - ((unsigned)__ldg(ridx + r) & kOrdMask);
      for (long long i0 = 0; i0 < n; i0 += kThreads * kIlp) {
        int x[kIlp], pos[kIlp];
#pragma unroll
        for (int j = 0; j < kIlp; j++) {
          const long long i = i0 + j * kThreads + tid;
          x[j] = i < n ? __ldg(row + i) : -1;  // -1: below every key, a miss
          pos[j] = 0;
        }
        // the last sample <= x, in lockstep (C is the same for every lane)
        for (int len = C; len > 1;) {
          const int half = len >> 1;
#pragma unroll
          for (int j = 0; j < kIlp; j++)
            pos[j] = samp[pos[j] + half] <= x[j] ? pos[j] + half : pos[j];
          len -= half;
        }
        int lo[kIlp], hi[kIlp];
        if (log2s == 0) {
#pragma unroll
          for (int j = 0; j < kIlp; j++) pos[j] = samp[pos[j]] == x[j] ? pos[j] : -1;
        } else {
          // the last log2 S steps in the keys themselves (L2); the sample is
          // keys[pos << log2s], so the bucket's first key is <= x unless the
          // search found none
#pragma unroll
          for (int j = 0; j < kIlp; j++) pos[j] <<= log2s;
          for (int len = 1 << log2s; len > 1;) {
            const int half = len >> 1;
#pragma unroll
            for (int j = 0; j < kIlp; j++)
              pos[j] = key_at(keys, D, pos[j] + half) <= x[j] ? pos[j] + half : pos[j];
            len -= half;
          }
#pragma unroll
          for (int j = 0; j < kIlp; j++) pos[j] = pos[j] < D && __ldg(keys + pos[j]) == x[j] ? pos[j] : -1;
        }
#pragma unroll
        for (int j = 0; j < kIlp; j++) {
          lo[j] = 0;
          hi[j] = 0;
          if (pos[j] >= 0) {
            lo[j] = __ldg(off + pos[j]);
            hi[j] = __ldg(off + pos[j] + 1);
            if (!whole) {
              lo[j] = pair_bound(pairs, lo[j], hi[j], p0);
              hi[j] = pair_bound(pairs, lo[j], hi[j], p0 + kPairTile);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kIlp; j++) {
          const int e = min(hi[j], lo[j] + kWalkCap);
          for (int t = lo[j]; t < e; t++) bump(c, __ldg(pairs + t) - p0);
          // what is left of the longer ranges, the warp together
          unsigned more = __ballot_sync(0xffffffffu, hi[j] > e);
          while (more) {
            const int src = __ffs(more) - 1;
            more &= more - 1;
            const int s = __shfl_sync(0xffffffffu, e, src), f = __shfl_sync(0xffffffffu, hi[j], src);
            for (int t = s + lane; t < f; t += 32) bump(c, __ldg(pairs + t) - p0);
          }
        }
      }
      __syncthreads();  // every count of row r is in c
#pragma unroll
      for (int w = 0; w < kWordsPerThread; w++) {
        const int word = tid + w * kThreads;
        if (word < tile_words) {
          const unsigned v = c[word];
          if (v) {
            c[word] = 0;
#pragma unroll
            for (int b = 0; b < 4; b++) {
              const unsigned s = (v >> (8 * b)) & 0xFFu;
              const unsigned key = s ? (s << 26) | ordk : 0u;
              best[4 * w + b] = key > best[4 * w + b] ? key : best[4 * w + b];
            }
          }
        }
      }
      buf ^= 1;  // the next row counts in the other buffer, which the
                 // barrier above found cleared
    }
#pragma unroll
    for (int w = 0; w < kWordsPerThread; w++) {
#pragma unroll
      for (int b = 0; b < 4; b++) {
        if (best[4 * w + b]) atomicMax(acc + p0 + 4 * (tid + w * kThreads) + b, best[4 * w + b]);
      }
    }
    // the next tile's rows count in the same buffers: wait for every scan
    __syncthreads();
  }
}

}  // namespace

// Launches kernel 3 on `stream`: acc[p] = max(acc[p], best key of pair p over
// the R rows).  Device pointers to contiguous tensors as the note at the top
// says; acc (P,) holds unsigned 32-bit keys.  Takes any D, P and row length;
// allocates nothing and does not synchronise.  Returns cudaGetLastError() (or
// the error of the occupancy call before it).
extern "C" int sintax_scores_launch(const int* keys, int D, const int* off, const int* pairs, int P,
                                    const int* kmers, const long long* row_off, const int* ridx,
                                    int R, unsigned* acc, void* stream) {
  if (P <= 0 || R <= 0 || D <= 0) return 0;  // no pair, no row or no live slot: no key
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int log2s = 0;
  while ((((long long)D + (1LL << log2s) - 1) >> log2s) > kSmemKeys) log2s++;
  const int C = (int)(((long long)D + (1LL << log2s) - 1) >> log2s);
  const size_t smem = kCountBytes + (size_t)C * sizeof(int);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sintax_rows_kernel,
                                                                  kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = ((long long)P + kPairTile - 1) / kPairTile;
  const int ty = tiles > 65535 ? 65535 : (int)tiles;
  long long groups = ((long long)sms * per_sm + ty - 1) / ty;
  groups = groups < 1 ? 1 : (groups > R ? R : groups);
  const dim3 grid((unsigned)groups, (unsigned)ty);
  sintax_rows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      keys, D, off, pairs, P, kmers, row_off, ridx, R, log2s, C, acc);
  return (int)cudaGetLastError();
}
