// SINTAX scores for sm_90a (kernel 3): per (ASV, iteration) pair, the best
// reference key over a chunk of reference rows, max'ed into an accumulator.
//
// Replaces the XLA step savont_tpu/parallel/mesh.py:952
// sharded_sintax_scores (per_shard :977), the JAX package's device route of
// `sintax`.  Inputs: queries (P, 32) int32, the 32 subsampled 12-mers of
// each pair (k-mers are below 2^24; a k-mer-less ASV's slots hold
// kQuerySentinel); refk (R, L) int32, each reference's sorted unique
// 12-mers padded with kRowPad past its last one; ridx (R,) int32, each
// row's ordinal among the kept references (below 2^26).  For pair p and row
// r, score = how many of p's 32 slots occur in row r (a slot that repeats
// counts each time), and
//   key = (score << 26) | (0x3FFFFFF - ridx[r])   if score > 0, else 0,
// an unsigned 32-bit value (a score of 32 sets bit 31).  acc[p] becomes
// max(acc[p], max_r key): a larger score wins and equal scores keep the
// earliest reference, the host stream's rule, in any order of rows, blocks
// and chunks.
//
// What bounds it: operations.  Each slot is a binary search of ceil(log2 L)
// dependent loads in its row, R * P * 32 searches a chunk; the data (the
// rows once, the queries once) is small beside that.  The design, a simple
// one: a block holds one reference row at a time in shared memory and its
// 256 threads take 256 pairs, one each, with the pair's 32 k-mers in
// registers.  A thread searches its 32 slots in lockstep (one step of all 32
// searches, then the next), so 32 independent shared-memory loads are in
// flight per step; every lane of a warp runs the same number of steps, since
// every search is over the same L.  It keeps its pair's best key over the
// block's rows in a register and issues one atomicMax per pair per block.
// Blocks are (row group, pair tile): rows r = blockIdx.x, + gridDim.x, ...
// A row longer than kSmemKmers is searched in global memory by the same
// kernel (the kSmem = false instance), never by another route.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 32;           // subsampled k-mers per pair (SINTAX_SUBSAMPLE)
constexpr int kThreads = 256;        // pairs per block
constexpr int kSmemKmers = 12288;    // a row in shared memory: 48 KB, no opt-in needed
constexpr int kBlocksPerSm = 4;
constexpr uint32_t kOrdMask = 0x3FFFFFFu;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
sintax_scores_kernel(const int* __restrict__ queries, int P, const int* __restrict__ refk,
                     const int* __restrict__ ridx, int R, int L, unsigned* __restrict__ acc) {
  extern __shared__ int s_row[];
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const bool live = p < P;
  int q[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; s++) q[s] = live ? queries[(size_t)p * kSlots + s] : 0;
  unsigned best = 0;
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const int* g_row = refk + (size_t)r * L;
    const int* row = g_row;
    if (kSmem) {
      __syncthreads();  // the previous row's searches are done
      for (int i = threadIdx.x; i < L; i += kThreads) s_row[i] = g_row[i];
      __syncthreads();
      row = s_row;
    }
    if (!live) continue;
    // lower_bound of every slot, in lockstep: the answer of slot s lies in
    // [base[s], base[s] + len] at every step
    int base[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; s++) base[s] = 0;
    int len = L;
    while (len > 1) {
      const int half = len >> 1;
#pragma unroll
      for (int s = 0; s < kSlots; s++) base[s] = row[base[s] + half] < q[s] ? base[s] + half : base[s];
      len -= half;
    }
    unsigned score = 0;
#pragma unroll
    for (int s = 0; s < kSlots; s++) {
      const int lb = base[s] + (row[base[s]] < q[s]);
      score += (lb < L && row[lb] == q[s]) ? 1u : 0u;
    }
    if (score > 0) {
      const unsigned key = (score << 26) | (kOrdMask - ((unsigned)ridx[r] & kOrdMask));
      best = key > best ? key : best;
    }
  }
  if (live && best > 0) atomicMax(acc + p, best);
}

}  // namespace

// Launches kernel 3 on `stream`: acc[p] = max(acc[p], best key of pair p over
// the R rows).  Device pointers to contiguous tensors: queries (P, 32) int32,
// refk (R, L) int32 (rows sorted ascending, padded with a value above every
// k-mer and every query slot), ridx (R,) int32, acc (P,) holding unsigned
// 32-bit keys.  Rows of up to 12,288 k-mers are staged in shared memory,
// longer ones searched in global memory.  Allocates nothing and does not
// synchronise.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int sintax_scores_launch(const int* queries, int P, const int* refk, const int* ridx,
                                    int R, int L, unsigned* acc, void* stream) {
  if (P <= 0 || R <= 0) return 0;
  const int tiles = (P + kThreads - 1) / kThreads;
  if (L < 1 || tiles > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int groups = (sms * kBlocksPerSm + tiles - 1) / tiles;
  groups = groups < 1 ? 1 : (groups > R ? R : groups);
  const dim3 grid(groups, tiles);
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= kSmemKmers) {
    sintax_scores_kernel<true><<<grid, kThreads, (size_t)L * sizeof(int), st>>>(
        queries, P, refk, ridx, R, L, acc);
  } else {
    sintax_scores_kernel<false><<<grid, kThreads, 0, st>>>(queries, P, refk, ridx, R, L, acc);
  }
  return (int)cudaGetLastError();
}

// The row length above which a row is searched in global memory.
extern "C" int sintax_smem_kmers() { return kSmemKmers; }
