// Split k-mer extraction for sm_90a (kernel 4): per position of every read,
// the canonical split k-mer with its strand flag in bit 63, and its validity.
//
// Replaces savont_tpu/ops/kmers_jax.py:64 split_kmers_batch (XLA element-wise
// code on (hi, lo) uint32 planes of a batch padded to 256), the JAX package's
// stage-1 device extraction; its semantics are split_kmer_mid's
// (savont_tpu/ops/kmers.py:59, seeding.rs:975-1068).  For the k-mer at
// position p of a read, fwd packs bases p..p+k-1 with the first base most
// significant and rev is its reverse complement; the middle base (bits k-1
// and k of the 2k) is masked in the comparison only:
//   canonical = (fwd & ~(3 << (k-1))) < (rev & ~(3 << (k-1)))
//   key       = (canonical ? fwd : rev) | canonical << 63
//   valid     = the masked k-mers differ (a masked palindrome is dropped) and,
//               when the read has qualities that are not all equal,
//               phred[p + k/2] >= min_bq.
// Every position gets a key, valid or not.
//
// Inputs: codes (B,) uint8 2-bit codes of the reads back to back; phred (B,)
// uint8 beside them, or null (no gate); off (N+1,) int64 read offsets;
// out_off (N+1,) int64, read r's max(L - k + 1, 0) positions start at
// out_off[r].  Outputs: keys (n,) uint64, valid (n,) uint8.  k odd, <= 31.
//
// What bounds it: bytes.  The function reads 1 B of code and 1 B of phred a
// base and writes 9 B a position: at the 20,000-read cell (29 M positions,
// 1,450 bp a read) about 320 MB, 0.095 ms at 3.35 TB/s; its integer work,
// about 28 32-bit operations a position (two rolling 64-bit k-mers, two
// masks, a compare, a select, the flag and the gate), takes less.  The
// design keeps every global access coalesced and reads each base once:
// - one block a read (grid-stride over the reads), the read cut into tiles
//   of kTile positions; a tile's codes (kTile + k - 1 bases) and the
//   middle-base qualities of its positions are staged in shared memory;
// - each thread rolls both k-mers over a run of kRun consecutive positions
//   after a warm-up of k - 1 bases (two shifts and an or a base, not k);
// - results go to shared memory (64-bit words padded one in nine, so that
//   the threads' runs hit 32 distinct banks) and leave as coalesced stores;
// - the gate's "all qualities equal" is a block reduction over the read
//   (__syncthreads_or), as split_kmer_mid's (phred == phred[0]).all().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                        // consecutive positions a thread rolls over
constexpr int kTile = kThreads * kRun;         // positions a block stages at once
constexpr int kMaxK = 31;
constexpr int kTileBases = kTile + kMaxK - 1;
constexpr int kBlocksPerSm = 8;

// a 64-bit word's slot in shared memory: one pad a run of kRun, so that the
// 16 threads of a half-warp, kRun words apart, fall on distinct banks
__device__ __forceinline__ int slot(int i) { return i + i / kRun; }

__global__ void __launch_bounds__(kThreads) split_kmers_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ phred,
    const long long* __restrict__ off, const long long* __restrict__ out_off, int N, int k,
    int min_bq, unsigned long long* __restrict__ keys, uint8_t* __restrict__ valid) {
  __shared__ uint8_t s_codes[kTileBases];
  __shared__ uint8_t s_midq[kTile];
  __shared__ uint8_t s_valid[kTile];
  __shared__ unsigned long long s_keys[kTile + kTile / kRun];
  const int t = threadIdx.x;
  const unsigned long long kmask = (1ull << (2 * k)) - 1;
  const unsigned long long smask = ~(3ull << (k - 1));
  const int top = 2 * (k - 1);
  for (int r = blockIdx.x; r < N; r += gridDim.x) {
    const long long b0 = off[r];
    const long long len = off[r + 1] - b0;
    const long long n = len - k + 1;
    if (n <= 0) continue;  // the same for the whole block
    const long long o0 = out_off[r];
    int gate = 0;
    if (phred != nullptr) {
      const uint8_t q0 = phred[b0];
      int diff = 0;
      for (long long i = t; i < len; i += kThreads) diff |= phred[b0 + i] != q0;
      gate = __syncthreads_or(diff);
    }
    for (long long p0 = 0; p0 < n; p0 += kTile) {
      const int tn = (int)(n - p0 < kTile ? n - p0 : kTile);
      const int nb = tn + k - 1;
      const uint8_t* c0 = codes + b0 + p0;
      for (int i = t; i < nb; i += kThreads) s_codes[i] = c0[i];
      if (gate) {
        const uint8_t* q = phred + b0 + p0 + k / 2;
        for (int i = t; i < tn; i += kThreads) s_midq[i] = q[i];
      }
      __syncthreads();
      const int q = t * kRun;
      if (q < tn) {
        unsigned long long f = 0, rc = 0;
        for (int j = 0; j < k - 1; ++j) {
          const unsigned long long c = s_codes[q + j];
          f = (f << 2) | c;
          rc = (rc >> 2) | ((3ull - c) << top);
        }
        const int e = tn - q < kRun ? tn - q : kRun;
        for (int i = 0; i < e; ++i) {
          const unsigned long long c = s_codes[q + i + k - 1];
          f = ((f << 2) | c) & kmask;
          rc = (rc >> 2) | ((3ull - c) << top);
          const unsigned long long sf = f & smask, sr = rc & smask;
          const bool canon = sf < sr;
          s_keys[slot(q + i)] = (canon ? f : rc) | ((unsigned long long)canon << 63);
          s_valid[q + i] = sf != sr && (!gate || (int)s_midq[q + i] >= min_bq);
        }
      }
      __syncthreads();
      unsigned long long* kout = keys + o0 + p0;
      uint8_t* vout = valid + o0 + p0;
      for (int i = t; i < tn; i += kThreads) {
        kout[i] = s_keys[slot(i)];
        vout[i] = s_valid[i];
      }
      __syncthreads();  // the next tile reuses shared memory
    }
  }
}

}  // namespace

// Launches kernel 4 on `stream` over the N reads.  Device pointers to
// contiguous tensors as the note at the top says; phred may be null.
// Allocates nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int split_kmers_launch(const uint8_t* codes, const uint8_t* phred,
                                  const long long* off, const long long* out_off, int N, int k,
                                  int min_bq, unsigned long long* keys, uint8_t* valid,
                                  void* stream) {
  if (k < 1 || k > kMaxK || (k & 1) == 0) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = N < sms * kBlocksPerSm ? N : sms * kBlocksPerSm;
  split_kmers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(codes, phred, off, out_off, N,
                                                                   k, min_bq, keys, valid);
  return (int)cudaGetLastError();
}
