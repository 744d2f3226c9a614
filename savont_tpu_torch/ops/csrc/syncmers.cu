// Open-syncmer scan for sm_90a (kernel 5): per position of every read,
// whether its k-mer is a syncmer, and its canonical k-mer.
//
// Replaces savont_tpu/ops/kmers_jax.py:104 syncmer_batch with its hash
// _mm_hash64_planes (:148) (XLA element-wise code on (hi, lo) uint32
// planes), the batched form of the host scan's syncmers (seeding.rs:527-543,
// savont_tpu/ops/kmers.py syncmer_and_snpmer_scan).  With s = k - c + 1, the
// s-mer at each base is hashed by minimap2's mm_hash64 of its canonical form
// (the smaller of the forward and reverse-complement packings); the k-mer at
// position p holds the k - s + 1 s-mers p..p+k-s, and it is a syncmer when
// the centre one's hash, index (k - s) / 2, is strictly below each of the
// others.  Its canonical k-mer is the forward packing when the masked
// forward k-mer (middle base zeroed) is below the masked reverse one, else
// the reverse: ties go to the reverse strand.
//
// Inputs: codes (B,) uint8 2-bit codes of the reads back to back; off (N+1,)
// int64 read offsets; out_off (N+1,) int64, read r's max(L - k + 1, 0)
// positions start at out_off[r].  Outputs: flags (n,) uint8, kmers (n,)
// uint64.  1 <= s <= k <= 31.
//
// What bounds it: bytes.  The function reads 1 B a base and writes 9 B a
// position (29 M positions at the 20,000-read cell: 0.086 ms at 3.35 TB/s),
// and needs about 91 32-bit operations a position whatever c: a rolling
// s-mer pair, its minimum and its hash (19 64-bit operations), a rolling
// k-mer pair and its masked comparison, and the centre test against a
// sliding minimum of each side of the window (a constant 3 minimums a
// position).  This design compares the c - 1 other hashes one by one
// instead (107 operations at c = 11).  It reads each base once and writes
// coalesced, and hashes each s-mer once:
// - one block a read (grid-stride over the reads), tiles of kTile positions;
//   a tile's kTile + k - 1 codes staged in shared memory;
// - first the tile's kTile + k - s s-mer hashes into shared memory, each
//   thread rolling an s-mer over a run of kRun consecutive bases; then each
//   thread rolls the k-mer over its run of positions and compares each
//   window's hashes from shared memory;
// - 64-bit words in shared memory padded one in nine (distinct banks for
//   the threads' runs); outputs leave through shared memory as coalesced
//   stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;
constexpr int kTile = kThreads * kRun;
constexpr int kMaxK = 31;
constexpr int kTileBases = kTile + kMaxK - 1;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ int slot(int i) { return i + i / kRun; }

// seeding.rs:18-28
__device__ __forceinline__ unsigned long long mm_hash64(unsigned long long key) {
  key = (~key) + (key << 21);
  key = key ^ (key >> 24);
  key = (key + (key << 3)) + (key << 8);
  key = key ^ (key >> 14);
  key = (key + (key << 2)) + (key << 4);
  key = key ^ (key >> 28);
  key = key + (key << 31);
  return key;
}

__global__ void __launch_bounds__(kThreads) syncmers_kernel(
    const uint8_t* __restrict__ codes, const long long* __restrict__ off,
    const long long* __restrict__ out_off, int N, int k, int s, uint8_t* __restrict__ flags,
    unsigned long long* __restrict__ kmers) {
  __shared__ uint8_t s_codes[kTileBases];
  __shared__ uint8_t s_flags[kTile];
  __shared__ unsigned long long s_hash[kTileBases + kTileBases / kRun + 1];
  __shared__ unsigned long long s_kmers[kTile + kTile / kRun];
  const int t = threadIdx.x;
  const unsigned long long kmask = (1ull << (2 * k)) - 1;
  const unsigned long long smask_s = (1ull << (2 * s)) - 1;
  const unsigned long long split = ~(3ull << (k - 1));
  const int top_k = 2 * (k - 1), top_s = 2 * (s - 1);
  const int m = k - s + 1, mid = (k - s) / 2;
  for (int r = blockIdx.x; r < N; r += gridDim.x) {
    const long long b0 = off[r];
    const long long n = off[r + 1] - b0 - k + 1;
    if (n <= 0) continue;  // the same for the whole block
    const long long o0 = out_off[r];
    for (long long p0 = 0; p0 < n; p0 += kTile) {
      const int tn = (int)(n - p0 < kTile ? n - p0 : kTile);
      const int nb = tn + k - 1;   // bases staged
      const int nh = tn + k - s;   // s-mers hashed: starts 0 .. tn + k - s - 1
      const uint8_t* c0 = codes + b0 + p0;
      for (int i = t; i < nb; i += kThreads) s_codes[i] = c0[i];
      __syncthreads();
      for (int q = t * kRun; q < nh; q += kThreads * kRun) {
        unsigned long long f = 0, rc = 0;
        for (int j = 0; j < s - 1; ++j) {
          const unsigned long long c = s_codes[q + j];
          f = (f << 2) | c;
          rc = (rc >> 2) | ((3ull - c) << top_s);
        }
        const int e = nh - q < kRun ? nh - q : kRun;
        for (int i = 0; i < e; ++i) {
          const unsigned long long c = s_codes[q + i + s - 1];
          f = ((f << 2) | c) & smask_s;
          rc = (rc >> 2) | ((3ull - c) << top_s);
          s_hash[slot(q + i)] = mm_hash64(f < rc ? f : rc);
        }
      }
      __syncthreads();
      const int q = t * kRun;
      if (q < tn) {
        unsigned long long f = 0, rc = 0;
        for (int j = 0; j < k - 1; ++j) {
          const unsigned long long c = s_codes[q + j];
          f = (f << 2) | c;
          rc = (rc >> 2) | ((3ull - c) << top_k);
        }
        const int e = tn - q < kRun ? tn - q : kRun;
        for (int i = 0; i < e; ++i) {
          const int p = q + i;
          const unsigned long long c = s_codes[p + k - 1];
          f = ((f << 2) | c) & kmask;
          rc = (rc >> 2) | ((3ull - c) << top_k);
          s_kmers[slot(p)] = (f & split) < (rc & split) ? f : rc;
          const unsigned long long centre = s_hash[slot(p + mid)];
          bool ok = true;
          for (int j = 0; j < m; ++j)
            if (j != mid) ok &= centre < s_hash[slot(p + j)];
          s_flags[p] = ok;
        }
      }
      __syncthreads();
      unsigned long long* kout = kmers + o0 + p0;
      uint8_t* fout = flags + o0 + p0;
      for (int i = t; i < tn; i += kThreads) {
        kout[i] = s_kmers[slot(i)];
        fout[i] = s_flags[i];
      }
      __syncthreads();  // the next tile reuses shared memory
    }
  }
}

}  // namespace

// Launches kernel 5 on `stream` over the N reads.  Device pointers to
// contiguous tensors as the note at the top says.  Allocates nothing and
// does not synchronise.  Returns cudaGetLastError().
extern "C" int syncmers_launch(const uint8_t* codes, const long long* off,
                               const long long* out_off, int N, int k, int s, uint8_t* flags,
                               unsigned long long* kmers, void* stream) {
  if (k < 1 || k > kMaxK || s < 1 || s > k) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = N < sms * kBlocksPerSm ? N : sms * kBlocksPerSm;
  syncmers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(codes, off, out_off, N, k, s,
                                                               flags, kmers);
  return (int)cudaGetLastError();
}
