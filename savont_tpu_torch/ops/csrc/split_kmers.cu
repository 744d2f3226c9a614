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
// 1,450 bp a read) about 316 MB, 0.094 ms at 3.35 TB/s, four fifths of it
// the stores; its integer work, about 28 32-bit operations a position, takes
// a quarter of that.  A block a read that stages bytes one at a time waits
// on memory latency: four dependent trips a read (the quality scan, codes,
// phreds, stores), a byte a thread each.  This design keeps a block a read
// and makes each trip wide and each thread busy:
// - one block a read (grid-stride over the reads, the next read's offsets
//   loaded a read ahead), the read cut into tiles of kTile positions;
// - a tile's kTile + k - 1 codes and phreds are staged in one pass of
//   16-byte loads from the 16-byte boundary below its first base, a code
//   vector and a phred vector a thread, both in flight at once (a vector
//   not wholly inside [0, off[N]) is read byte by byte, so nothing past the
//   tensors is read); each code vector is packed at once into two 32-bit
//   words: the 16 codes first base most significant (F), and their
//   complements first base least significant (R);
// - the k-mer at any base is then three 64-bit shared loads and four funnel
//   shifts, with no rolling and so no warm-up; the positions go to the
//   threads one a thread in turn (t, t + kThreads, ...), so a read of 1,434
//   positions keeps every thread busy, and the keys (8 B a thread) and the
//   valid bytes leave as coalesced stores straight from registers;
// - the gate's "all qualities equal" (split_kmer_mid's
//   (phred == phred[0]).all()) comes from the staged phreds through the
//   staging barrier itself (__syncthreads_or) when the read is one tile,
//   from a 16-byte pass over the read first when it is longer;
// - the staging buffers are double, so a tile costs one barrier.
// Copying the next tile with cp.async while this one computes was slower
// on the H100 (more registers, fewer blocks an SM, and slower at the same
// registers), as were streaming stores.
// Budget: 6,320 B of shared memory a block (two buffers of kVecs + 2 packed
// words and kVecs * 16 phred bytes) and 32 registers a thread, no spill
// (ptxas, sm_90a): 8 blocks of 256 threads an SM.  The grid is what the
// occupancy calculator says fits at once, so that no block waits for
// another's reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;                    // positions a block stages at once
constexpr int kMaxK = 31;
// 16-byte vectors a tile's kTile + k - 1 bases span from the boundary below
constexpr int kVecs = (15 + kTile + kMaxK - 1 + 15) / 16;

// x's four bytes, 2 bits each, into 8 bits: byte 0 least significant
__device__ __forceinline__ unsigned pack4(unsigned x) {
  x &= 0x03030303u;
  return (x | x >> 6 | x >> 12 | x >> 18) & 0xffu;
}

// 16 codes as (F, R): F the codes with the first most significant, R their
// complements (3 - c) with the first least significant
__device__ __forceinline__ uint2 pack16(uint4 v) {
  const unsigned f = pack4(__byte_perm(v.x, 0, 0x0123)) << 24 | pack4(__byte_perm(v.y, 0, 0x0123)) << 16 |
                     pack4(__byte_perm(v.z, 0, 0x0123)) << 8 | pack4(__byte_perm(v.w, 0, 0x0123));
  const unsigned r = pack4(~v.x) | pack4(~v.y) << 8 | pack4(~v.z) << 16 | pack4(~v.w) << 24;
  return make_uint2(f, r);
}

// The forward and reverse-complement k-mers whose first base is the staged
// base x (2k bits each), from the packed words of its vector and the next two
__device__ __forceinline__ void kmer_at(const uint2* fr, int x, int k, unsigned long long& f,
                                        unsigned long long& rc) {
  const int w = x >> 4, sh = 2 * (x & 15);
  const uint2 a = fr[w], b = fr[w + 1], c = fr[w + 2];
  const unsigned fh = __funnelshift_l(b.x, a.x, sh), fl = __funnelshift_l(c.x, b.x, sh);
  const unsigned rl = __funnelshift_r(a.y, b.y, sh), rh = __funnelshift_r(b.y, c.y, sh);
  f = ((unsigned long long)fh << 32 | fl) >> (64 - 2 * k);
  rc = ((unsigned long long)rh << 32 | rl) & ((1ull << (2 * k)) - 1);
}

// Vector v of the bytes src[g, g + nb), counted from the 16-byte boundary
// `lead` bytes below src + g.  One 16-byte load when the vector lies inside
// src[0, end); else the range's own bytes one by one and 0 around them.
__device__ __forceinline__ uint4 load_vec(const uint8_t* src, long long end, long long g, int nb,
                                          int lead, int v) {
  const long long a = g - lead + 16LL * v;
  if (a >= 0 && a + 16 <= end) return *reinterpret_cast<const uint4*>(src + a);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (a + j >= g && a + j < g + nb) w[j >> 2] |= (unsigned)src[a + j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Whether a byte of vector v inside the staged range [lead, lead + nb)
// differs from q0
__device__ __forceinline__ int differs(uint4 q, int v, int lead, int nb, unsigned q0) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  int d = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int x = 16 * v + j;
    d |= x >= lead && x < lead + nb && ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) != q0;
  }
  return d;
}

__device__ __forceinline__ int lead_of(const uint8_t* p) { return (int)((uintptr_t)p & 15); }

__global__ void __launch_bounds__(kThreads) split_kmers_kernel(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ phred,
    const long long* __restrict__ off, const long long* __restrict__ out_off, int N, int k,
    int min_bq, unsigned long long* __restrict__ keys, uint8_t* __restrict__ valid) {
  __shared__ uint2 s_fr[2][kVecs + 2];                  // packed codes (+2: kmer_at's last reads)
  __shared__ __align__(16) uint8_t s_q[2][kVecs * 16];  // phreds, as loaded
  const int t = threadIdx.x;
  const long long end = off[N];
  const unsigned long long smask = ~(3ull << (k - 1));
  int buf = 0;
  long long nx0 = 0, nx1 = 0, nxo = 0;  // the block's next read: off, off + 1, out_off
  if ((int)blockIdx.x < N) {
    nx0 = off[blockIdx.x];
    nx1 = off[blockIdx.x + 1];
    nxo = out_off[blockIdx.x];
  }
  for (int r = blockIdx.x; r < N; r += gridDim.x) {
    const long long b0 = nx0, len = nx1 - nx0, o0 = nxo;
    if (r + (int)gridDim.x < N) {
      nx0 = off[r + gridDim.x];
      nx1 = off[r + gridDim.x + 1];
      nxo = out_off[r + gridDim.x];
    }
    const long long n = len - k + 1;
    if (n <= 0) continue;  // the same for the whole block
    unsigned q0 = 0;
    int gate = 0;
    if (phred != nullptr) {
      q0 = phred[b0];
      if (n > kTile) {  // several tiles: the gate from a pass over the read first
        const int lq = lead_of(phred + b0);
        const int nv = (lq + (int)len + 15) >> 4;
        int diff = 0;
        for (int v = t; v < nv; v += kThreads)
          diff |= differs(load_vec(phred, end, b0, (int)len, lq, v), v, lq, (int)len, q0);
        gate = __syncthreads_or(diff);
      }
    }
    for (long long p0 = 0; p0 < n; p0 += kTile) {
      const int tn = (int)(n - p0 < kTile ? n - p0 : kTile);
      const int nb = tn + k - 1;
      const long long g = b0 + p0;
      const int lc = lead_of(codes + g);
      const int lq = phred != nullptr ? lead_of(phred + g) : 0;
      const int nvc = (lc + nb + 15) >> 4;
      const int nvq = phred != nullptr ? (lq + nb + 15) >> 4 : 0;
      uint2* fr = s_fr[buf];
      uint8_t* sq = s_q[buf];
      int diff = 0;
      for (int v = t; v < nvc || v < nvq; v += kThreads) {
        uint4 cv = make_uint4(0u, 0u, 0u, 0u), qv = cv;
        if (v < nvc) cv = load_vec(codes, end, g, nb, lc, v);
        if (v < nvq) qv = load_vec(phred, end, g, nb, lq, v);
        if (v < nvc) fr[v] = pack16(cv);
        if (v < nvq) {
          *reinterpret_cast<uint4*>(sq + 16 * v) = qv;
          diff |= differs(qv, v, lq, nb, q0);
        }
      }
      diff = __syncthreads_or(diff);
      if (n <= kTile) gate = diff;  // the tile holds the whole read
      unsigned long long* kout = keys + o0 + p0;
      uint8_t* vout = valid + o0 + p0;
      const uint8_t* mq = sq + lq + k / 2;
      for (int i = t; i < tn; i += kThreads) {
        unsigned long long f, rc;
        kmer_at(fr, lc + i, k, f, rc);
        const unsigned long long sf = f & smask, sr = rc & smask;
        const bool canon = sf < sr;
        kout[i] = (canon ? f : rc) | ((unsigned long long)canon << 63);
        vout[i] = sf != sr && (!gate || (int)mq[i] >= min_bq);
      }
      buf ^= 1;  // the next tile stages into the other buffer: no second barrier
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
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, split_kmers_kernel, kThreads, 0);
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = N < cap ? N : (int)cap;
  split_kmers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(codes, phred, off, out_off, N,
                                                                   k, min_bq, keys, valid);
  return (int)cudaGetLastError();
}
