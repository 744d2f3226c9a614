// Open-syncmer scan for sm_90a (kernel 5): per position of every read,
// whether its k-mer is a syncmer, and its canonical k-mer.
//
// Replaces savont_tpu/ops/kmers_jax.py:104 syncmer_batch with its hash
// _mm_hash64_planes (:148) (XLA element-wise code on (hi, lo) uint32
// planes), the batched form of the host scan's syncmers (seeding.rs:527-543,
// savont_tpu/ops/kmers.py syncmer_and_snpmer_scan).  With s = k - c + 1, the
// s-mer at each base is hashed by minimap2's mm_hash64 of its canonical form
// (the smaller of the forward and reverse-complement packings); the k-mer at
// position p holds the c = k - s + 1 s-mers p..p+c-1, and it is a syncmer
// when the centre one's hash, index mid = (c - 1) / 2, is strictly below
// each of the others.  Its canonical k-mer is the forward packing when the
// masked forward k-mer (middle base zeroed) is below the masked reverse
// one, else the reverse: ties go to the reverse strand.
//
// Inputs: codes (B,) uint8 2-bit codes of the reads back to back; off (N+1,)
// int64 read offsets; out_off (N+1,) int64, read r's max(L - k + 1, 0)
// positions start at out_off[r].  Outputs: flags (n,) uint8, kmers (n,)
// uint64.  1 <= s <= k <= 31.
//
// What bounds it: bytes, and nearly as much its operations.  The function
// reads 1 B a base and writes 9 B a position (29 M positions at the
// 20,000-read cell: 0.086 ms at 3.35 TB/s), and needs about 91 32-bit
// operations a position whatever c (0.080 ms at the card's int32 rate): the
// s-mer pair, its minimum and its hash (19 64-bit operations), the k-mer
// pair and its masked comparison, and the centre against the minimum of
// each side of the window.  Comparing the centre with the c - 1 other
// hashes one by one takes a 64-bit shared load and compare each (ten at
// c = 11), and rolling the s-mer and the k-mer over short runs pays a
// warm-up of s - 1 and k - 1 bases a run.  This design:
// - one block a read (grid-stride over the reads, the next read's offsets
//   loaded a read ahead), tiles of kTile positions; a tile's kTile + k - 1
//   codes staged in one pass of 16-byte loads from the 16-byte boundary
//   below its first base (a vector not wholly inside [0, off[N]) byte by
//   byte, so nothing past the tensor is read), each vector packed at once
//   into two 32-bit words: the codes first base most significant and their
//   complements first base least significant;
// - the s-mer and the k-mer that start at a base are then three 64-bit
//   shared loads and four funnel shifts, shared by both: no rolling, no
//   warm-up, one start a thread in turn (t, t + kThreads, ...), so every
//   thread is busy and the k-mers (8 B a thread) leave as coalesced stores;
//   the tile's tn + c - 1 hashes go to shared memory;
// - each side of the window is a sliding minimum of width w = (c - 1) / 2
//   (van Herk / Gil-Werman): a thread takes a block of w hashes, writes its
//   suffix minima, then joins the prefix minima of the next block, so that
//   the minimum of any w consecutive hashes is one shared word; the right
//   side of an even c is that window and one more hash.  A position then
//   costs two or three compares (c = 1: none, every k-mer is a syncmer;
//   w = 1: the hashes themselves), and the flags leave coalesced;
// - the outputs are stored with the streaming hint (__stcs): nothing reads
//   them soon, and on the H100 it measured 5% faster, with 39 registers
//   where plain stores took 54.
// Copying the next tile with cp.async while this one computes was slower
// on the H100 (78 registers, or 64 with a spill).
// Budget: 34,312 B of shared memory a block (the kTile + kMaxK - 1 hashes
// and as many window minima, 16.6 KB each, and the packed codes; the design
// that compared the hashes one by one took 41,264 B) and 39 registers a
// thread, no spill (ptxas, sm_90a): 6 blocks of 256 threads an SM, where it
// was 4; three barriers a tile (two when w < 2).  The grid is what the
// occupancy calculator says fits at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;                    // positions a block stages at once
constexpr int kMaxK = 31;
constexpr int kVecs = (15 + kTile + kMaxK - 1 + 15) / 16;
constexpr int kHashes = kTile + kMaxK - 1;     // s-mer starts of a tile: tn + c - 1 <= kTile + k - 1

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

__device__ __forceinline__ unsigned long long umin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads) syncmers_kernel(
    const uint8_t* __restrict__ codes, const long long* __restrict__ off,
    const long long* __restrict__ out_off, int N, int k, int s, uint8_t* __restrict__ flags,
    unsigned long long* __restrict__ kmers) {
  __shared__ uint2 s_fr[kVecs + 2];              // packed codes (+2: the last starts' reads)
  __shared__ unsigned long long s_hash[kHashes];  // the tile's s-mer hashes
  __shared__ unsigned long long s_min[kHashes];   // minima of w consecutive hashes
  const int t = threadIdx.x;
  const long long end = off[N];
  const unsigned long long kmask = (1ull << (2 * k)) - 1, smask = (1ull << (2 * s)) - 1;
  const unsigned long long split = ~(3ull << (k - 1));
  const int c = k - s + 1, w = (c - 1) / 2;  // hashes in a window; the centre's index and each side's width
  const bool even = (c & 1) == 0;           // the right side is w + 1 wide
  const unsigned long long* win = w >= 2 ? s_min : s_hash;
  long long nx0 = 0, nx1 = 0, nxo = 0;  // the block's next read: off, off + 1, out_off
  if ((int)blockIdx.x < N) {
    nx0 = off[blockIdx.x];
    nx1 = off[blockIdx.x + 1];
    nxo = out_off[blockIdx.x];
  }
  for (int r = blockIdx.x; r < N; r += gridDim.x) {
    const long long b0 = nx0, o0 = nxo, n = nx1 - nx0 - k + 1;
    if (r + (int)gridDim.x < N) {
      nx0 = off[r + gridDim.x];
      nx1 = off[r + gridDim.x + 1];
      nxo = out_off[r + gridDim.x];
    }
    if (n <= 0) continue;  // the same for the whole block
    for (long long p0 = 0; p0 < n; p0 += kTile) {
      const int tn = (int)(n - p0 < kTile ? n - p0 : kTile);
      const int nb = tn + k - 1;   // bases staged
      const int nh = tn + c - 1;   // s-mers hashed: starts 0 .. tn + c - 2
      const long long g = b0 + p0;
      const int lc = (int)((uintptr_t)(codes + g) & 15);
      const int nv = (lc + nb + 15) >> 4;
      for (int v = t; v < nv; v += kThreads) s_fr[v] = pack16(load_vec(codes, end, g, nb, lc, v));
      __syncthreads();  // (also: the last tile's flags have read s_hash and s_min)
      unsigned long long* kout = kmers + o0 + p0;
      for (int i = t; i < nh; i += kThreads) {
        // the 64 bits from staged base lc + i on, forward and reverse
        const int x = lc + i, q = x >> 4, sh = 2 * (x & 15);
        const uint2 a = s_fr[q], b = s_fr[q + 1], e = s_fr[q + 2];
        const unsigned long long fw =
            (unsigned long long)__funnelshift_l(b.x, a.x, sh) << 32 | __funnelshift_l(e.x, b.x, sh);
        const unsigned long long rv =
            (unsigned long long)__funnelshift_r(b.y, e.y, sh) << 32 | __funnelshift_r(a.y, b.y, sh);
        const unsigned long long sf = fw >> (64 - 2 * s), sr = rv & smask;
        s_hash[i] = mm_hash64(umin(sf, sr));
        if (i < tn) {
          const unsigned long long f = fw >> (64 - 2 * k), rc = rv & kmask;
          __stcs(kout + i, (f & split) < (rc & split) ? f : rc);
        }
      }
      __syncthreads();
      if (w >= 2) {
        // window starts p (left side) and p + w + 1 (right side) for p < tn
        const int nm = tn + w + 1;
        for (int b0w = t * w; b0w < nm; b0w += kThreads * w) {
          unsigned long long m = ~0ull;  // suffix minima of the block [b0w, b0w + w)
          for (int a = b0w + w - 1; a >= b0w; --a) {
            m = umin(m, s_hash[a]);
            if (a < nm) s_min[a] = m;
          }
          m = ~0ull;  // joined with the prefix minima of the next block
          for (int j = 1; j < w && b0w + j < nm; ++j) {
            m = umin(m, s_hash[b0w + j + w - 1]);
            s_min[b0w + j] = umin(s_min[b0w + j], m);
          }
        }
        __syncthreads();
      }
      uint8_t* fout = flags + o0 + p0;
      for (int i = t; i < tn; i += kThreads) {
        const unsigned long long h = s_hash[i + w];
        bool ok = true;
        if (w >= 1) ok = h < win[i] && h < win[i + w + 1];
        if (even) ok = ok && h < s_hash[i + c - 1];
        __stcs(reinterpret_cast<signed char*>(fout + i), (signed char)ok);
      }
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
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, syncmers_kernel, kThreads, 0);
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = N < cap ? N : (int)cap;
  syncmers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(codes, off, out_off, N, k, s,
                                                               flags, kmers);
  return (int)cudaGetLastError();
}
