// SINTAX reference k-mers for sm_90a (kernel 6): each reference row of a
// chunk, its raw bases in, its sorted unique canonical 12-mers out, in the
// layout kernel 3 (sintax_scores.cu) reads.
//
// Replaces no TPU kernel: the JAX package extracts the references' k-mers on
// the host, one reference at a time (savont_tpu/pipeline/sintax.py:162,
// np.unique(extract_kmers(rec.seq.upper()))), and the port did the same
// until this kernel took the work to the card.  For row r, the L bases
// seqs[off[r] : off[r+1]] are encoded through a 256-entry table equal to
// pipeline/sintax._BYTE_CODE (A/a 0, C/c 1, G/g 2, T/t/U/u 3, every other
// byte 0); the k-mer at position p packs bases p..p+11 with the first base
// most significant (f), its reverse complement the codes 3 - c with the
// first base least significant (rc), and the canonical k-mer is min(f, rc).
// The row's n = max(L - 11, 0) canonical k-mers, sorted ascending with
// repeats removed, are written at the front of its capacity, and the rest of
// the capacity is filled with ROW_PAD (0x7FFFFFFF), which kernel 3 counts as
// a miss.
//
// Inputs: seqs (B,) uint8, the chunk's references back to back; off (R+1,)
// int64 byte offsets; row_off (R+1,) int64, row r's capacity row_off[r+1] -
// row_off[r] being max(off[r+1] - off[r] - 11, 0); max_n the largest
// capacity.  Output: kmers (row_off[R],) int32.
//
// What bounds it: bytes.  The function reads a byte a base and writes 4 B a
// k-mer: at the sintax cell's chunk (4,096 references of about 1,450 bp)
// 5.9 MB in and 23.7 MB out, 0.0088 ms at 3.35 TB/s (a call's 12 chunks:
// 0.106 ms).  Its work is a sort of each row, which a block does in shared
// memory, so nothing but the bases, the offsets and the rows crosses device
// memory.  The design:
// - one block a row, grid-stride over the rows, as many blocks as fit;
// - the row's bases are staged in tiles of kTile positions with 16-byte
//   loads from the 16-byte boundary below the tile's first base (a vector
//   not wholly inside [0, B) is read byte by byte), encoded through the
//   table in shared memory and packed 16 bases into two 32-bit words (the
//   codes first base most significant, their complements first base least
//   significant), as kernel 4 (split_kmers.cu) stages its codes;
// - each k-mer from two shared loads and two funnel shifts, a position a
//   thread in turn, into the row's array in shared memory;
// - the array is sorted by a bitonic network over the next power of two
//   above n, the positions past n standing for +infinity: in this form of
//   the network every comparator puts the smaller value at the lower index,
//   so those positions never change and the comparators that touch them are
//   skipped, and the array needs no padding; one barrier a step;
// - repeats are dropped by comparing neighbours, kThreads at a time: a warp
//   ballot and the warps' counts through shared memory give each kept k-mer
//   its place, and it is stored coalesced; ROW_PAD fills the rest;
// - the dynamic shared memory holds the chunk's longest row (4 B a k-mer),
//   opted in above 48 KB up to the card's limit (about 57,000 k-mers on an
//   H100).  A longer row is sorted and compacted in place in its own slice
//   of kmers (device memory, through L2) by the same code, so no row goes
//   back to the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 12;                      // SINTAX's k (constants.SINTAX_K)
constexpr int kTile = 2048;                 // positions a block stages at once
// 16-byte vectors a tile's kTile + k - 1 bases span from the boundary below
constexpr int kVecs = (15 + kTile + kK - 1 + 15) / 16;
constexpr int kRowPad = 0x7FFFFFFF;         // ops/sintax_torch.ROW_PAD

// pipeline/sintax._BYTE_CODE: A/a 0, C/c 1, G/g 2, T/t/U/u 3, any other 0
__device__ __forceinline__ uint8_t byte_code(int b) {
  switch (b) {
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': case 'U': case 'u': return 3;
    default: return 0;
  }
}

// 16 bytes as (F, R): their codes with the first most significant, and the
// complements (3 - c) with the first least significant
__device__ __forceinline__ uint2 encode16(uint4 v, const uint8_t* tab) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned f = 0u, r = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const unsigned c = tab[(w[j >> 2] >> (8 * (j & 3))) & 0xffu];
    f |= c << (30 - 2 * j);
    r |= (3u - c) << (2 * j);
  }
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

// The canonical 12-mer whose first base is the staged base x
__device__ __forceinline__ int canonical_at(const uint2* fr, int x) {
  const int w = x >> 4, sh = 2 * (x & 15);
  const uint2 a = fr[w], b = fr[w + 1];
  const unsigned f = __funnelshift_l(b.x, a.x, sh) >> (32 - 2 * kK);
  const unsigned rc = __funnelshift_r(a.y, b.y, sh) & ((1u << (2 * kK)) - 1);
  return (int)(f < rc ? f : rc);
}

// a[0, n) sorted ascending by the bitonic network over the next power of
// two, the positions past n as +infinity (never read or written).  Ends
// with a barrier.
__device__ __forceinline__ void sort_row(int* a, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n2 >> 1); t += kThreads) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit log2(j) of i is 0
        const int p = j == (k >> 1) ? i ^ (k - 1) : i | j;    // p > i
        if (p < n) {
          const int x = a[i], y = a[p];
          if (y < x) {
            a[i] = y;
            a[p] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The distinct values of the sorted a[0, n) at out[0, u), ROW_PAD at
// out[u, n).  out may be a itself: a tile's values are all read before any
// is written, and a write never reaches past the tile being read.  A
// tile's first value is compared with a[t0 - 1], which still holds its
// value when a write reached it (the last distinct value so far).
__device__ __forceinline__ void compact_row(const int* a, int n, int* out, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int total = 0;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int i = t0 + tid;
    int x = 0;
    bool keep = false;
    if (i < n) {
      x = a[i];
      keep = i == 0 || a[i - 1] != x;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      tile += c;
    }
    if (keep) out[total + before + __popc(ballot & ((1u << lane) - 1u))] = x;
    total += tile;
    __syncthreads();  // s_warp is the next tile's
  }
  for (int i = total + tid; i < n; i += kThreads) out[i] = kRowPad;
}

// Row r's n k-mers through `a` (the block's shared memory, or the row's own
// slice of kmers for a row longer than it holds) into out: staged, encoded
// and packed a tile at a time, each canonical k-mer into a, a sorted,
// compacted into out.  Inlined at both call sites, so that the shared one
// addresses shared memory directly.
__device__ __forceinline__ void one_row(const uint8_t* seqs, long long B, long long b0, int n,
                                        int* a, int* out, uint2* s_fr, const uint8_t* s_tab,
                                        int* s_warp) {
  const int tid = threadIdx.x;
  for (int p0 = 0; p0 < n; p0 += kTile) {
    const int tn = n - p0 < kTile ? n - p0 : kTile;
    const int nb = tn + kK - 1;
    const long long g = b0 + p0;
    const int lead = (int)((uintptr_t)(seqs + g) & 15);
    const int nv = (lead + nb + 15) >> 4;
    for (int v = tid; v < nv; v += kThreads) s_fr[v] = encode16(load_vec(seqs, B, g, nb, lead, v), s_tab);
    __syncthreads();
    for (int i = tid; i < tn; i += kThreads) a[p0 + i] = canonical_at(s_fr, lead + i);
    __syncthreads();  // s_fr is the next tile's; a is whole before the sort
  }
  sort_row(a, n);
  compact_row(a, n, out, s_warp);
}

__global__ void __launch_bounds__(kThreads) sintax_ref_kmers_kernel(
    const uint8_t* __restrict__ seqs, long long B, const long long* __restrict__ off,
    const long long* __restrict__ row_off, int R, int smem_n, int* __restrict__ kmers) {
  extern __shared__ __align__(16) int s_row[];  // smem_n k-mers
  __shared__ uint2 s_fr[kVecs + 1];              // a tile's packed bases (+1: canonical_at's b)
  __shared__ uint8_t s_tab[256];
  __shared__ int s_warp[kWarps];
  for (int b = threadIdx.x; b < 256; b += kThreads) s_tab[b] = byte_code(b);
  __syncthreads();
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const long long b0 = off[r], o0 = row_off[r];
    const int n = (int)(row_off[r + 1] - o0);
    if (n <= 0) continue;  // the same for the whole block
    if (n <= smem_n)
      one_row(seqs, B, b0, n, s_row, kmers + o0, s_fr, s_tab, s_warp);
    else
      one_row(seqs, B, b0, n, kmers + o0, kmers + o0, s_fr, s_tab, s_warp);
  }
}

// The most k-mers a block holds in shared memory on the current card: its
// opt-in limit less the kernel's static shared memory, 4 B a k-mer; 0 on an
// error.
int smem_kmers() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, sintax_ref_kmers_kernel) != cudaSuccess)
    return 0;
  return (optin - (int)attr.sharedSizeBytes) / 4;
}

}  // namespace

// The longest row (in k-mers) kernel 6 sorts in shared memory on the current
// card; a longer one is sorted in device memory.
extern "C" int sintax_ref_kmers_smem_cap() { return smem_kmers(); }

// Launches kernel 6 on `stream` over the R rows.  Device pointers to
// contiguous tensors as the note at the top says; max_n the largest row
// capacity, which sizes the dynamic shared memory.  Allocates nothing and
// does not synchronise.  Returns cudaGetLastError() (or the error of the
// calls before the launch).
extern "C" int sintax_ref_kmers_launch(const uint8_t* seqs, long long B, const long long* off,
                                       const long long* row_off, int R, int max_n, int* kmers,
                                       void* stream) {
  if (R <= 0 || max_n <= 0) return 0;  // no row with a k-mer: nothing to write
  const int cap = smem_kmers();
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  const int smem_n = max_n < cap ? max_n : cap;
  const size_t smem = (size_t)smem_n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(sintax_ref_kmers_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sintax_ref_kmers_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap_blocks = (long long)sms * per_sm;
  const int grid = R < cap_blocks ? R : (int)cap_blocks;
  sintax_ref_kmers_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(seqs, B, off, row_off, R,
                                                                           smem_n, kmers);
  return (int)cudaGetLastError();
}
