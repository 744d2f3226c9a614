// Kernel 2: traceback walk + CIGAR run-length encoding for sm_90a, one warp
// per pair, the pair's payload rows streamed through shared memory.
//
// Replaces the XLA walk state machine savont_tpu/ops/align_jax.py:_walk_ops
// and the run-length encoding of sw_traceback_from_payload (the device half
// of align_pallas.sw_traceback_pallas_jobs).  A walk starts at its pair's
// best cell (ri, bj) in state H and replays the host traceback (ops/align.py
// _traceback) from the payload bytes of kernel 1: H goes to G (use_g) or E;
// G stops on g_zero, goes to F on g_f, else steps diagonally; E steps left
// and exits to G on exitE when j-1 >= 0; F steps up and exits to H on from_h
// when the up cell j+dl is inside the band.  The walk stops at r <= 0, j < 0,
// j >= band or after ops_max ops.  A start row of 0 reads row 0 and stops
// after one op, as the plain version's clamp does.  The ops come out last
// first; their runs are written in forward order, packed as (len << 4) | op
// (0 match / mismatch, 1 insertion, 2 deletion).  n_runs may exceed maxrun:
// the pair then overflowed, its CIGAR row is all zeros and the caller re-runs
// it on the host.  Pairs of score <= 0 write a zero row and leave at once; in
// the stage-4 route, which walks only a pair's winning row, that is most rows.
//
// What bounds it on the H100: the dependent chain of the walk.  Taken step by
// step, a step needs its payload byte before it knows the next step's
// address, and a path has about Lq + indels steps: a warp that walks alone
// out of shared memory takes about 0.13 us a step (two shared-memory loads
// and some forty dependent instructions), 0.19 ms for 1,450 steps however
// few pairs there are.  The bytes are small beside it (a pair's whole payload
// is Lq x band bytes, 160 MB for 2,304 pairs at band 48: 0.05 ms).
//
// What the design does about it.  The row index never rises along a walk
// and a pair's payload rows are contiguous, so the bytes a walk can need are
// known before it starts, whatever the band cell does:
//   - One warp per pair.  The payload rows below the start row stream through
//     shared memory in windows of `rows` rows, newest rows first, together
//     with the rows' lo words, fetched by the whole warp with 16-byte
//     cp.async copies, kStages windows in flight, so the next windows land
//     while the current one is walked.  Rows above the start row are never
//     read.
//   - A step is then two shared-memory loads and some forty integer
//     instructions instead of a round trip to device memory, and it does only
//     what has to be done in sequence: resolve the state, move, and put the
//     op (with its mismatch bit) as one byte into a per-warp buffer of
//     ops_max bytes.  Every lane runs the same step on broadcast loads
//     (uniform, no divergence).
//   - Most of a path is diagonal steps out of state H, and where such a run
//     goes does not depend on the payload: after k of them the walk is in
//     row r - k at band cell j + lo[r] - lo[r - k] - k.  So in state H lane k
//     reads the cell k steps ahead, a ballot finds the first cell that is no
//     diagonal step (or lies outside the band, the window or ops_max), and
//     the warp takes all steps before it at once, up to 32; the step-by-step
//     state machine runs only at that cell (a gap, the path's start) and
//     until the state is H again.  (Lane 0 walking alone step by step, the
//     state handed out by shuffle at each window's end, was measured against
//     this and took about four times as long; it is not kept.)
//   - The run-length encoding is not part of the chain: when the walk has
//     stopped, the warp reads the op bytes in forward order, 32 at a time,
//     finds the run starts by ballot, and each lane that starts a run writes
//     it, so the runs come out in forward order; nm and the insertion and
//     deletion counts are population counts of the same ballots.
//   - A byte's offset in its window buffer equals its global address modulo
//     16, so every copy is aligned whatever the band, Lq and pair index are:
//     the window is rounded outward to 16-byte pieces, and a piece that is
//     not wholly inside the payload tensor (its first or last bytes, when the
//     tensor itself is unaligned) is copied byte by byte, never read across
//     the tensor's bounds.
//   - Runs go to a per-warp buffer of maxrun words in shared memory (runs
//     past maxrun are counted and not kept), and the warp writes the CIGAR
//     row zero-padded in 16-byte stores across its lanes (single words only
//     before the row's first and after its last aligned vector), and meta as
//     one 24-byte row.
// The walk is not fused behind kernel 1's last row: the stage-4 route picks a
// pair's winner across rows after the forward pass (pileup_torch.
// pair_winners) and walks winners only, so a fused walk would walk every row,
// and a pair's payload (70 KB at band 48) held for it would cost kernel 1 its
// occupancy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // pairs per block, at most
constexpr int kStages = 3;           // payload windows per warp, in flight or being walked
constexpr int kMaxRows = 32;         // rows per window, at most
constexpr int kWindowBytes = 4096;   // payload bytes per window, at most (one row at least)
constexpr int kMaxShared = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int ST_H = 0, ST_G = 1, ST_E = 2, ST_F = 3;

// Shared memory of one warp: kStages window buffers, kStages lo buffers, the
// op bytes, the run buffer.  Every part is a multiple of 16 bytes.
struct Layout {
  int rows;        // payload rows per window
  int win_bytes;   // one window buffer: rows x band bytes rounded outward to 16-byte pieces
  int lo_words;    // one lo buffer: rows + 1 words
  int op_bytes;    // the walk's ops, one byte each, last op of the path first
  int warp_bytes;
};

Layout make_layout(int band, int ops_max, int maxrun) {
  Layout L;
  L.rows = kWindowBytes / band;
  L.rows = L.rows < 1 ? 1 : (L.rows > kMaxRows ? kMaxRows : L.rows);
  // up to 15 bytes before the window's first byte and 15 after its last
  L.win_bytes = ((L.rows * band + 15) & ~15) + 16;
  L.lo_words = (L.rows + 1 + 3) & ~3;
  L.op_bytes = (ops_max + 15) & ~15;
  L.warp_bytes = kStages * (L.win_bytes + 4 * L.lo_words) + L.op_bytes + ((4 * maxrun + 15) & ~15);
  return L;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Starts the copy of the pair's payload rows [a, b) and of lo[a..b] into one
// stage's buffers, and commits it as one group.  `pb` is the pair's payload,
// [p_first, p_end) the whole payload tensor.
__device__ __forceinline__ void fetch_window(const uint8_t* pb, const int* lob, int a, int b,
                                             int band, uintptr_t p_first, uintptr_t p_end,
                                             uint8_t* win, int* wlo, int lane) {
  const uintptr_t g0 = (uintptr_t)pb + (size_t)a * band, g1 = (uintptr_t)pb + (size_t)b * band;
  const uintptr_t base = g0 & ~(uintptr_t)15;
  const int pieces = (int)((g1 - base + 15) >> 4);
  const uint32_t dst = shared_addr(win);
  for (int c = lane; c < pieces; c += 32) {
    const uintptr_t src = base + 16 * (uintptr_t)c;
    if (src >= p_first && src + 16 <= p_end) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + 16 * c), "l"(src)
                   : "memory");
    } else {
      for (int i = 0; i < 16; ++i)
        if (src + i >= p_first && src + i < p_end) win[16 * c + i] = *(const uint8_t*)(src + i);
    }
  }
  const uint32_t dst_lo = shared_addr(wlo);
  for (int i = lane; i <= b - a; i += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst_lo + 4 * i),
                 "l"(lob + a + i)
                 : "memory");
  cp_async_commit();
}

// Writes one CIGAR row: out[k] = runs[k] for k < n, 0 up to maxrun.
__device__ __forceinline__ void write_row(int* out, const int* runs, int n, int maxrun, int lane) {
  auto val = [&](int k) { return k < n ? runs[k] : 0; };
  int head = (int)(((16 - ((uintptr_t)out & 15)) & 15) >> 2);  // words before the first vector
  head = head < maxrun ? head : maxrun;
  const int nvec = (maxrun - head) >> 2;
  const int tail = head + 4 * nvec;
  if (lane < head) out[lane] = val(lane);
  int4* vec = reinterpret_cast<int4*>(out + head);
  for (int i = lane; i < nvec; i += 32) {
    const int k = head + 4 * i;
    vec[i] = make_int4(val(k), val(k + 1), val(k + 2), val(k + 3));
  }
  if (lane < maxrun - tail) out[tail + lane] = val(tail + lane);
}

__global__ void __launch_bounds__(32 * kWarps)
sw_walk_kernel(const uint8_t* __restrict__ payload, const int* __restrict__ lo,
               const int* __restrict__ score, const int* __restrict__ ri,
               const int* __restrict__ bj, int B, int Lq, int band, int ops_max, int maxrun,
               int* __restrict__ cigar, int* __restrict__ meta, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  unsigned char* mine = smem + (size_t)warp * L.warp_bytes;
  uint8_t* win = mine;
  int* wlo = reinterpret_cast<int*>(mine + kStages * L.win_bytes);
  uint8_t* ops = reinterpret_cast<uint8_t*>(wlo + kStages * L.lo_words);
  int* runs = reinterpret_cast<int*>(ops + L.op_bytes);

  const uint8_t* pb = payload + (size_t)b * Lq * band;
  const int* lob = lo + (size_t)b * (Lq + 1);
  int* cg = cigar + (size_t)b * maxrun;
  const int r0 = ri[b], j0 = bj[b];
  const int t_end = lob[min(max(r0, 0), Lq)] + j0 + 1;

  int n_runs = 0, cnt = 0, nm = 0, nins = 0, ndel = 0;
  if (score[b] > 0) {
    // a start row of 0 reads row 0 for one op (the plain version's clamp)
    const int top = max(r0, 1);
    const int omax = r0 >= 1 ? ops_max : 1;
    const int W = L.rows;
    const int nwin = (top + W - 1) / W;
    const uintptr_t p_first = (uintptr_t)payload;
    const uintptr_t p_end = p_first + (size_t)B * Lq * band;
    auto fetch = [&](int k) {
      if (k < nwin) {
        const int hi = top - k * W, s = k % kStages;
        fetch_window(pb, lob, max(hi - W, 0), hi, band, p_first, p_end, win + s * L.win_bytes,
                     wlo + s * L.lo_words, lane);
      } else {
        cp_async_commit();  // an empty group, so that the count of groups stays the window's
      }
    };
    for (int k = 0; k < kStages - 1; ++k) fetch(k);

    int r = top, j = j0, st = ST_H;
    bool done = false;
    for (int k = 0; k < nwin && !done; ++k) {
      fetch(k + kStages - 1);
      cp_async_wait<kStages - 1>();  // window k has landed
      __syncwarp();
      const int hi = top - k * W, a = max(hi - W, 0), s = k % kStages;
      const uint8_t* wb = win + s * L.win_bytes + (((uintptr_t)pb + (size_t)a * band) & 15);
      const int* wl = wlo + s * L.lo_words;  // wl[x] = lo[a + x]
      for (;;) {
        int x = r - a;  // rows of this window at and under the walk's row, >= 1
        if (st == ST_H) {
          // Lane k looks at the cell the walk reaches after k diagonal
          // steps: row r - 1 - k, band cell j + lo[r] - lo[r - k] - k.  The
          // leading lanes whose cells lie in the window, in the band and
          // under ops_max and say "diagonal from H" (use_g, G != 0, G != F)
          // are steps the walk takes; they are taken at once.
          const bool in = lane < x;
          const int jk = j + wl[x] - wl[in ? x - lane : 0] - lane;
          const bool at = in && (unsigned)jk < (unsigned)band && cnt + lane < omax;
          const int pk = at ? wb[(x - 1 - lane) * band + jk] : 0;
          const unsigned m = __ballot_sync(kFull, at && (pk & 7) == 1);
          const int n = m == kFull ? 32 : __ffs(~m) - 1;
          if (n > 0) {
            if (lane < n) ops[cnt + lane] = (uint8_t)((pk >> 3) & 4);  // op 0, its mismatch bit
            j += wl[x] - wl[x - n] - n;
            r -= n;
            x -= n;
            cnt += n;
            if ((unsigned)j >= (unsigned)band || cnt >= omax) {
              done = true;
              break;
            }
            if (x <= 0) {
              done = r <= 0;
              break;
            }
            if (n == 32) continue;
          }
        }
        // one step of the state machine, whatever the state
        const int p = wb[(x - 1) * band + j];
        const int up = j + wl[x] - wl[x - 1];
        const int s1 = st == ST_H ? ST_E - (p & 1) : st;  // H goes to G (use_g) or E
        if (s1 == ST_G && (p & 2)) {  // G == 0: the local alignment starts here
          done = true;
          break;
        }
        const int op = s1 == ST_E ? 2 : (s1 == ST_F || (p & 4)) ? 1 : 0;
        ops[cnt++] = (uint8_t)(op | ((p >> 3) & 4));  // bit 2: a mismatch (payload bit 5)
        if (op == 2) {
          st = ((p & 8) && j >= 1) ? ST_G : ST_E;
          j -= 1;
        } else {
          st = (op == 0 || ((p & 16) && up < band)) ? ST_H : ST_F;
          j = up - (op == 0);
          r -= 1;
        }
        if ((unsigned)j >= (unsigned)band || cnt >= omax) {
          done = true;
          break;
        }
        if (r <= a) {
          done = r <= 0;
          break;
        }
      }
      __syncwarp();  // every lane is through with this stage before it is refilled
    }
    // copies still in flight when the walk stopped early must land before the
    // warp leaves
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();

    // Run-length encoding, forward: element i of the path is ops[cnt - 1 - i].
    // A chunk of 32 elements at a time; `open` is the run that the chunk
    // before left unfinished: it started at open_start, its op is open_op,
    // and it is run n_runs - 1.
    int open_start = 0, open_op = -1;
    const unsigned lt_mask = (1u << lane) - 1;
    for (int base = 0; base < cnt; base += 32) {
      const int i = base + lane;
      const bool in = i < cnt;
      const int v = in ? ops[cnt - 1 - i] : 0;
      const int o = v & 3;
      int before = __shfl_up_sync(kFull, o, 1);
      if (lane == 0) before = open_op;
      const bool starts = in && o != before;
      const unsigned m = __ballot_sync(kFull, starts);
      nm += __popc(__ballot_sync(kFull, in && (o != 0 || (v & 4))));
      nins += __popc(__ballot_sync(kFull, in && o == 1));
      ndel += __popc(__ballot_sync(kFull, in && o == 2));
      if (m == 0) continue;  // the open run goes on
      const int first = __ffs(m) - 1, last = 31 - __clz(m);
      if (open_op >= 0 && lane == first && n_runs - 1 < maxrun)
        runs[n_runs - 1] = ((i - open_start) << 4) | open_op;
      const unsigned above = lane == 31 ? 0u : m & ~((2u << lane) - 1);  // run starts after this lane
      const int mine_k = n_runs + __popc(m & lt_mask);
      if (starts && above && mine_k < maxrun) runs[mine_k] = ((__ffs(above) - 1 - lane) << 4) | o;
      n_runs += __popc(m);
      open_start = base + last;
      open_op = __shfl_sync(kFull, o, last);
    }
    if (open_op >= 0 && lane == 0 && n_runs - 1 < maxrun)
      runs[n_runs - 1] = ((cnt - open_start) << 4) | open_op;
    __syncwarp();
  }
  write_row(cg, runs, n_runs <= maxrun ? n_runs : 0, maxrun, lane);

  // n_runs, q_start, q_end, t_start, t_end, nm: one 24-byte row
  const int q_start = r0 - (cnt - ndel), t_start = t_end - (cnt - nins);
  const int m = lane == 0 ? n_runs : lane == 1 ? q_start : lane == 2 ? r0
              : lane == 3 ? t_start : lane == 4 ? t_end : nm;
  if (lane < 6) meta[(size_t)b * 6 + lane] = m;
}


// Shared memory of one warp, or -1 where the shape is invalid or no block can
// hold it.
int warp_bytes_or_fail(int band, int ops_max, int maxrun) {
  if (band < 1 || maxrun < 1 || ops_max < 1) return -1;
  if (band > kMaxShared || ops_max > kMaxShared || maxrun > kMaxShared / 4) return -1;
  const int bytes = make_layout(band, ops_max, maxrun).warp_bytes;
  return bytes <= kMaxShared ? bytes : -1;
}

}  // namespace

// Shared memory that one pair's warp needs at these sizes: three payload
// windows with their lo words, ops_max op bytes and maxrun run words.  -1 when
// a size is under 1 or the sum exceeds a block's 227 KB, which is ops_max near
// 200,000 at maxrun 512: sw_walk_launch refuses such a launch, and the wrapper
// asks here first so that it can say why.  Four warps share a block while
// their buffers fit it, so the resident warps per SM fall as ops_max grows.
extern "C" int sw_walk_warp_bytes(int band, int ops_max, int maxrun) {
  return warp_bytes_or_fail(band, ops_max, maxrun);
}

// Launches kernel 2 on `stream` over B pairs.  Device pointers to contiguous
// tensors: payload (B, Lq, band) uint8, lo (B, Lq+1) int32, score / ri / bj
// (B,) int32 with ri in 0..Lq and bj in 0..band-1; outputs cigar (B, maxrun)
// int32 holding the packed u32 runs and meta (B, 6) int32: n_runs, q_start,
// q_end, t_start, t_end, nm.  Allocates nothing and does not synchronise.
// Returns cudaGetLastError(), or cudaErrorInvalidValue when Lq < 1 or
// sw_walk_warp_bytes() gives -1.
extern "C" int sw_walk_launch(const unsigned char* payload, const int* lo,
                              const int* score, const int* ri, const int* bj, int B,
                              int Lq, int band, int ops_max, int maxrun, int* cigar,
                              int* meta, void* stream) {
  if (B <= 0) return 0;
  if (Lq < 1 || warp_bytes_or_fail(band, ops_max, maxrun) < 0) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(band, ops_max, maxrun);
  int warps = kWarps;
  while (warps > 1 && warps * L.warp_bytes > kMaxShared) warps >>= 1;
  const int bytes = warps * L.warp_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + warps - 1) / warps);
  sw_walk_kernel<<<grid, 32 * warps, bytes, (cudaStream_t)stream>>>(
      payload, lo, score, ri, bj, B, Lq, band, ops_max, maxrun, cigar, meta, L);
  return (int)cudaGetLastError();
}
