// The evaluation DTW in one launch, Hopper (sm_90a): K4.
//
// Replaces no Pallas kernel: the JAX package runs this DP and its traceback
// as XLA scans (video_gcp_tpu/ops/dtw.py: min_cumsum and the traceback scan
// of batched_dtw_alignment), which the port ran as plain torch, about 19,000
// small launches a call at [16, 511, 500]. K4 computes all of
// video_gcp_torch/ops/dtw.py:batched_dtw_alignment for one example a block.
// With the cost C[b] [r, c] float32 and end = ends[b]:
//   D[0, 0] = 0, D[0, j] = D[i, 0] = inf for i, j >= 1,
//   D[i, j] = C[i-1, j-1] + min(D[i-1, j-1], min(D[i-1, j], D[i, j-1])),
// in float32; the traceback from (r, end + 1) to (1, 1) steps to the argmin
// of (D[i-1, j-1], D[i-1, j], D[i, j-1]), ties in that order, clamped at
// (1, 1); each frame (column) takes the visited cell of least D, the later
// visit (the smaller node) on a tie; frames past end repeat inds[end];
//   dist = D[r, end + 1] / ((r + end) + 1.0).
// D, inds and dist equal the torch twin's bit for bit: each cell is the
// same float32 addition of C to the same minimum. C holds no NaN and no
// -inf (a squared distance never does). An end outside [0, c) gives
// inds = 0 and dist = NaN.
//
// Bounds. Bytes: read C once and write the matches, B * r * c * 4 +
// B * c * 8 bytes (16.42 MB, 4.9 us at 3.35 TB/s, at [16, 511, 500]). The
// chain sets the time: the DP is r + c - 1 dependent anti-diagonal steps
// (1,010 at [511, 500]) and the traceback up to r + c - 1 dependent steps,
// each a read of the cell's choice; at 0.1-0.3 us a step that is 0.2-0.6 ms.
// Only 16 of 132 SMs hold an example at B = 16, and more would not
// shorten a chain.
//
// Design: one block of W warps (launch_plan: W = ceil(r / 64), at most 8)
// per example.
// - The DP is a wavefront over the anti-diagonals. A lane holds V = 2
//   consecutive rows; at step s row rho (of the band) computes column
//   s - rho + 1. Its left neighbour is its own last value, the value above
//   is the row above's last value (the lane's own row, or lane - 1's last
//   row by __shfl_up_sync, or, at a warp's lane 0, the warp above's last
//   row through shared memory under one __syncthreads a step), and the
//   diagonal one is the value above of the previous step. No cell waits on
//   another cell of its step. A step's cost grows with V (a warp issues
//   every cell of its rows) and with W (the barrier). On an H100, V = 4 on
//   4 warps took 1.6x the time of V = 2 on 8 at [16, 511, 500], and V = 1
//   on 4 warps 1.14x that of V = 2 on 2 at [16, 127, 100]. The step has no
//   branch: cells outside the matrix select and store nothing (a first
//   version with branches took 1.2x as long). A minimum of one block in
//   __launch_bounds__ (90 registers and no spill, against 64 and a 12-byte
//   spill) took 1.2x as long.
// - C is read straight from device memory, each row along its own columns:
//   a lane issues every load kAhead = 8 steps before its use, into a ring
//   of registers indexed by the unrolled step, so the loads overlap the
//   chain and a 128-byte line serves 32 steps of a row from L1.
// - Each cell's choice (0 diagonal, 1 up, 2 left: the argmin the traceback
//   takes, which is the comparison the DP makes for its minimum) is packed
//   2 bits a cell, 16 cells a word along a row, in shared memory when
//   r * ceil(c / 16) words fit beside the rest (64 KB at [511, 500]), else
//   in a device scratch.
// - More than W * 32 * V rows run in bands of that many rows, one after the
//   other, each reading the band above's last row from shared memory.
// - D is not kept. One thread follows the choices from (r, end + 1) to
//   (1, 1) and records the path; the block gathers C along it; then one
//   thread walks the path forward from (1, 1) and adds C cell by cell,
//   D[cell] = C[cell] + D[previous cell], which is the DP's own addition,
//   since the DP's minimum at a cell is the D of the cell its choice names.
//   That gives D along the path bit for bit without writing the 16 MB of D
//   (scattered 4-byte stores across the rows) for the ~1,000 cells used.
//   The same walk keeps each column's first least D (the smaller node),
//   and the block writes inds. dp (tests and checks only) receives all of D.
// - No atomics: the result is the same on every run.
// The launch plan (W, the choices in shared memory or not, words a row,
// shared memory) is computed in Python by
// video_gcp_torch/ops/dtw.py:launch_plan and checked here.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kRowsPerLane = 2;  // V
constexpr int kAhead = 8;  // steps a load of C runs ahead of its use
constexpr int kMaxWarps = 8;  // a band of at most 512 rows
constexpr int kMaxNodes = 8192;  // r; a path cell packs (node << 16 | frame)
constexpr int kMaxFrames = 4096;  // c
constexpr int kCellsPerWord = 16;  // 2-bit choices in a 32-bit word
constexpr unsigned kFull = 0xffffffffu;

// plan: {warps, shared, words, smem}
enum { kWarps, kShared, kWords, kSmem };

__host__ __device__ constexpr int64_t align16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory before the choices: the warps' edge exchange [2][kMaxWarps]
// and the path's length, two rows of D at band edges [2][c + 1], the path and
// its costs [r + c] each, and each column's node [c]. The kernel declares no
// static shared memory, so all of kSmemLimit is the plan's.
__host__ __device__ constexpr int64_t exchange_bytes() { return align16(2 * kMaxWarps * 4 + 4); }
__host__ __device__ constexpr int64_t edge_bytes(int c) { return align16(2 * (c + 1) * 4LL); }
__host__ __device__ constexpr int64_t path_bytes(int r, int c) { return align16((r + c) * 4LL); }
__host__ __device__ constexpr int64_t header_bytes(int r, int c) {
  return exchange_bytes() + edge_bytes(c) + 2 * path_bytes(r, c) + align16(c * 4LL);
}

template <bool kSharedChoices, bool kDp>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dtw_align_kernel(const float* __restrict__ C, const int64_t* __restrict__ ends,
                     int64_t* __restrict__ inds, float* __restrict__ dist,
                     uint32_t* __restrict__ scratch, float* __restrict__ dp, int r, int c,
                     int words) {
  constexpr int V = kRowsPerLane;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* at = smem;
  float* xch = reinterpret_cast<float*>(at);
  int& path_len = reinterpret_cast<int*>(at)[2 * kMaxWarps];
  at += exchange_bytes();
  float* edge = reinterpret_cast<float*>(at);
  at += edge_bytes(c);
  uint32_t* path = reinterpret_cast<uint32_t*>(at);
  at += path_bytes(r, c);
  float* path_cost = reinterpret_cast<float*>(at);
  at += path_bytes(r, c);
  int* col_node = reinterpret_cast<int*>(at);
  const int64_t block = blockIdx.x;
  uint32_t* choices;
  if constexpr (kSharedChoices) {
    choices = reinterpret_cast<uint32_t*>(smem + header_bytes(r, c));
  } else {
    choices = scratch + block * r * words;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5, band_rows = blockDim.x * V;
  const float inf = CUDART_INF_F;
  const float* cb = C + block * r * c;
  float* db = kDp ? dp + block * (r + 1) * (c + 1) : nullptr;

  for (int j = tid; j <= c; j += blockDim.x) {  // D[0, :]
    edge[j] = j == 0 ? 0.f : inf;
    if (kDp) db[j] = edge[j];
  }
  if (kDp) {
    for (int i = 1 + tid; i <= r; i += blockDim.x) db[i * (c + 1LL)] = inf;
  }

  // The step's body is free of branches: a cell outside the matrix computes
  // and keeps nothing (selects and predicated stores), and every load of C
  // reads a valid address (the column clamped, rows past r read row r).
  for (int band = 0, i0 = 1; i0 <= r; ++band, i0 += band_rows) {
    const float* above = edge + (band & 1) * (c + 1);  // D[i0 - 1, :]
    float* below = edge + ((band + 1) & 1) * (c + 1);  // this band's last row
    if (tid < 2 * kMaxWarps) xch[tid] = inf;
    if (tid == 0) below[0] = inf;
    __syncthreads();
    const int rho0 = tid * V;  // the band's row of this thread's first row
    const int steps = c + min(band_rows, r - i0 + 1) - 1;
    const float* crow[V];
    uint32_t* chrow[V];
    float* drow[V];
    float left[V], diag[V], ahead[V][kAhead];
    uint32_t bits[V];
    bool row_ok[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = min(i0 + rho0 + k, r);
      row_ok[k] = i0 + rho0 + k <= r;
      crow[k] = cb + (i - 1) * static_cast<int64_t>(c);
      chrow[k] = choices + (i - 1) * static_cast<int64_t>(words);
      drow[k] = kDp ? db + i * (c + 1LL) : nullptr;
      left[k] = inf;
      diag[k] = above[0];  // D[i0 - 1, 0]: read at step 0 by the band's first row alone
      bits[k] = 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        ahead[k][u] = crow[k][min(max(u - (rho0 + k) + 1, 1), c) - 1];
      }
    }
    const bool last_row = rho0 + V - 1 == band_rows - 1;  // writes `below`
    for (int s0 = 0; s0 < steps; s0 += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int s = s0 + u;
        // D[i-1, j] of the lane's first row: the band above's last row, the
        // warp above's last row, or lane - 1's last row (broadcast loads;
        // past column c the value is never used)
        const float edge_up = warp == 0 ? above[min(s + 1, c)]
                                        : xch[((s - 1) & 1) * kMaxWarps + max(warp - 1, 0)];
        const float shuffled = __shfl_up_sync(kFull, left[V - 1], 1);
        float up[V];
        up[0] = lane == 0 ? edge_up : shuffled;
#pragma unroll
        for (int k = 1; k < V; ++k) up[k] = left[k - 1];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int j = s - (rho0 + k) + 1;
          const bool act = row_ok[k] && j >= 1 && j <= c;
          const float d = diag[k], n = up[k], l = left[k];
          const uint32_t ch = (d <= n && d <= l) ? 0u : (n <= l ? 1u : 2u);
          const float v = __fadd_rn(ahead[k][u], ch == 0u ? d : (ch == 1u ? n : l));
          diag[k] = n;
          left[k] = act ? v : l;
          const int q = (j - 1) & (kCellsPerWord - 1);
          const uint32_t word = bits[k] | ch << (2 * q);
          const bool flush = act && (q == kCellsPerWord - 1 || j == c);
          if (flush) chrow[k][(j - 1) / kCellsPerWord] = word;
          bits[k] = flush ? 0u : (act ? word : bits[k]);
          if (k == V - 1 && last_row && act) below[j] = v;
          if (kDp && act) drow[k][j] = v;
          ahead[k][u] = crow[k][min(max(j + kAhead, 1), c) - 1];
        }
        if (warps > 1) {
          if (lane == 31) xch[(s & 1) * kMaxWarps + warp] = left[V - 1];
          __syncthreads();
        }
      }
    }
    __syncthreads();  // `below` and the choices complete before the next band
  }

  // the traceback from (r, end + 1): every step lowers i + j until (1, 1)
  const int64_t end = ends[block];
  const bool valid = end >= 0 && end < c;
  if (tid == 0) {
    int n = 0;
    if (valid) {
      int i = r, j = static_cast<int>(end) + 1;
      path[n++] = static_cast<uint32_t>(i - 1) << 16 | static_cast<uint32_t>(j - 1);
      while ((i > 1 || j > 1) && n < r + c) {
        const uint32_t word = choices[(i - 1) * static_cast<int64_t>(words) +
                                      (j - 1) / kCellsPerWord];
        const uint32_t ch = word >> (2 * ((j - 1) & (kCellsPerWord - 1))) & 3u;
        const int ni = max(i - (ch != 2u), 1), nj = max(j - (ch != 1u), 1);
        if (ni == i && nj == j) break;  // only a NaN in C could stall the walk
        i = ni;
        j = nj;
        path[n++] = static_cast<uint32_t>(i - 1) << 16 | static_cast<uint32_t>(j - 1);
      }
    }
    path_len = n;
  }
  __syncthreads();
  const int n = path_len;
  for (int q = tid; q < n; q += blockDim.x) {
    const uint32_t p = path[q];
    path_cost[q] = cb[(p >> 16) * static_cast<int64_t>(c) + (p & 0xffffu)];
  }
  __syncthreads();
  if (tid == 0) {
    if (valid) {  // forward from (1, 1): D along the path, each column's first least D
      float d = 0.f, best = 0.f;  // D[0, 0]
      int col = -1, node = 0;
#pragma unroll 4
      for (int q = n - 1; q >= 0; --q) {
        d = __fadd_rn(path_cost[q], d);
        const uint32_t p = path[q];
        const int i = static_cast<int>(p >> 16), j = static_cast<int>(p & 0xffffu);
        if (j != col) {
          if (col >= 0) col_node[col] = node;
          col = j;
          best = d;
          node = i;
        } else if (d < best) {
          best = d;
          node = i;
        }
      }
      col_node[col] = node;
      const float denom =
          __fadd_rn(__fadd_rn(static_cast<float>(r), static_cast<float>(end)), 1.0f);
      dist[block] = __fdiv_rn(d, denom);
    } else {
      dist[block] = CUDART_NAN_F;
    }
  }
  __syncthreads();
  int64_t* ib = inds + block * c;
  for (int t = tid; t < c; t += blockDim.x) {
    ib[t] = valid ? col_node[min(t, static_cast<int>(end))] : 0;
  }
}

template <bool kSharedChoices, bool kDp>
int launch(const float* C, const int64_t* ends, int64_t* inds, float* dist, uint32_t* scratch,
           float* dp, int b, int r, int c, int warps, int words, int smem,
           cudaStream_t stream) {
  constexpr auto kernel = dtw_align_kernel<kSharedChoices, kDp>;
  if (const int e = allow_smem<kernel>(smem)) return e;
  kernel<<<b, warps * 32, smem, stream>>>(C, ends, inds, dist, scratch, dp, r, c, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C: float32 [b, r, c] contiguous; ends: int64 [b]; inds: int64 [b, c];
// dist: float32 [b]; scratch: uint32 [b, r, words] for a plan whose choices
// are not in shared memory, else null; dp: float32 [b, r + 1, c + 1] that
// receives D, or null; plan: 4 ints from dtw.py:launch_plan. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int dtw_align_f32(const void* C, const void* ends, void* inds, void* dist,
                             void* scratch, void* dp, int b, int r, int c, const int* plan,
                             void* stream) {
  const int warps = plan[kWarps], shared = plan[kShared], words = plan[kWords];
  const int smem = plan[kSmem];
  if (b < 0 || r < 1 || r > kMaxNodes || c < 1 || c > kMaxFrames || warps < 1 ||
      warps > kMaxWarps || words != (c + kCellsPerWord - 1) / kCellsPerWord ||
      (shared != 0 && shared != 1) || (!shared && !scratch) ||
      smem != header_bytes(r, c) + (shared ? 4LL * r * words : 0) || smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const float* cf = static_cast<const float*>(C);
  const int64_t* e = static_cast<const int64_t*>(ends);
  int64_t* ind = static_cast<int64_t*>(inds);
  float* df = static_cast<float*>(dist);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  float* dpf = static_cast<float*>(dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shared * 2 + (dp ? 1 : 0)) {
    case 3: return launch<true, true>(cf, e, ind, df, sc, dpf, b, r, c, warps, words, smem, s);
    case 2: return launch<true, false>(cf, e, ind, df, sc, dpf, b, r, c, warps, words, smem, s);
    case 1: return launch<false, true>(cf, e, ind, df, sc, dpf, b, r, c, warps, words, smem, s);
    default: return launch<false, false>(cf, e, ind, df, sc, dpf, b, r, c, warps, words, smem, s);
  }
}
