// Fused GroupNorm + LeakyReLU for NHWC activations, Hopper (sm_90a): the
// forward (K1) and the backward (K2), one kernel template for both.
//
// K1 replaces the Pallas TPU kernel video_gcp_tpu/ops/fused_gn.py:_gn_lrelu_kernel
// (pallas_call in _gn_lrelu_pallas). Per (sample, group): float32 mean and
// variance as E[x^2] - E[x]^2 clipped at 0, then
//   y32 = (x - mean) * rsqrt(var + eps) * scale + bias,
// cast to the storage type, then LeakyReLU with the sign taken from y32:
//   out = y32 >= 0 ? T(y32) : T(slope * float(T(y32))).
// K2 replaces _gn_lrelu_bwd_kernel (pallas_call in _gn_lrelu_bwd_pallas).
// Given x and dy:
//   mean, rstd recomputed from x (float32, fast variance clipped at 0),
//   x^ = (x - mean) * rstd,  y_pre = x^ * scale + bias  (float32),
//   dyp = y_pre >= 0 ? dy : slope * dy,  dx^ = dyp * scale,
//   dx = rstd * (dx^ - sum_g(dx^) / m - x^ * sum_g(dx^ * x^) / m),
//   dscale[c] = sum_{n,h,w} dyp * x^,  dbias[c] = sum_{n,h,w} dyp.
//
// Bound: memory. ~10 (K1) or ~20 (K2) flops per element against 2 (K1) or 3
// (K2) * sizeof(T) bytes per element that must move, far below the H100's
// ~20 flops/byte f32 ridge. The floor is those bytes over 3.35 TB/s.
//
// Design: each element of x (and dy) is read from device memory once and
// each output element written once.
// - The sample stays on chip. A CTA copies its span of x (and dy) into
//   dynamic shared memory with one cp.async.bulk per tensor (TMA's 1-D bulk
//   copy, issued by one thread, completion on an mbarrier), then makes every
//   pass over the statistics, the gradient sums and the output from shared
//   memory. A span is at most 64 KB, so three CTAs share an SM and one's
//   loads overlap another's stores.
// - A sample larger than that is split across a thread-block cluster of 2-8
//   CTAs (K1 [16352,64,64,16] bf16: 2; K2 [2032,64,64,16] bf16: 4). Each CTA
//   holds one slice; the per-group partial sums go through distributed
//   shared memory (map_shared_rank) and are summed in rank order, so every
//   CTA of the cluster gets the same statistics.
// - Small samples (the deep pyramid sites, 256-4,096 elements) are packed:
//   a CTA holds several samples, one team of warps each.
// - Accesses are 16 bytes a thread (float4, or 8 bf16) from shared memory
//   and for the stores. The instance with V = 1 takes what cannot be read
//   16 bytes at a time (C = 6, a view at an odd offset): it fills the cache
//   element by element and is otherwise the same kernel.
// - A team's threads step by team * V elements, a multiple of C, so each
//   thread keeps the same V channels for the whole sample: per-channel sums
//   stay in registers, a butterfly of warp shuffles joins the lanes that
//   share channels, and a fixed-order pass over shared memory gives the
//   per-channel and per-group sums (no atomics).
// - K2 takes one launch. Each CTA writes its per-channel dscale and dbias
//   sums to a float32 workspace row; an integer ticket finds the last CTA
//   of each group of fin_group CTAs, which sums the group's rows, and the
//   last of those sums the group rows. The plan takes one group (one level)
//   when all rows fit in 32 KB, else about sqrt(CTAs) CTAs a group. The order of every sum is fixed by
//   the launch plan, so the parameter gradients are the same from run to
//   run. The tickets are reset to 0 by the CTA that finds them full.
// The launch plan (threads, team, samples per CTA, cluster size, shuffle
// span, dynamic shared memory, K2's row-sum group) is computed in Python by
// video_gcp_torch/ops/fused_gn.py:launch_plan and checked here.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxGroups = 8;
constexpr int kMaxCluster = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void from_float(float& out, float v) { out = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& out, float v) {
  out = __float2bfloat16(v);
}

__device__ __forceinline__ void lrelu(float& out, float y32, float slope) {
  out = y32 >= 0.f ? y32 : slope * y32;
}
__device__ __forceinline__ void lrelu(__nv_bfloat16& out, float y32,
                                      float slope) {
  const __nv_bfloat16 y = __float2bfloat16(y32);
  out = y32 >= 0.f ? y : __float2bfloat16(slope * __bfloat162float(y));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Bytes of dynamic shared memory a plan needs (fused_gn.py:launch_plan
// computes the same).
__host__ __device__ inline int64_t smem_bytes(int nin, int spb, int len,
                                              int item, int threads, int c,
                                              int groups, int shfl, int vec,
                                              bool bwd) {
  const int64_t cache = (static_cast<int64_t>(nin) * spb * len * item + 15) / 16 * 16;
  const int64_t fin = bwd ? (4 * threads > 2 * c ? 4 * threads : 2 * c) : 0;
  const int64_t floats = 2LL * (threads / 32) * shfl * vec + 2LL * spb * c +
                         4LL * spb * groups + 4LL * groups + fin;
  return cache + 4 * floats;
}

// Per-thread sums a[k], b[k] of channel (c0 + k) % c -> per (team, channel)
// sums in chan_a, chan_b [spb][c], in a fixed order. Lanes l and l ^ off,
// off >= shfl, hold the same channels; each warp then leaves shfl * V sums,
// and entry e of a team's run of entries belongs to channel e % c.
template <int V>
__device__ __forceinline__ void channel_sums(float (&a)[V], float (&b)[V],
                                             float* red_a, float* red_b,
                                             float* chan_a, float* chan_b,
                                             int c, int team, int shfl) {
  for (int off = 16; off >= shfl; off >>= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], off);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = shfl * V;
  if (lane < shfl) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red_a[warp * per_warp + lane * V + k] = a[k];
      red_b[warp * per_warp + lane * V + k] = b[k];
    }
  }
  __syncthreads();
  const int tm = threadIdx.x / team, lt = threadIdx.x % team;
  const int per_team = team / 32 * per_warp;
  const float* ra = red_a + tm * per_team;
  const float* rb = red_b + tm * per_team;
  for (int ch = lt; ch < c; ch += team) {
    float sa = 0.f, sb = 0.f;
    for (int e = ch; e < per_team; e += c) {
      sa += ra[e];
      sb += rb[e];
    }
    chan_a[tm * c + ch] = sa;
    chan_b[tm * c + ch] = sb;
  }
  __syncthreads();
}

// Per (team, group) sums of chan_a, chan_b (each channel times w[ch] when w
// is given) into out_a, out_b [spb][groups]; in a cluster (one sample, spb
// 1) the CTAs' partials are exchanged through `part` [2][groups] and summed
// in rank order.
__device__ __forceinline__ void group_totals(const float* chan_a,
                                             const float* chan_b,
                                             const float* __restrict__ w,
                                             float* part, float* out_a,
                                             float* out_b, int c, int groups,
                                             int spb, int cluster) {
  const int cpg = c / groups;
  for (int i = threadIdx.x; i < spb * groups; i += blockDim.x) {
    const int tm = i / groups, g = i % groups;
    float sa = 0.f, sb = 0.f;
    for (int ch = g * cpg; ch < (g + 1) * cpg; ++ch) {
      const float f = w ? w[ch] : 1.f;
      sa += chan_a[tm * c + ch] * f;
      sb += chan_b[tm * c + ch] * f;
    }
    if (cluster == 1) {
      out_a[i] = sa;
      out_b[i] = sb;
    } else {
      part[g] = sa;
      part[groups + g] = sb;
    }
  }
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      float sa = 0.f, sb = 0.f;
      for (int r = 0; r < cluster; ++r) {
        const float* p = cl.map_shared_rank(part, r);
        sa += p[g];
        sb += p[groups + g];
      }
      out_a[g] = sa;
      out_b[g] = sb;
    }
  }
  __syncthreads();
}

// dst[o] = sum_r src[r * width + o] over `rows` rows, in an order fixed by
// blockDim.x; width is a multiple of 4 and src, dst 16-byte aligned (C
// even) or not (C odd, then one float at a time); scratch holds
// max(4 * blockDim.x, width) floats. The loads of a thread are independent and
// unrolled; their sums are added in row order.
template <int W>
__device__ __forceinline__ void sum_rows_w(const float* src, int rows,
                                           int width, float* dst,
                                           float* scratch) {
  using Chunk = Vec<float, W>;
  const int units = width / W;
  const int parts = max(1, static_cast<int>(blockDim.x) / units);
  const Chunk* s = reinterpret_cast<const Chunk*>(src);
  for (int i = threadIdx.x; i < parts * units; i += blockDim.x) {
    const int u = i % units, p = i / units;
    Chunk acc;
#pragma unroll
    for (int k = 0; k < W; ++k) acc.v[k] = 0.f;
#pragma unroll 8
    for (int r = p; r < rows; r += parts) {
      Chunk v;
      if constexpr (W == 4) {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(s + static_cast<int64_t>(r) * units + u));
        v.v[0] = f.x; v.v[1] = f.y; v.v[2] = f.z; v.v[3] = f.w;
      } else {
        v.v[0] = __ldcg(src + static_cast<int64_t>(r) * width + u);
      }
#pragma unroll
      for (int k = 0; k < W; ++k) acc.v[k] += v.v[k];
    }
#pragma unroll
    for (int k = 0; k < W; ++k) scratch[p * width + u * W + k] = acc.v[k];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < width; o += blockDim.x) {
    float t = 0.f;
    for (int p = 0; p < parts; ++p) t += scratch[p * width + o];
    dst[o] = t;
  }
}

__device__ __forceinline__ void sum_rows(const float* src, int rows, int width,
                                         float* dst, float* scratch) {
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    sum_rows_w<4>(src, rows, width, dst, scratch);
  } else {
    sum_rows_w<1>(src, rows, width, dst, scratch);
  }
}

// The body of both kernels: K1 (kBwd false) writes y, K2 writes dx and the
// parameter gradients.
template <typename T, int V, bool kBwd>
__device__ __forceinline__ void gn_lrelu_body(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ tickets,
    int64_t n, int64_t per_sample, int c, int groups, int team, int spb,
    int cluster, int shfl, int fin_group, float eps, float slope) {
  using VecT = Vec<T, V>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int last;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rank = blockIdx.x % cluster;
  const int64_t first = static_cast<int64_t>(blockIdx.x / cluster) * spb;
  const int nvalid = static_cast<int>(n - first < spb ? n - first : spb);
  const int len = static_cast<int>(per_sample / cluster);  // elements of a slice
  const int tm = tid / team, lt = tid % team;
  const bool valid = tm < nvalid;
  const int64_t src = first * per_sample + static_cast<int64_t>(rank) * len;

  T* cx = reinterpret_cast<T*>(smem);
  T* cdy = cx + spb * len;
  const int64_t cache = (static_cast<int64_t>(kBwd ? 2 : 1) * spb * len * sizeof(T) + 15) / 16 * 16;
  const int per_warp = shfl * V;
  float* red_a = reinterpret_cast<float*>(smem + cache);
  float* red_b = red_a + (nthreads / 32) * per_warp;
  float* chan_a = red_b + (nthreads / 32) * per_warp;
  float* chan_b = chan_a + spb * c;
  float* sum_s = chan_b + spb * c;  // [spb][groups] each
  float* sq_s = sum_s + spb * groups;
  float* s2_s = sq_s + spb * groups;
  float* s1_s = s2_s + spb * groups;
  float* part = s1_s + spb * groups;  // [2 exchanges][2][groups]
  float* fin = part + 4 * groups;

  // 1. The CTA's span of x (and dy) into shared memory: read once.
  const int span = nvalid * len;
  if constexpr (V > 1) {
    const uint32_t b = smem_u32(&bar);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(span * sizeof(T));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"((kBwd ? 2u : 1u) * bytes)
                   : "memory");
      bulk_load(cx, x + src, bytes, b);
      if constexpr (kBwd) bulk_load(cdy, dy + src, bytes, b);
    }
    mbar_wait(b, 0);
  } else {
    for (int i = tid; i < span; i += nthreads) {
      cx[i] = x[src + i];
      if constexpr (kBwd) cdy[i] = dy[src + i];
    }
    __syncthreads();
  }

  // This thread's channels: (c0 + k) % c for every vector it touches.
  const int cpg = c / groups;
  const int c0 = static_cast<int>((static_cast<int64_t>(lt) * V) % c);
  const int nvec = len / V;
  const VecT* vx = reinterpret_cast<const VecT*>(cx + tm * len);

  // 2. Statistics.
  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
  if (valid) {
#pragma unroll 4
    for (int j = lt; j < nvec; j += team) {
      const VecT v = vx[j];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_float(v.v[k]);
        a[k] += f;
        b[k] += f * f;
      }
    }
  }
  channel_sums<V>(a, b, red_a, red_b, chan_a, chan_b, c, team, shfl);
  group_totals(chan_a, chan_b, nullptr, part, sum_s, sq_s, c, groups, spb,
               cluster);

  const float m = static_cast<float>(per_sample / groups);
  float mu[V], rs[V], sc[V], bi[V];
  int gi[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = (c0 + k) % c;
    gi[k] = tm * groups + ch / cpg;
    const float mean = sum_s[gi[k]] / m;
    const float var = fmaxf(sq_s[gi[k]] / m - mean * mean, 0.f);
    mu[k] = mean;
    rs[k] = rsqrtf(var + eps);
    sc[k] = scale[ch];
    bi[k] = bias[ch];
  }
  T* os = out + src + static_cast<int64_t>(tm) * len;

  if constexpr (!kBwd) {
    // 3. Normalize from shared memory, write once.
    if (valid) {
#pragma unroll 4
      for (int j = lt; j < nvec; j += team) {
        const VecT v = vx[j];
        VecT o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float y32 = (to_float(v.v[k]) - mu[k]) * rs[k] * sc[k] + bi[k];
          lrelu(o.v[k], y32, slope);
        }
        reinterpret_cast<VecT*>(os)[j] = o;
      }
    }
    if (cluster > 1) cg::this_cluster().sync();  // peers done reading `part`
    return;
  } else {
    // 3. Per-channel sums of dyp * x^ (a) and dyp (b).
    const VecT* vd = reinterpret_cast<const VecT*>(cdy + tm * len);
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    if (valid) {
#pragma unroll 4
      for (int j = lt; j < nvec; j += team) {
        const VecT v = vx[j], d = vd[j];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (to_float(v.v[k]) - mu[k]) * rs[k];
          const float g = to_float(d.v[k]);
          const float dyp = xh * sc[k] + bi[k] >= 0.f ? g : slope * g;
          a[k] += dyp * xh;
          b[k] += dyp;
        }
      }
    }
    channel_sums<V>(a, b, red_a, red_b, chan_a, chan_b, c, team, shfl);
    // this CTA's dscale and dbias row, its teams summed in order
    float* row = ws + static_cast<int64_t>(blockIdx.x) * 2 * c;
    for (int ch = tid; ch < c; ch += nthreads) {
      float sa = 0.f, sb = 0.f;
      for (int t = 0; t < nvalid; ++t) {
        sa += chan_a[t * c + ch];
        sb += chan_b[t * c + ch];
      }
      row[ch] = sa;
      row[c + ch] = sb;
    }
    // group sums of dx^ * x^ (s2) and dx^ (s1)
    group_totals(chan_a, chan_b, scale, part + 2 * groups, s2_s, s1_s, c,
                 groups, spb, cluster);

    // 4. dx from shared memory, written once.
    if (valid) {
      float s1[V], s2[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] = s1_s[gi[k]] / m;
        s2[k] = s2_s[gi[k]] / m;
      }
#pragma unroll 4
      for (int j = lt; j < nvec; j += team) {
        const VecT v = vx[j], d = vd[j];
        VecT o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (to_float(v.v[k]) - mu[k]) * rs[k];
          const float g = to_float(d.v[k]);
          const float dyp = xh * sc[k] + bi[k] >= 0.f ? g : slope * g;
          from_float(o.v[k], rs[k] * (dyp * sc[k] - s1[k] - xh * s2[k]));
        }
        reinterpret_cast<VecT*>(os)[j] = o;
      }
    }
    if (cluster > 1) cg::this_cluster().sync();  // peers done reading `part`

    // 5. dscale, dbias: the last CTA of each group of fin_group sums their
    // rows, the last of those sums the group rows.
    __threadfence();
    __syncthreads();
    const int ctas = gridDim.x, grp = blockIdx.x / fin_group;
    const int in_grp = min(fin_group, ctas - grp * fin_group);
    const int ngrp = (ctas + fin_group - 1) / fin_group;
    if (tid == 0) last = atomicAdd(tickets + grp, 1) == in_grp - 1;
    __syncthreads();
    if (!last) return;
    if (tid == 0) tickets[grp] = 0;
    __threadfence();
    float* result = ws + (static_cast<int64_t>(ctas) + ngrp) * 2 * c;
    sum_rows(ws + static_cast<int64_t>(grp) * fin_group * 2 * c, in_grp, 2 * c,
             ngrp == 1 ? result : ws + (static_cast<int64_t>(ctas) + grp) * 2 * c, fin);
    if (ngrp == 1) return;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + ngrp, 1) == ngrp - 1;
    __syncthreads();
    if (!last) return;
    if (tid == 0) tickets[ngrp] = 0;
    __threadfence();
    sum_rows(ws + static_cast<int64_t>(ctas) * 2 * c, ngrp, 2 * c, result, fin);
  }
}

#define GN_KERNEL_PARAMS                                                     \
  const T *__restrict__ x, const T *__restrict__ dy,                        \
      const float *__restrict__ scale, const float *__restrict__ bias,      \
      T *__restrict__ out, float *__restrict__ ws, int *__restrict__ tickets, \
      int64_t n, int64_t per_sample, int c, int groups, int team, int spb,  \
      int cluster, int shfl, int fin_group, float eps, float slope
#define GN_KERNEL_ARGS                                                      \
  x, dy, scale, bias, out, ws, tickets, n, per_sample, c, groups, team, spb, \
      cluster, shfl, fin_group, eps, slope

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
gn_lrelu_fwd_kernel(GN_KERNEL_PARAMS) {
  gn_lrelu_body<T, V, false>(GN_KERNEL_ARGS);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
gn_lrelu_bwd_kernel(GN_KERNEL_PARAMS) {
  gn_lrelu_body<T, V, true>(GN_KERNEL_ARGS);
}

// plan: {vec, threads, team, samples per CTA, cluster, shfl, smem bytes,
// fin_group}
enum { kVec, kThreads, kTeam, kSpb, kCluster, kShfl, kSmem, kFinGroup };

template <typename T, int V, bool kBwd>
int launch(const void* x, const void* dy, const void* scale, const void* bias,
           void* out, void* ws, void* tickets, int64_t n, int64_t per_sample,
           int c, int groups, float eps, float slope, const int* plan,
           void* stream) {
  const int threads = plan[kThreads], team = plan[kTeam], spb = plan[kSpb];
  const int cluster = plan[kCluster], shfl = plan[kShfl], smem = plan[kSmem];
  const int fin_group = plan[kFinGroup];
  const bool pow2_cluster = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  const bool pow2_shfl = shfl > 0 && shfl <= 32 && (shfl & (shfl - 1)) == 0;
  if (n < 0 || per_sample <= 0 || c <= 0 || groups <= 0 ||
      groups > kMaxGroups || c % groups != 0 || per_sample % c != 0 ||
      team <= 0 || team % 32 != 0 || spb <= 0 || threads != team * spb ||
      threads > kMaxThreads || !pow2_cluster || cluster > kMaxCluster ||
      (cluster > 1 && spb != 1) || per_sample % cluster != 0 || !pow2_shfl ||
      (static_cast<int64_t>(team) * V) % c != 0 || fin_group <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t len = per_sample / cluster;
  if (len % c != 0 || len % V != 0 ||
      smem < smem_bytes(kBwd ? 2 : 1, spb, static_cast<int>(len), sizeof(T),
                        threads, c, groups, shfl, V, kBwd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (V > 1) {
    for (const void* p : {x, dy, static_cast<const void*>(out)}) {
      if (p && reinterpret_cast<uintptr_t>(p) % 16 != 0) {
        return static_cast<int>(cudaErrorMisalignedAddress);
      }
    }
  }
  const int64_t ctas = (n + spb - 1) / spb * cluster;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (ctas == 0) return 0;

  constexpr auto kernel = kBwd ? gn_lrelu_bwd_kernel<T, V> : gn_lrelu_fwd_kernel<T, V>;
  if (const int e = allow_smem<kernel>(smem)) return e;
  if (cluster == 1) {  // a plain launch: no cluster to set up
    kernel<<<static_cast<unsigned>(ctas), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(out), static_cast<float*>(ws),
        static_cast<int*>(tickets), n, per_sample, c, groups, team, spb,
        cluster, shfl, fin_group, eps, slope);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(ws), static_cast<int*>(tickets),
      n, per_sample, c, groups, team, spb, cluster, shfl, fin_group, eps, slope);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBwd>
int dispatch(const void* x, const void* dy, const void* scale,
             const void* bias, void* out, void* ws, void* tickets, int64_t n,
             int64_t per_sample, int c, int groups, float eps, float slope,
             const int* plan, void* stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (plan[kVec] == kWide) {
    return launch<T, kWide, kBwd>(x, dy, scale, bias, out, ws, tickets, n,
                                  per_sample, c, groups, eps, slope, plan,
                                  stream);
  }
  if (plan[kVec] == 1) {
    return launch<T, 1, kBwd>(x, dy, scale, bias, out, ws, tickets, n,
                              per_sample, c, groups, eps, slope, plan, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: [n, H, W, C] contiguous; per_sample = H*W*C; scale, bias: float32
// [C]; plan: 8 ints from fused_gn.py:launch_plan.
extern "C" int gn_lrelu_fwd_f32(const void* x, const void* scale,
                                const void* bias, void* y, int64_t n,
                                int64_t per_sample, int c, int groups,
                                float eps, float slope, const int* plan,
                                void* stream) {
  return dispatch<float, false>(x, nullptr, scale, bias, y, nullptr, nullptr,
                                n, per_sample, c, groups, eps, slope, plan,
                                stream);
}

extern "C" int gn_lrelu_fwd_bf16(const void* x, const void* scale,
                                 const void* bias, void* y, int64_t n,
                                 int64_t per_sample, int c, int groups,
                                 float eps, float slope, const int* plan,
                                 void* stream) {
  return dispatch<__nv_bfloat16, false>(x, nullptr, scale, bias, y, nullptr,
                                        nullptr, n, per_sample, c, groups, eps,
                                        slope, plan, stream);
}

// x, dy, dx: [n, H, W, C] contiguous; ws: float32 [(ctas + ceil(ctas /
// fin_group) + 1) * 2C], whose last 2C floats receive dscale then dbias;
// tickets: int32 [ceil(ctas / fin_group) + 1], zero, left zero.
extern "C" int gn_lrelu_bwd_f32(const void* x, const void* dy,
                                const void* scale, const void* bias, void* dx,
                                void* ws, void* tickets, int64_t n,
                                int64_t per_sample, int c, int groups,
                                float eps, float slope, const int* plan,
                                void* stream) {
  return dispatch<float, true>(x, dy, scale, bias, dx, ws, tickets, n,
                               per_sample, c, groups, eps, slope, plan, stream);
}

extern "C" int gn_lrelu_bwd_bf16(const void* x, const void* dy,
                                 const void* scale, const void* bias,
                                 void* dx, void* ws, void* tickets, int64_t n,
                                 int64_t per_sample, int c, int groups,
                                 float eps, float slope, const int* plan,
                                 void* stream) {
  return dispatch<__nv_bfloat16, true>(x, dy, scale, bias, dx, ws, tickets, n,
                                       per_sample, c, groups, eps, slope, plan,
                                       stream);
}
