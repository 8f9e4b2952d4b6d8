// Fused GroupNorm + LeakyReLU for NHWC activations, Hopper (sm_90a): the
// forward (K1, below) and the backward (K2, further down).
//
// Forward: replaces the Pallas TPU kernel video_gcp_tpu/ops/fused_gn.py:_gn_lrelu_kernel
// (pallas_call in _gn_lrelu_pallas). Per (sample, group): float32 mean and
// variance as E[x^2] - E[x]^2 clipped at 0, then
//   y32 = (x - mean) * rsqrt(var + eps) * scale + bias,
// cast to the storage type, then LeakyReLU with the sign taken from y32:
//   out = y32 >= 0 ? T(y32) : T(slope * float(T(y32))).
//
// Bound: memory. The work is ~10 flops per element against 2 * sizeof(T)
// bytes per element moved (read x once, write y once), far below the H100's
// ~20 flops/byte f32 ridge. The floor is 2 * N*H*W*C * sizeof(T) bytes over
// 3.35 TB/s.
//
// Design (simple first): one thread block per sample. A sample's H*W*C values
// are contiguous, so pass 1 reads them coalesced and keeps per-thread float32
// sums and sums of squares for up to 8 groups in registers; a warp-shuffle and
// shared-memory reduction gives the group statistics. Pass 2 reads the sample
// again (at most 128 KB, mostly served from the 50 MB L2 shortly after pass 1),
// normalizes and writes. The channel of element i is tracked incrementally
// (no 64-bit modulo in the loop). All offsets are 64-bit: at the largest
// shape, [16352, 64, 64, 16] bf16, byte offsets pass 2^31. There is no matrix
// product, so no wgmma/TMA; a later version can cache the sample in shared
// memory to drop the second read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* out, float v) { *out = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16(v);
}

__device__ __forceinline__ void store_lrelu(float* out, float y32, float slope) {
  *out = y32 >= 0.f ? y32 : slope * y32;
}
__device__ __forceinline__ void store_lrelu(__nv_bfloat16* out, float y32,
                                            float slope) {
  const __nv_bfloat16 y = __float2bfloat16(y32);
  *out = y32 >= 0.f ? y : __float2bfloat16(slope * __bfloat162float(y));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_lrelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ y,
                    int64_t per_sample, int c, int groups, float eps,
                    float slope) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * per_sample;
  const T* xs = x + base;
  T* ys = y + base;
  const int cpg = c / groups;
  const int step_c = kThreads % c;  // channel advance per loop step

  float s[kMaxGroups], q[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    s[g] = 0.f;
    q[g] = 0.f;
  }

  int ch = threadIdx.x % c;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < per_sample; i += kThreads) {
    const float v = to_float(xs[i]);
    const int gi = ch / cpg;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g == gi) {
        s[g] += v;
        q[g] += v * v;
      }
    }
    ch += step_c;
    if (ch >= c) ch -= c;
  }

  __shared__ float partial[kWarps][2 * kMaxGroups];
  __shared__ float stats[2 * kMaxGroups];  // [mean | rstd]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    float a = s[g], b = q[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      partial[warp][g] = a;
      partial[warp][kMaxGroups + g] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < groups) {
    const int g = threadIdx.x;
    float sum = 0.f, sq = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sum += partial[w][g];
      sq += partial[w][kMaxGroups + g];
    }
    const float m = static_cast<float>(per_sample / groups);
    const float mean = sum / m;
    const float var = fmaxf(sq / m - mean * mean, 0.f);
    stats[g] = mean;
    stats[kMaxGroups + g] = rsqrtf(var + eps);
  }
  __syncthreads();

  ch = threadIdx.x % c;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < per_sample; i += kThreads) {
    const int gi = ch / cpg;
    const float v = to_float(xs[i]);
    const float y32 =
        (v - stats[gi]) * stats[kMaxGroups + gi] * scale[ch] + bias[ch];
    store_lrelu(ys + i, y32, slope);
    ch += step_c;
    if (ch >= c) ch -= c;
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           int64_t n, int64_t per_sample, int c, int groups, float eps,
           float slope, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || per_sample <= 0 || c <= 0 || groups <= 0 ||
      groups > kMaxGroups || c % groups != 0 || per_sample % c != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  gn_lrelu_fwd_kernel<T><<<static_cast<unsigned>(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), per_sample, c,
      groups, eps, slope);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward (kernel K2). Replaces the Pallas TPU kernel
// video_gcp_tpu/ops/fused_gn.py:_gn_lrelu_bwd_kernel (pallas_call in
// _gn_lrelu_bwd_pallas). Given x and dy:
//   mean, rstd recomputed from x (float32, fast variance clipped at 0),
//   x^ = (x - mean) * rstd,  y_pre = x^ * scale + bias  (float32),
//   dyp = y_pre >= 0 ? dy : slope * dy,  dx^ = dyp * scale,
//   dx = rstd * (dx^ - sum_g(dx^) / m - x^ * sum_g(dx^ * x^) / m),
//   dscale[c] = sum_{n,h,w} dyp * x^,  dbias[c] = sum_{n,h,w} dyp.
//
// Bound: memory, 3 * N*H*W*C * sizeof(T) bytes (read x and dy once, write dx
// once); ~20 flops per element is far below the f32 ridge.
//
// Design (simple first): one block per sample, and every thread owns one
// channel for the whole sample: thread t takes channel t % C and the pixels
// t / C, t / C + 256 / C, ... so that for C dividing 256 the block still
// reads 256 consecutive values per step (coalesced), and per-channel sums
// need no atomics. Pass 1 sums x per channel (-> group mean, rstd); pass 2
// reads x and dy and sums dyp * x^ and dyp per channel, which give dscale and
// dbias of the sample and, scaled by `scale`, the group sums of dx^ and
// dx^ * x^; pass 3 reads x and dy again and writes dx. Each sample's
// per-channel sums go to a float32 workspace [N, 2, C]; a second kernel sums
// it over N in a fixed order, so the gradient is the same from run to run.
// Needs C <= 256. Passes 2 and 3 re-read the sample, mostly from L2; caching
// it in shared memory is later work.

constexpr int kMaxChannels = kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_lrelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ dx,
                    float* __restrict__ ws, int64_t hw, int c, int groups,
                    float eps, float slope) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw * c;
  const T* xs = x + base;
  const T* gs = dy + base;
  T* dxs = dx + base;
  const int t = threadIdx.x;
  const int tpc = kThreads / c;  // threads per channel
  const bool active = t < tpc * c;
  const int ch = t % c;
  const int64_t first = t / c;
  const int cpg = c / groups;
  const int g = ch / cpg;
  const float sc = active ? scale[ch] : 0.f;
  const float bi = active ? bias[ch] : 0.f;
  const float m = static_cast<float>(hw * cpg);

  __shared__ float red_a[kThreads], red_b[kThreads];
  __shared__ float chan_a[kMaxChannels], chan_b[kMaxChannels];
  __shared__ float mean_s[kMaxGroups], rstd_s[kMaxGroups];
  __shared__ float s1_s[kMaxGroups], s2_s[kMaxGroups];

  // pass 1: per-channel sums of x and x^2 -> group mean and rstd
  float a = 0.f, b = 0.f;
  if (active) {
    for (int64_t p = first; p < hw; p += tpc) {
      const float v = to_float(xs[p * c + ch]);
      a += v;
      b += v * v;
    }
  }
  red_a[t] = a;
  red_b[t] = b;
  __syncthreads();
  if (t < c) {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < tpc; ++k) {
      sa += red_a[k * c + t];
      sb += red_b[k * c + t];
    }
    chan_a[t] = sa;
    chan_b[t] = sb;
  }
  __syncthreads();
  if (t < groups) {
    float sa = 0.f, sb = 0.f;
    for (int k = t * cpg; k < (t + 1) * cpg; ++k) {
      sa += chan_a[k];
      sb += chan_b[k];
    }
    const float mean = sa / m;
    const float var = fmaxf(sb / m - mean * mean, 0.f);
    mean_s[t] = mean;
    rstd_s[t] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = active ? mean_s[g] : 0.f;
  const float rstd = active ? rstd_s[g] : 0.f;

  // pass 2: per-channel sums of dyp * x^ (a) and dyp (b)
  a = 0.f;
  b = 0.f;
  if (active) {
    for (int64_t p = first; p < hw; p += tpc) {
      const int64_t i = p * c + ch;
      const float xh = (to_float(xs[i]) - mean) * rstd;
      const float d = to_float(gs[i]);
      const float dyp = xh * sc + bi >= 0.f ? d : slope * d;
      a += dyp * xh;
      b += dyp;
    }
  }
  red_a[t] = a;
  red_b[t] = b;
  __syncthreads();
  if (t < c) {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < tpc; ++k) {
      sa += red_a[k * c + t];
      sb += red_b[k * c + t];
    }
    float* w = ws + static_cast<int64_t>(blockIdx.x) * 2 * c;
    w[t] = sa;      // this sample's dscale
    w[c + t] = sb;  // this sample's dbias
    chan_a[t] = sa * scale[t];  // sum of dx^ * x^ over the channel
    chan_b[t] = sb * scale[t];  // sum of dx^ over the channel
  }
  __syncthreads();
  if (t < groups) {
    float sa = 0.f, sb = 0.f;
    for (int k = t * cpg; k < (t + 1) * cpg; ++k) {
      sa += chan_a[k];
      sb += chan_b[k];
    }
    s2_s[t] = sa / m;
    s1_s[t] = sb / m;
  }
  __syncthreads();

  // pass 3: dx
  if (active) {
    const float s1 = s1_s[g], s2 = s2_s[g];
    for (int64_t p = first; p < hw; p += tpc) {
      const int64_t i = p * c + ch;
      const float xh = (to_float(xs[i]) - mean) * rstd;
      const float d = to_float(gs[i]);
      const float dyp = xh * sc + bi >= 0.f ? d : slope * d;
      store(dxs + i, rstd * (dyp * sc - s1 - xh * s2));
    }
  }
}

// dscale[c] = sum_n ws[n, 0, c], dbias[c] = sum_n ws[n, 1, c]; one block per
// output, a fixed-order tree reduction (deterministic).
__global__ void __launch_bounds__(kThreads)
gn_bwd_param_reduce_kernel(const float* __restrict__ ws,
                           float* __restrict__ dscale,
                           float* __restrict__ dbias, int64_t n, int c) {
  const int which = blockIdx.x / c;
  const int ch = blockIdx.x % c;
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    s += ws[(i * 2 + which) * c + ch];
  }
  __shared__ float red[kThreads];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) (which == 0 ? dscale : dbias)[ch] = red[0];
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* scale,
               const void* bias, void* dx, void* ws, void* dscale,
               void* dbias, int64_t n, int64_t hw, int c, int groups,
               float eps, float slope, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || hw <= 0 || c <= 0 || c > kMaxChannels ||
      groups <= 0 || groups > kMaxGroups || c % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    gn_lrelu_bwd_kernel<T><<<static_cast<unsigned>(n), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<T*>(dx), static_cast<float*>(ws), hw, c, groups, eps,
        slope);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gn_bwd_param_reduce_kernel<<<2 * c, kThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dscale),
      static_cast<float*>(dbias), n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: [n, H, W, C] contiguous; hw = H*W; scale, bias, dscale, dbias:
// float32 [C]; ws: float32 [n, 2, C] scratch.
extern "C" int gn_lrelu_bwd_f32(const void* x, const void* dy,
                                const void* scale, const void* bias, void* dx,
                                void* ws, void* dscale, void* dbias, int64_t n,
                                int64_t hw, int c, int groups, float eps,
                                float slope, void* stream) {
  return launch_bwd<float>(x, dy, scale, bias, dx, ws, dscale, dbias, n, hw,
                           c, groups, eps, slope, stream);
}

extern "C" int gn_lrelu_bwd_bf16(const void* x, const void* dy,
                                 const void* scale, const void* bias,
                                 void* dx, void* ws, void* dscale, void* dbias,
                                 int64_t n, int64_t hw, int c, int groups,
                                 float eps, float slope, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, scale, bias, dx, ws, dscale, dbias,
                                   n, hw, c, groups, eps, slope, stream);
}

// x, y: [n, H, W, C] contiguous; per_sample = H*W*C; scale, bias: float32 [C].
extern "C" int gn_lrelu_fwd_f32(const void* x, const void* scale,
                                const void* bias, void* y, int64_t n,
                                int64_t per_sample, int c, int groups,
                                float eps, float slope, void* stream) {
  return launch<float>(x, scale, bias, y, n, per_sample, c, groups, eps, slope,
                       stream);
}

extern "C" int gn_lrelu_fwd_bf16(const void* x, const void* scale,
                                 const void* bias, void* y, int64_t n,
                                 int64_t per_sample, int c, int groups,
                                 float eps, float slope, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, y, n, per_sample, c, groups,
                               eps, slope, stream);
}
