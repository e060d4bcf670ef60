// Train-mode BatchNorm in four passes, by hand for sm_90a.
//
// Replaces the `jax.custom_vjp` `_bn_train` of
// radar_sounder_crw_tpu/models/fused_bn.py (forward `_bn_train_impl`,
// backward `_bn_train_bwd`; a hand-scheduled XLA function, not a Pallas
// kernel). On an NCHW activation x of N samples, C channels and HW = H*W
// positions, float32 or bfloat16, with every statistic and accumulation in
// float32 and n = N*HW elements a channel:
//
//   stats:           s1[c] = sum x,  s2[c] = sum x*x,  and n
//   apply:           mean = s1/n, var = s2/n - mean*mean (no clamp),
//                    inv = rsqrt(var + eps),
//                    y = ((x - mean) * inv) * scale + bias, cast to x's type
//   backward_reduce: xhat = (x - mean) * inv,
//                    sg[c] = sum g, sgx[c] = sum g*xhat
//   dx:              dx = (scale*inv) * ((g - sg/n) - xhat * (sgx/n)),
//                    cast to x's type
//
// in the operation order of fused_bn.py:58-86, each operation rounded on
// its own (the _rn intrinsics keep nvcc from contracting a multiply and an
// add into one FMA), so that a kernel given the same sums computes what its
// plain twin in ops/bn_cuda.py computes with PyTorch's elementwise ops.
// apply, backward_reduce and dx take the sums as inputs, so a mesh can
// all-reduce them between the passes.
//
// Layout and coalescing: a channel's elements are HW apart in a sample and
// C*HW apart across samples, and at the ResNet's last stage HW = 1. Every
// kernel runs on a (tile, sample chunk) grid: the threads of a CTA sit on
// 256 consecutive positions p = c*HW + hw of the C*HW plane and walk the
// samples of their chunk, so each warp reads 32 consecutive elements.
//
// Deterministic reductions, no float atomics: a reduction's first pass
// sums each thread's position over its chunk of samples in sample order,
// then each channel's positions within the tile in position order, one
// thread a channel, into a partial per (channel slot, tile, chunk); its
// second pass sums a channel's partials in a fixed order, one warp a
// channel, lanes over (tile, chunk) and a fixed shuffle tree. The same
// shapes give the same bits on every run, which a CUDA graph of k train
// steps relies on to equal k eager steps.
//
// Bound: bytes. stats and apply read x once (apply also writes y),
// backward_reduce reads g and x, dx reads g and x and writes dx: at
// bfloat16 2, 4, 4 and 6 bytes an element, at float32 twice that; a few
// operations an element against 67 TFLOP/s.
//
// Plain C interface, loaded with ctypes (radar_sounder_crw_tpu_torch/ops/
// bn_cuda.py); the wrapper sizes the grid and the partials' scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // positions of a tile; at most kThreads channel slots

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Moments {
  float mean, var, inv;
};

// A channel's mean, biased variance (E[x^2] - E[x]^2, unclamped) and
// rsqrt(var + eps) from its sums and the count, as fused_bn.py:64-66.
__device__ __forceinline__ Moments moments(const float* sums, int C, int c, float eps) {
  const float n = sums[2 * C];
  const float mean = __fdiv_rn(sums[c], n);
  const float var = __fsub_rn(__fdiv_rn(sums[C + c], n), __fmul_rn(mean, mean));
  return {mean, var, rsqrtf(__fadd_rn(var, eps))};
}

struct Plan {
  int N, C, HW, chunk, S, ntiles;
  __device__ int plane() const { return C * HW; }
};

// Partial sums, two planes (q = 0, 1) of (tile, channel slot, chunk).
__device__ __forceinline__ size_t partial_index(const Plan& pl, int q, int t, int slot, int s) {
  return ((static_cast<size_t>(q) * pl.ntiles + t) * kThreads + slot) * pl.S + s;
}

// First pass of both reductions: (sum x, sum x*x) for the statistics, or
// (sum g, sum g*xhat) for the backward, per (tile, channel slot, chunk).
template <typename T, bool kBackward>
__global__ void __launch_bounds__(kThreads) reduce_partials(
    const T* __restrict__ a, const T* __restrict__ x, const float* __restrict__ sums, float eps,
    Plan pl, float* __restrict__ partial) {
  __shared__ float r0[kThreads], r1[kThreads];
  const int P = pl.plane();
  const int t = blockIdx.x, s = blockIdx.y;
  const int j0 = t * kThreads;
  const int p = j0 + threadIdx.x;
  float acc0 = 0.f, acc1 = 0.f;
  if (p < P) {
    float mean = 0.f, inv = 0.f;
    if (kBackward) {
      const Moments m = moments(sums, pl.C, p / pl.HW, eps);
      mean = m.mean;
      inv = m.inv;
    }
    const int n0 = s * pl.chunk;
    const int n1 = min(pl.N, n0 + pl.chunk);
    const size_t off = static_cast<size_t>(n0) * P + p;
    const T* pa = a + off;
    const T* px = kBackward ? x + off : nullptr;
#pragma unroll 4
    for (int i = n0; i < n1; ++i) {
      const float v = to_float(*pa);
      pa += P;
      if (kBackward) {
        const float xhat = __fmul_rn(__fsub_rn(to_float(*px), mean), inv);
        px += P;
        acc0 = __fadd_rn(acc0, v);
        acc1 = __fadd_rn(acc1, __fmul_rn(v, xhat));
      } else {
        acc0 = __fadd_rn(acc0, v);
        acc1 = __fadd_rn(acc1, __fmul_rn(v, v));
      }
    }
  }
  r0[threadIdx.x] = acc0;
  r1[threadIdx.x] = acc1;
  __syncthreads();
  const int jend = min(P, j0 + kThreads);
  const int c_lo = j0 / pl.HW;
  const int slots = (jend - 1) / pl.HW - c_lo + 1;
  if (threadIdx.x < slots) {
    const int c = c_lo + threadIdx.x;
    const int q0 = max(j0, c * pl.HW) - j0;
    const int q1 = min(jend, (c + 1) * pl.HW) - j0;
    float s0 = 0.f, s1 = 0.f;
    for (int q = q0; q < q1; ++q) {
      s0 = __fadd_rn(s0, r0[q]);
      s1 = __fadd_rn(s1, r1[q]);
    }
    partial[partial_index(pl, 0, t, threadIdx.x, s)] = s0;
    partial[partial_index(pl, 1, t, threadIdx.x, s)] = s1;
  }
}

// Second pass: one warp a channel sums its partials, lanes over (tile,
// chunk) in order, then a fixed shuffle tree; out is (2, C), followed by
// the count n with kCount.
template <bool kCount>
__global__ void __launch_bounds__(kThreads) reduce_final(const float* __restrict__ partial,
                                                          Plan pl, float* __restrict__ out) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (c >= pl.C) return;  // whole warps leave together
  const int t0 = c * pl.HW / kThreads;
  const int t1 = ((c + 1) * pl.HW - 1) / kThreads;
  const int items = (t1 - t0 + 1) * pl.S;
  float s0 = 0.f, s1 = 0.f;
  for (int it = lane; it < items; it += 32) {
    const int t = t0 + it / pl.S;
    const int slot = c - t * kThreads / pl.HW;
    const int s = it % pl.S;
    s0 = __fadd_rn(s0, partial[partial_index(pl, 0, t, slot, s)]);
    s1 = __fadd_rn(s1, partial[partial_index(pl, 1, t, slot, s)]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, off));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
  }
  if (lane == 0) {
    out[c] = s0;
    out[pl.C + c] = s1;
    if (kCount && c == 0) out[2 * pl.C] = static_cast<float>(static_cast<long long>(pl.N) * pl.HW);
  }
}

// y = ((x - mean) * inv) * scale + bias; the chunk-0 CTAs also write each
// channel's mean and var (once, at its first position).
template <typename T>
__global__ void __launch_bounds__(kThreads) apply(
    const T* __restrict__ x, const float* __restrict__ sums, const float* __restrict__ scale,
    const float* __restrict__ bias, float eps, Plan pl, T* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ var_out) {
  const int P = pl.plane();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int c = p / pl.HW;
  const Moments m = moments(sums, pl.C, c, eps);
  if (blockIdx.y == 0 && p % pl.HW == 0) {
    mean_out[c] = m.mean;
    var_out[c] = m.var;
  }
  const float sc = scale[c], b = bias[c];
  const int n0 = blockIdx.y * pl.chunk;
  const int n1 = min(pl.N, n0 + pl.chunk);
  const size_t off = static_cast<size_t>(n0) * P + p;
  const T* px = x + off;
  T* py = y + off;
#pragma unroll 4
  for (int i = n0; i < n1; ++i) {
    const float v = __fmul_rn(__fmul_rn(__fsub_rn(to_float(*px), m.mean), m.inv), sc);
    *py = from_float<T>(__fadd_rn(v, b));
    px += P;
    py += P;
  }
}

// dx = (scale*inv) * ((g - sg/n) - xhat * (sgx/n)), xhat = (x - mean) * inv.
template <typename T>
__global__ void __launch_bounds__(kThreads) input_grad(
    const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ sums,
    const float* __restrict__ gsums, const float* __restrict__ scale, float eps, Plan pl,
    T* __restrict__ dx) {
  const int P = pl.plane();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const int c = p / pl.HW;
  const Moments m = moments(sums, pl.C, c, eps);
  const float k = __fmul_rn(scale[c], m.inv);
  const float n = sums[2 * pl.C];
  const float a = __fdiv_rn(gsums[c], n);
  const float b = __fdiv_rn(gsums[pl.C + c], n);
  const int n0 = blockIdx.y * pl.chunk;
  const int n1 = min(pl.N, n0 + pl.chunk);
  const size_t off = static_cast<size_t>(n0) * P + p;
  const T* pg = g + off;
  const T* px = x + off;
  T* pd = dx + off;
#pragma unroll 4
  for (int i = n0; i < n1; ++i) {
    const float xhat = __fmul_rn(__fsub_rn(to_float(*px), m.mean), m.inv);
    const float t = __fsub_rn(__fsub_rn(to_float(*pg), a), __fmul_rn(xhat, b));
    *pd = from_float<T>(__fmul_rn(k, t));
    pg += P;
    px += P;
    pd += P;
  }
}

Plan make_plan(int N, int C, int HW, int chunk, int S) {
  return Plan{N, C, HW, chunk, S, (C * HW + kThreads - 1) / kThreads};
}

template <typename T, bool kBackward>
int reduce(const void* a, const void* x, const float* sums, float eps, const Plan& pl,
           float* partial, float* out, cudaStream_t stream) {
  reduce_partials<T, kBackward><<<dim3(pl.ntiles, pl.S), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), sums, eps, pl, partial);
  int err = cudaGetLastError();
  if (err != 0) return err;
  const int warps_per_cta = kThreads / 32;
  reduce_final<!kBackward><<<(pl.C + warps_per_cta - 1) / warps_per_cta, kThreads, 0, stream>>>(
      partial, pl, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Every pointer is on the current device;
// x, g, y and dx are contiguous (N, C, H, W); sums, gsums, scale, bias,
// mean and var float32 (C,); sums is (2C + 1,): s1, s2 and the count n
// (the stats pass writes this rank's n = N*HW; a mesh sums all three), gsums
// (2C,); partial 2 * ntiles * 256 * S floats.

int bn_train_stats(const void* x, int dtype, int N, int C, int HW, int chunk, int S,
                   float* partial, float* sums, void* stream) {
  const Plan pl = make_plan(N, C, HW, chunk, S);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? reduce<__nv_bfloat16, false>(x, nullptr, nullptr, 0.f, pl, partial, sums, st)
                    : reduce<float, false>(x, nullptr, nullptr, 0.f, pl, partial, sums, st);
}

int bn_train_apply(const void* x, int dtype, const float* sums, const float* scale,
                   const float* bias, float eps, int N, int C, int HW, int chunk, int S, void* y,
                   float* mean, float* var, void* stream) {
  const Plan pl = make_plan(N, C, HW, chunk, S);
  const dim3 grid(pl.ntiles, pl.S);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    apply<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), sums, scale, bias, eps, pl,
        static_cast<__nv_bfloat16*>(y), mean, var);
  } else {
    apply<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), sums, scale, bias, eps,
                                            pl, static_cast<float*>(y), mean, var);
  }
  return cudaGetLastError();
}

int bn_train_backward_reduce(const void* g, const void* x, int dtype, const float* sums,
                             float eps, int N, int C, int HW, int chunk, int S, float* partial,
                             float* gsums, void* stream) {
  const Plan pl = make_plan(N, C, HW, chunk, S);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? reduce<__nv_bfloat16, true>(g, x, sums, eps, pl, partial, gsums, st)
                    : reduce<float, true>(g, x, sums, eps, pl, partial, gsums, st);
}

int bn_train_dx(const void* g, const void* x, int dtype, const float* sums, const float* gsums,
                const float* scale, float eps, int N, int C, int HW, int chunk, int S, void* dx,
                void* stream) {
  const Plan pl = make_plan(N, C, HW, chunk, S);
  const dim3 grid(pl.ntiles, pl.S);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    input_grad<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x), sums, gsums,
        scale, eps, pl, static_cast<__nv_bfloat16*>(dx));
  } else {
    input_grad<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(g),
                                                 static_cast<const float*>(x), sums, gsums, scale,
                                                 eps, pl, static_cast<float*>(dx));
  }
  return cudaGetLastError();
}

// Positions of a tile: the wrapper's grid is ceil(C*HW / this) tiles.
int bn_train_tile_positions(void) { return kThreads; }

const char* bn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
