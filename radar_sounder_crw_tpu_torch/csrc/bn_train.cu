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
// Bound: bytes. stats and apply read x once (apply also writes y),
// backward_reduce reads g and x, dx reads g and x and writes dx: at
// bfloat16 2, 4, 4 and 6 bytes an element, at float32 twice that; a few
// operations an element against 67 TFLOP/s. Every kernel streams its
// inputs, so each is held to HBM's 3.35 TB/s.
//
// The forward pair (stats, apply), built for the H100:
//   * 16-byte vectors. A thread loads V elements at once (8 bfloat16 or 4
//     float32) where a sample's plane of C*HW elements and x's address are
//     multiples of 16 bytes; otherwise the widest vector that divides both
//     (bfloat16 at C*HW = 972, the ResNet's first BatchNorm, takes 8 bytes).
//     The vector is a template argument, chosen by the plan.
//   * Bytes in flight. By Little's law HBM at 3.35 TB/s and ~0.8 us of
//     loaded latency needs ~2.7 MB in flight, ~20 KB an SM. A thread keeps
//     kUnroll = 4 independent vector loads in flight (2 in apply at 8
//     bfloat16, whose 32 per-lane parameters hold the registers); an SM
//     runs 2 stats CTAs of 256 threads (32 KB in flight) or up to
//     kCtasPerSm = 4 apply CTAs (32-64 KB).
//   * A tile of whole channels. A CTA covers `tile` vectors of the plane
//     (at least 128 bytes of a sample's row, whole channels where a CTA's
//     row can hold them; for apply, whose partly written 32-byte sectors
//     cost the memory a read, whole sectors where half a CTA holds them)
//     over `rows` samples in parallel, and walks a chunk of samples; its
//     threads sit on consecutive vectors, so a warp reads whole lines.
//     Each thread keeps its V positions' sums in registers over the
//     samples it walks.
//   * One launch a reduction, no float atomics. The CTA sums its tile's
//     channels over its rows and positions in shared memory with every
//     thread (segmented_sum: a fixed split of each channel's items over
//     threads, then a shuffle tree and the warps' sums in warp order) and
//     writes one partial a channel slot. An integer ticket a group of tiles
//     (one tile where tiles hold whole channels) finds the group's last CTA,
//     which sums the group's partials in a fixed order and resets the
//     ticket for the next launch or graph replay. The order of every float
//     addition depends on the plan alone, that is on (N, C, HW, dtype, the
//     SM count, x's 16-byte alignment): the same input gives the same bits.
//   * A grid from the shape and the card. stats runs half a wave (2 CTAs
//     an SM), each CTA walking N / chunks samples, so that the last CTAs
//     sum few partials; apply runs the whole waves of kCtasPerSm CTAs an SM
//     nearest 8 vectors a thread, enough to hide a CTA's start-up and few
//     enough that the waves even out the SMs' pace.
//   * apply computes each channel's moments once a CTA, into shared memory,
//     and each thread keeps its V positions' parameters in registers.
//   * What is left: at the small late shapes (a few to 40 MB) the launch,
//     the CTAs' reductions and the last CTA's sum are a fixed cost beside
//     a few microseconds of reading; apply, reading and writing, runs
//     near what the memory gives a copy.
//
// The backward pair runs on the (tile, sample chunk) grid of PR 10's
// design: the threads of a CTA sit on 256 consecutive positions of the
// plane and walk their chunk's samples one element at a time; a reduction
// writes per-CTA partials (reduce_partials), then sums each channel's in a
// fixed order, one warp a channel (reduce_final).
//
// Plain C interface, loaded with ctypes (radar_sounder_crw_tpu_torch/ops/
// bn_cuda.py); the wrapper plans the grids and allocates the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads of a CTA; positions of a backward tile
constexpr int kCtasPerSm = 4;  // the forward kernels' residency (launch bounds): CTAs an SM
constexpr int kMaxSlots = 128;  // channel slots of a forward tile
constexpr int kUnroll = 4;      // independent vector loads a thread keeps in flight

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

// -- the forward pair ----------------------------------------------------------

// Elements as stored: float, or bfloat16 as its 16 bits.
__device__ __forceinline__ float widen(float e) { return e; }
__device__ __forceinline__ float widen(unsigned short e) {
  return __uint_as_float(static_cast<unsigned>(e) << 16);
}
__device__ __forceinline__ void narrow(float v, float& e) { e = v; }
__device__ __forceinline__ void narrow(float v, unsigned short& e) {
  e = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int kBytes>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = unsigned; };
template <>
struct RawOf<2> { using type = unsigned short; };

// V elements moved as one load or store.
template <typename E, int V>
union Pack {
  using Raw = typename RawOf<sizeof(E) * V>::type;
  Raw raw;
  E e[V];
};

struct FwdPlan {
  int N, C, HW, vp;   // samples, channels, positions a channel, vectors a sample
  int tile, rows;     // vectors of a tile's row segment, samples walked in parallel
  int tiles, chunk, chunks;
  int slots, group;   // channel slots a tile's partials; tiles a ticket
};

// A tile's positions [pos0, pos0 + npos) of the plane and its channels
// [c_lo, c_lo + nslots).
struct TileSpan {
  int pos0, npos, c_lo, nslots;
};

__device__ __forceinline__ TileSpan tile_span(const FwdPlan& pl, int V, int t) {
  const int v0 = t * pl.tile;
  const int pos0 = v0 * V, npos = min(pl.tile, pl.vp - v0) * V;
  const int c_lo = pos0 / pl.HW;
  return {pos0, npos, c_lo, (pos0 + npos - 1) / pl.HW - c_lo + 1};
}

// The (a, b) sums of `nseg` segments of items with every thread of the CTA,
// in an order fixed by (nseg, the items, blockDim.x): `pps` threads a
// segment (a power of two, the most that fit), item i on thread part i %
// pps, which sums its items in order with kUnroll loads in flight; then a
// shuffle tree over the parts within a warp and, where a segment spans
// warps, the warps' sums in warp order. begin(seg) returns the segment's
// state (its item count .n), item(state, i, a, b) reads item i, and
// emit(seg, a, b) is called once a segment. `wsum` is 2 * kThreads / 32
// floats of shared memory; the caller synchronises before a second call.
template <class Begin, class Item, class Emit>
__device__ __forceinline__ void segmented_sum(int nseg, const Begin& begin, const Item& item,
                                              const Emit& emit, float* wsum) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
  int pps = 1;
  while (pps * 2 * nseg <= nthreads) pps *= 2;
  const int lanes = min(pps, 32);
  const int per_round = nthreads / pps;
  const int rounds = (nseg + per_round - 1) / per_round;
  const int part = tid % pps;
  for (int r = 0; r < rounds; ++r) {  // the same count on every thread: the shuffles below
    const int seg = r * per_round + tid / pps;
    float a = 0.f, b = 0.f;
    if (seg < nseg) {
      const auto st = begin(seg);
      for (int i = part; i < st.n; i += kUnroll * pps) {
        float va[kUnroll], vb[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u * pps < st.n) item(st, i + u * pps, va[u], vb[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u * pps < st.n) {
            a = __fadd_rn(a, va[u]);
            b = __fadd_rn(b, vb[u]);
          }
        }
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
    if (pps <= 32) {
      if (seg < nseg && part == 0) emit(seg, a, b);
    } else {  // one round; a segment over pps / 32 warps
      if (tid % 32 == 0) {
        wsum[tid / 32] = a;
        wsum[kThreads / 32 + tid / 32] = b;
      }
      __syncthreads();
      if (tid < nseg) {
        const int w = pps / 32;
        float sa = 0.f, sb = 0.f;
        for (int k = 0; k < w; ++k) {
          sa = __fadd_rn(sa, wsum[tid * w + k]);
          sb = __fadd_rn(sb, wsum[kThreads / 32 + tid * w + k]);
        }
        emit(tid, sa, sb);
      }
    }
  }
}

// s1, s2 of every channel and the count n, in one launch on a (tile,
// chunk) grid: each CTA's partials, then the last CTA of each ticket group
// sums its group's.
template <typename E, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) stats_kernel(
    const E* __restrict__ x, FwdPlan pl, float* __restrict__ partial,
    unsigned* __restrict__ tickets, float* __restrict__ sums) {
  __shared__ float red[2][kThreads * V];
  __shared__ float wsum[2 * kThreads / 32];
  __shared__ bool last;
  using P = Pack<E, V>;
  const int t = blockIdx.x, s = blockIdx.y;
  const TileSpan sp = tile_span(pl, V, t);
  const int tx = threadIdx.x % pl.tile, ty = threadIdx.x / pl.tile;
  const bool active = ty < pl.rows && tx * V < sp.npos;
  const int W = pl.tile * V;  // positions of a row of `red`
  const size_t plane = static_cast<size_t>(pl.vp) * V;
  if (active) {
    float a[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    const int n1 = min(pl.N, (s + 1) * pl.chunk);
    const size_t step = static_cast<size_t>(pl.rows) * plane;
    int n = s * pl.chunk + ty;
    const E* p = x + static_cast<size_t>(n) * plane + sp.pos0 + tx * V;
    for (; n + (kUnroll - 1) * pl.rows < n1; n += kUnroll * pl.rows) {
      P v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u].raw = __ldg(reinterpret_cast<const typename P::Raw*>(p + u * step));
      }
      p += kUnroll * step;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = widen(v[u].e[k]);
          a[k] = __fadd_rn(a[k], f);
          b[k] = __fadd_rn(b[k], __fmul_rn(f, f));
        }
      }
    }
    for (; n < n1; n += pl.rows, p += step) {
      P v;
      v.raw = __ldg(reinterpret_cast<const typename P::Raw*>(p));
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = widen(v.e[k]);
        a[k] = __fadd_rn(a[k], f);
        b[k] = __fadd_rn(b[k], __fmul_rn(f, f));
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][ty * W + tx * V + k] = a[k];
      red[1][ty * W + tx * V + k] = b[k];
    }
  }
  __syncthreads();

  // the tile's channels over its rows and positions: partial (q, t, s, slot)
  const size_t qstride = static_cast<size_t>(pl.tiles) * pl.chunks * pl.slots;
  struct Span {
    int n, pa, len;  // items (rows x positions), first position, positions
  };
  float* out = partial + (static_cast<size_t>(t) * pl.chunks + s) * pl.slots;
  segmented_sum(
      sp.nslots,
      [&](int j) {
        const int c = sp.c_lo + j;
        const int pa = max(c * pl.HW, sp.pos0) - sp.pos0;
        const int len = min((c + 1) * pl.HW, sp.pos0 + sp.npos) - sp.pos0 - pa;
        return Span{pl.rows * len, pa, len};
      },
      [&](const Span& st, int i, float& va, float& vb) {
        const int r = i / st.len;
        const int at = r * W + st.pa + (i - r * st.len);
        va = red[0][at];
        vb = red[1][at];
      },
      [&](int j, float va, float vb) {
        out[j] = va;
        out[qstride + j] = vb;
      },
      wsum);

  // the ticket: the group's last CTA sums the group's partials
  __threadfence();
  __syncthreads();
  const int g = t / pl.group;
  const int t_first = g * pl.group, t_end = min(pl.tiles, t_first + pl.group);
  if (threadIdx.x == 0) {
    const unsigned ctas = static_cast<unsigned>(t_end - t_first) * pl.chunks;
    last = atomicAdd(&tickets[g], 1u) == ctas - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int tw = pl.tile * V;  // positions of a full tile
  const int c_first = tile_span(pl, V, t_first).c_lo;
  const TileSpan end = tile_span(pl, V, t_end - 1);
  struct Items {
    int n, c, t0;  // partials (tiles x chunks), channel, first tile
  };
  segmented_sum(
      end.c_lo + end.nslots - c_first,
      [&](int j) {
        const int c = c_first + j;
        const int t0 = max(t_first, c * pl.HW / tw);
        const int t1 = min(t_end - 1, ((c + 1) * pl.HW - 1) / tw);
        return Items{(t1 - t0 + 1) * pl.chunks, c, t0};
      },
      [&](const Items& st, int i, float& va, float& vb) {
        const int tt = st.t0 + i / pl.chunks;
        const int slot = st.c - tt * tw / pl.HW;
        const size_t at = (static_cast<size_t>(tt) * pl.chunks + i % pl.chunks) * pl.slots + slot;
        va = __ldcg(partial + at);
        vb = __ldcg(partial + qstride + at);
      },
      [&](int j, float va, float vb) {
        const int c = c_first + j;
        sums[c] = va;
        sums[pl.C + c] = vb;
        if (c == 0) sums[2 * pl.C] = static_cast<float>(static_cast<long long>(pl.N) * pl.HW);
      },
      wsum);
  if (threadIdx.x == 0) tickets[g] = 0;
}

// y = ((x - mean) * inv) * scale + bias on the stats' grid; the chunk-0
// CTAs also write each channel's mean and var (the tile where it starts).
template <typename E, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) apply_kernel(
    const E* __restrict__ x, const float* __restrict__ sums, const float* __restrict__ scale,
    const float* __restrict__ bias, float eps, FwdPlan pl, E* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ var_out) {
  constexpr int U = V >= 8 ? 2 : kUnroll;  // 8 lanes' parameters take 32 registers
  __shared__ float prm[4][kMaxSlots];
  using P = Pack<E, V>;
  const int t = blockIdx.x, s = blockIdx.y;
  const TileSpan sp = tile_span(pl, V, t);
  for (int j = threadIdx.x; j < sp.nslots; j += blockDim.x) {
    const int c = sp.c_lo + j;
    const Moments m = moments(sums, pl.C, c, eps);
    prm[0][j] = m.mean;
    prm[1][j] = m.inv;
    prm[2][j] = scale[c];
    prm[3][j] = bias[c];
    if (s == 0 && c * pl.HW >= sp.pos0) {
      mean_out[c] = m.mean;
      var_out[c] = m.var;
    }
  }
  __syncthreads();
  const int tx = threadIdx.x % pl.tile, ty = threadIdx.x / pl.tile;
  if (ty >= pl.rows || tx * V >= sp.npos) return;
  float mu[V], iv[V], sc[V], bi[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = (sp.pos0 + tx * V + k) / pl.HW - sp.c_lo;
    mu[k] = prm[0][j];
    iv[k] = prm[1][j];
    sc[k] = prm[2][j];
    bi[k] = prm[3][j];
  }
  const size_t plane = static_cast<size_t>(pl.vp) * V;
  const size_t step = static_cast<size_t>(pl.rows) * plane;
  const int n1 = min(pl.N, (s + 1) * pl.chunk);
  int n = s * pl.chunk + ty;
  const size_t off = static_cast<size_t>(n) * plane + sp.pos0 + tx * V;
  const E* px = x + off;
  E* py = y + off;
  auto normalize = [&](P& v) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float w = __fmul_rn(__fmul_rn(__fsub_rn(widen(v.e[k]), mu[k]), iv[k]), sc[k]);
      narrow(__fadd_rn(w, bi[k]), v.e[k]);
    }
  };
  for (; n + (U - 1) * pl.rows < n1; n += U * pl.rows) {
    P v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u].raw = __ldg(reinterpret_cast<const typename P::Raw*>(px + u * step));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      normalize(v[u]);
      *reinterpret_cast<typename P::Raw*>(py + u * step) = v[u].raw;
    }
    px += U * step;
    py += U * step;
  }
  for (; n < n1; n += pl.rows, px += step, py += step) {
    P v;
    v.raw = __ldg(reinterpret_cast<const typename P::Raw*>(px));
    normalize(v);
    *reinterpret_cast<typename P::Raw*>(py) = v.raw;
  }
}

template <typename E, int V>
int launch_stats(const void* x, const FwdPlan& pl, int threads, float* partial,
                 unsigned* tickets, float* sums, cudaStream_t stream) {
  stats_kernel<E, V><<<dim3(pl.tiles, pl.chunks), threads, 0, stream>>>(
      static_cast<const E*>(x), pl, partial, tickets, sums);
  return cudaGetLastError();
}

template <typename E, int V>
int launch_apply(const void* x, const float* sums, const float* scale, const float* bias,
                 float eps, const FwdPlan& pl, int threads, void* y, float* mean, float* var,
                 cudaStream_t stream) {
  apply_kernel<E, V><<<dim3(pl.tiles, pl.chunks), threads, 0, stream>>>(
      static_cast<const E*>(x), sums, scale, bias, eps, pl, static_cast<E*>(y), mean, var);
  return cudaGetLastError();
}

// The channel slots a tile's partials need: its whole channels where tiles
// end on channel boundaries, else the most any run of its positions spans.
int slots_needed(const FwdPlan& pl, int vector) {
  const int positions = pl.tile * vector;
  if (pl.tiles == 1) return pl.C;
  if (positions % pl.HW == 0) return positions / pl.HW;
  return std::min(pl.C, (positions + pl.HW - 2) / pl.HW + 1);
}

// A plan the kernels can run: its vector one of the dtype's, its grid
// covering the samples and the plane once, its threads and slots within
// the kernels' arrays, a ticket a tile only where tiles hold whole
// channels.
bool valid(int dtype, int vector, const FwdPlan& pl, int threads) {
  const int widest = dtype == 1 ? 8 : 4;
  if (vector < 1 || vector > widest || (vector & (vector - 1)) != 0 ||
      (pl.C * pl.HW) % vector != 0 || pl.tile < 1 || pl.rows < 1 || pl.chunk < 1) {
    return false;
  }
  const int vp = pl.C * pl.HW / vector;
  const bool whole = pl.tiles == 1 || (pl.tile * vector) % pl.HW == 0;
  return (pl.tiles - 1) * pl.tile < vp && pl.tiles * pl.tile >= vp &&
         (pl.chunks - 1) * pl.chunk < pl.N && pl.chunks * pl.chunk >= pl.N &&
         threads % 32 == 0 && threads <= kThreads && pl.tile * pl.rows <= threads &&
         pl.slots >= slots_needed(pl, vector) && pl.slots <= kMaxSlots &&
         (pl.group >= pl.tiles || (pl.group == 1 && whole));
}

// -- the backward pair (PR 10's design) -----------------------------------------

struct Plan {
  int N, C, HW, chunk, S, ntiles;
  __device__ int plane() const { return C * HW; }
};

// Partial sums, two planes (q = 0, 1) of (tile, channel slot, chunk).
__device__ __forceinline__ size_t partial_index(const Plan& pl, int q, int t, int slot, int s) {
  return ((static_cast<size_t>(q) * pl.ntiles + t) * kThreads + slot) * pl.S + s;
}

// First pass of the backward reduction: (sum g, sum g*xhat) per (tile,
// channel slot, chunk).
template <typename T>
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
    const Moments m = moments(sums, pl.C, p / pl.HW, eps);
    const int n0 = s * pl.chunk;
    const int n1 = min(pl.N, n0 + pl.chunk);
    const size_t off = static_cast<size_t>(n0) * P + p;
    const T* pa = a + off;
    const T* px = x + off;
#pragma unroll 4
    for (int i = n0; i < n1; ++i) {
      const float v = to_float(*pa);
      pa += P;
      const float xhat = __fmul_rn(__fsub_rn(to_float(*px), m.mean), m.inv);
      px += P;
      acc0 = __fadd_rn(acc0, v);
      acc1 = __fadd_rn(acc1, __fmul_rn(v, xhat));
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
// chunk) in order, then a fixed shuffle tree; out is (2, C).
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

template <typename T>
int backward_reduce(const void* g, const void* x, const float* sums, float eps, const Plan& pl,
                    float* partial, float* out, cudaStream_t stream) {
  reduce_partials<T><<<dim3(pl.ntiles, pl.S), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), sums, eps, pl, partial);
  int err = cudaGetLastError();
  if (err != 0) return err;
  const int warps_per_cta = kThreads / 32;
  reduce_final<<<(pl.C + warps_per_cta - 1) / warps_per_cta, kThreads, 0, stream>>>(partial, pl,
                                                                                     out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Every pointer is on the current device;
// x, g, y and dx are contiguous (N, C, H, W); sums, gsums, scale, bias,
// mean and var float32 (C,); sums is (2C + 1,): s1, s2 and the count n
// (the stats pass writes this rank's n = N*HW; a mesh sums all three), gsums
// (2C,).
//
// The forward pair takes the plan of ops/bn_cuda.forward_plan: vector,
// tile, rows, threads, tiles, chunk, chunks, slots, group. partial is
// 2 * tiles * chunks * slots floats; tickets holds one zero unsigned a
// ticket group (ceil(tiles / group)), and is zero again when the launch
// ends. The backward pair takes (chunk, S) of ops/bn_cuda.backward_plan and
// partial of 2 * ceil(C*HW / 256) * 256 * S floats.

int bn_train_stats(const void* x, int dtype, int N, int C, int HW, int vector, int tile,
                   int rows, int threads, int tiles, int chunk, int chunks, int slots, int group,
                   float* partial, unsigned* tickets, float* sums, void* stream) {
  const FwdPlan pl{N, C, HW, C * HW / vector, tile, rows, tiles, chunk, chunks, slots, group};
  if (!valid(dtype, vector, pl, threads)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (vector) {
      case 8: return launch_stats<unsigned short, 8>(x, pl, threads, partial, tickets, sums, st);
      case 4: return launch_stats<unsigned short, 4>(x, pl, threads, partial, tickets, sums, st);
      case 2: return launch_stats<unsigned short, 2>(x, pl, threads, partial, tickets, sums, st);
      default: return launch_stats<unsigned short, 1>(x, pl, threads, partial, tickets, sums, st);
    }
  }
  switch (vector) {
    case 4: return launch_stats<float, 4>(x, pl, threads, partial, tickets, sums, st);
    case 2: return launch_stats<float, 2>(x, pl, threads, partial, tickets, sums, st);
    default: return launch_stats<float, 1>(x, pl, threads, partial, tickets, sums, st);
  }
}

int bn_train_apply(const void* x, int dtype, const float* sums, const float* scale,
                   const float* bias, float eps, int N, int C, int HW, int vector, int tile,
                   int rows, int threads, int tiles, int chunk, int chunks, int slots, int group,
                   void* y, float* mean, float* var, void* stream) {
  const FwdPlan pl{N, C, HW, C * HW / vector, tile, rows, tiles, chunk, chunks, slots, group};
  if (!valid(dtype, vector, pl, threads)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (vector) {
      case 8:
        return launch_apply<unsigned short, 8>(x, sums, scale, bias, eps, pl, threads, y, mean,
                                               var, st);
      case 4:
        return launch_apply<unsigned short, 4>(x, sums, scale, bias, eps, pl, threads, y, mean,
                                               var, st);
      case 2:
        return launch_apply<unsigned short, 2>(x, sums, scale, bias, eps, pl, threads, y, mean,
                                               var, st);
      default:
        return launch_apply<unsigned short, 1>(x, sums, scale, bias, eps, pl, threads, y, mean,
                                               var, st);
    }
  }
  switch (vector) {
    case 4:
      return launch_apply<float, 4>(x, sums, scale, bias, eps, pl, threads, y, mean, var, st);
    case 2:
      return launch_apply<float, 2>(x, sums, scale, bias, eps, pl, threads, y, mean, var, st);
    default:
      return launch_apply<float, 1>(x, sums, scale, bias, eps, pl, threads, y, mean, var, st);
  }
}

int bn_train_backward_reduce(const void* g, const void* x, int dtype, const float* sums,
                             float eps, int N, int C, int HW, int chunk, int S, float* partial,
                             float* gsums, void* stream) {
  const Plan pl = make_plan(N, C, HW, chunk, S);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? backward_reduce<__nv_bfloat16>(g, x, sums, eps, pl, partial, gsums, st)
                    : backward_reduce<float>(g, x, sums, eps, pl, partial, gsums, st);
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

// The constants ops/bn_cuda.py plans with: threads a CTA (positions of a
// backward tile), forward CTAs an SM, channel slots of a forward tile.
int bn_train_constant(int which) {
  return which == 0 ? kThreads : which == 1 ? kCtasPerSm : which == 2 ? kMaxSlots : -1;
}

const char* bn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
