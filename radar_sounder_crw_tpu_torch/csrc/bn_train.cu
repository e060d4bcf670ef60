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
// The tiled kernels (stats, apply, backward_reduce), built for the H100:
//   * 16-byte vectors. A thread loads V elements at once (8 bfloat16 or 4
//     float32) where a sample's plane of C*HW elements and the address of
//     every activation it reads (x, and g for backward_reduce) are
//     multiples of 16 bytes; otherwise the widest vector that divides all
//     (bfloat16 at C*HW = 972, the ResNet's first BatchNorm, takes 8 bytes).
//     The vector is a template argument, chosen by the plan.
//   * Bytes in flight. By Little's law HBM at 3.35 TB/s and ~0.8 us of
//     loaded latency needs ~2.7 MB in flight, ~20 KB an SM. A thread keeps
//     kUnroll = 4 independent vector loads in flight (2 in apply at 8
//     bfloat16, whose 32 per-lane parameters hold the registers; 2 pairs
//     of a g and an x vector in backward_reduce, whose 4 V-lane arrays of
//     sums and moments hold them); an SM runs 2 stats or backward_reduce
//     CTAs of 256 threads (32 KB in flight) or up to kCtasPerSm = 4 apply
//     CTAs (32-64 KB).
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
//     SM count, the activations' 16-byte alignment): the same input gives
//     the same bits.
//   * A grid from the shape and the card. stats and backward_reduce run
//     half a wave (2 CTAs an SM), each CTA walking N / chunks samples, so
//     that the last CTAs sum few partials; apply runs the whole waves of
//     kCtasPerSm CTAs an SM nearest 8 vectors a thread, enough to hide a
//     CTA's start-up and few enough that the waves even out the SMs' pace.
//   * apply and backward_reduce compute each channel's moments once a CTA,
//     into shared memory, and each thread keeps its V positions' moments
//     (and apply's parameters) in registers.
//   * What is left: at the small late shapes (a few to 40 MB) the launch,
//     the CTAs' reductions and the last CTA's sum are a fixed cost beside
//     a few microseconds of reading; apply, reading and writing, runs
//     near what the memory gives a copy.
//
// dx runs on the (tile, sample chunk) grid of the first design: the
// threads of a CTA sit on 256 consecutive positions of the plane and walk
// their chunk's samples one element at a time.
//
// Plain C interface, loaded with ctypes (radar_sounder_crw_tpu_torch/ops/
// bn_cuda.py); the wrapper plans the grids and allocates the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of a CTA; positions of a dx tile
constexpr int kCtasPerSm = 4;  // stats' and apply's residency (launch bounds): CTAs an SM
constexpr int kReduceCtasPerSm = 2;  // a reduction's grid, CTAs an SM; backward_reduce's bounds
constexpr int kMaxSlots = 128;  // channel slots of a tile of the tiled kernels
constexpr int kUnroll = 4;      // independent vector loads a thread keeps in flight
constexpr int kPairs = 2;       // (g, x) vector pairs a backward_reduce thread keeps in flight

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

// -- the tiled kernels -------------------------------------------------------

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

struct TilePlan {
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

__device__ __forceinline__ TileSpan tile_span(const TilePlan& pl, int V, int t) {
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

// The end of a one-launch reduction on a (tile, chunk) grid, called by
// every thread of CTA (t, s) once its rows' sums are in red[0], red[1]
// (row ty's positions at ty * tile * V): the tile's channels summed over
// its rows and positions into the CTA's partials (q, t, s, slot); then the
// ticket finds the ticket group's last CTA, which sums the group's
// partials in a fixed order, calls out(c, a, b) once a channel and resets
// the ticket.
template <int V, class Out>
__device__ __forceinline__ void reduce_tiles(const TilePlan& pl, const TileSpan& sp,
                                             const float (&red)[2][kThreads * V],
                                             float* __restrict__ partial,
                                             unsigned* __restrict__ tickets, const Out& out,
                                             float* wsum, bool& last) {
  const int t = blockIdx.x, s = blockIdx.y;
  const int W = pl.tile * V;  // positions of a row of `red`
  const size_t qstride = static_cast<size_t>(pl.tiles) * pl.chunks * pl.slots;
  struct Span {
    int n, pa, len;  // items (rows x positions), first position, positions
  };
  float* mine = partial + (static_cast<size_t>(t) * pl.chunks + s) * pl.slots;
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
        mine[j] = va;
        mine[qstride + j] = vb;
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
      [&](int j, float va, float vb) { out(c_first + j, va, vb); }, wsum);
  if (threadIdx.x == 0) tickets[g] = 0;
}

// s1, s2 of every channel and the count n, in one launch on a (tile,
// chunk) grid: each CTA's partials, then the last CTA of each ticket group
// sums its group's.
template <typename E, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) stats_kernel(
    const E* __restrict__ x, TilePlan pl, float* __restrict__ partial,
    unsigned* __restrict__ tickets, float* __restrict__ sums) {
  __shared__ float red[2][kThreads * V];
  __shared__ float wsum[2 * kThreads / 32];
  __shared__ bool last;
  using P = Pack<E, V>;
  const int s = blockIdx.y;
  const TileSpan sp = tile_span(pl, V, blockIdx.x);
  const int tx = threadIdx.x % pl.tile, ty = threadIdx.x / pl.tile;
  if (ty < pl.rows && tx * V < sp.npos) {
    float a[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    const size_t plane = static_cast<size_t>(pl.vp) * V;
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
    const int at = ty * pl.tile * V + tx * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][at + k] = a[k];
      red[1][at + k] = b[k];
    }
  }
  __syncthreads();
  reduce_tiles<V>(
      pl, sp, red, partial, tickets,
      [&](int c, float va, float vb) {
        sums[c] = va;
        sums[pl.C + c] = vb;
        if (c == 0) sums[2 * pl.C] = static_cast<float>(static_cast<long long>(pl.N) * pl.HW);
      },
      wsum, last);
}

// sum g and sum g * xhat, xhat = (x - mean) * inv, of every channel on
// stats' design: the CTA's channels' moments once into shared memory, each
// thread's V positions' in registers, kPairs (g, x) vector pairs in
// flight, then stats' partials and ticket.
template <typename E, int V>
__global__ void __launch_bounds__(kThreads, kReduceCtasPerSm) backward_reduce_kernel(
    const E* __restrict__ g, const E* __restrict__ x, const float* __restrict__ sums, float eps,
    TilePlan pl, float* __restrict__ partial, unsigned* __restrict__ tickets,
    float* __restrict__ gsums) {
  __shared__ float red[2][kThreads * V];
  __shared__ float prm[2][kMaxSlots];
  __shared__ float wsum[2 * kThreads / 32];
  __shared__ bool last;
  using P = Pack<E, V>;
  const int s = blockIdx.y;
  const TileSpan sp = tile_span(pl, V, blockIdx.x);
  for (int j = threadIdx.x; j < sp.nslots; j += blockDim.x) {
    const Moments m = moments(sums, pl.C, sp.c_lo + j, eps);
    prm[0][j] = m.mean;
    prm[1][j] = m.inv;
  }
  __syncthreads();
  const int tx = threadIdx.x % pl.tile, ty = threadIdx.x / pl.tile;
  if (ty < pl.rows && tx * V < sp.npos) {
    float mu[V], iv[V], a[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = (sp.pos0 + tx * V + k) / pl.HW - sp.c_lo;
      mu[k] = prm[0][j];
      iv[k] = prm[1][j];
      a[k] = b[k] = 0.f;
    }
    auto add = [&](const P& vg, const P& vx) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = widen(vg.e[k]);
        const float xhat = __fmul_rn(__fsub_rn(widen(vx.e[k]), mu[k]), iv[k]);
        a[k] = __fadd_rn(a[k], f);
        b[k] = __fadd_rn(b[k], __fmul_rn(f, xhat));
      }
    };
    const size_t plane = static_cast<size_t>(pl.vp) * V;
    const int n1 = min(pl.N, (s + 1) * pl.chunk);
    const size_t step = static_cast<size_t>(pl.rows) * plane;
    int n = s * pl.chunk + ty;
    const size_t off = static_cast<size_t>(n) * plane + sp.pos0 + tx * V;
    const E* pg = g + off;
    const E* px = x + off;
    for (; n + (kPairs - 1) * pl.rows < n1; n += kPairs * pl.rows) {
      P vg[kPairs], vx[kPairs];
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        vg[u].raw = __ldg(reinterpret_cast<const typename P::Raw*>(pg + u * step));
        vx[u].raw = __ldg(reinterpret_cast<const typename P::Raw*>(px + u * step));
      }
      pg += kPairs * step;
      px += kPairs * step;
#pragma unroll
      for (int u = 0; u < kPairs; ++u) add(vg[u], vx[u]);
    }
    for (; n < n1; n += pl.rows, pg += step, px += step) {
      P vg, vx;
      vg.raw = __ldg(reinterpret_cast<const typename P::Raw*>(pg));
      vx.raw = __ldg(reinterpret_cast<const typename P::Raw*>(px));
      add(vg, vx);
    }
    const int at = ty * pl.tile * V + tx * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][at + k] = a[k];
      red[1][at + k] = b[k];
    }
  }
  __syncthreads();
  reduce_tiles<V>(
      pl, sp, red, partial, tickets,
      [&](int c, float va, float vb) {
        gsums[c] = va;
        gsums[pl.C + c] = vb;
      },
      wsum, last);
}

// y = ((x - mean) * inv) * scale + bias on the stats' grid; the chunk-0
// CTAs also write each channel's mean and var (the tile where it starts).
template <typename E, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) apply_kernel(
    const E* __restrict__ x, const float* __restrict__ sums, const float* __restrict__ scale,
    const float* __restrict__ bias, float eps, TilePlan pl, E* __restrict__ y,
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

template <typename E>
struct Elem {
  using type = E;
};

// launch(Elem<E>{}, std::integral_constant<int, V>{}) for the dtype's
// element as stored (float, or bfloat16 as its 16 bits) and the plan's
// vector: the kernel variant a plan runs.
template <class Launch>
int by_variant(int dtype, int vector, const Launch& launch) {
  using std::integral_constant;
  if (dtype == 1) {
    switch (vector) {
      case 8: return launch(Elem<unsigned short>{}, integral_constant<int, 8>{});
      case 4: return launch(Elem<unsigned short>{}, integral_constant<int, 4>{});
      case 2: return launch(Elem<unsigned short>{}, integral_constant<int, 2>{});
      default: return launch(Elem<unsigned short>{}, integral_constant<int, 1>{});
    }
  }
  switch (vector) {
    case 4: return launch(Elem<float>{}, integral_constant<int, 4>{});
    case 2: return launch(Elem<float>{}, integral_constant<int, 2>{});
    default: return launch(Elem<float>{}, integral_constant<int, 1>{});
  }
}

// Whether p is a multiple of the plan's vector in bytes.
bool aligned(const void* p, int dtype, int vector) {
  return reinterpret_cast<std::uintptr_t>(p) % (vector * (dtype == 1 ? 2 : 4)) == 0;
}

// The channel slots a tile's partials need: its whole channels where tiles
// end on channel boundaries, else the most any run of its positions spans.
int slots_needed(const TilePlan& pl, int vector) {
  const int positions = pl.tile * vector;
  if (pl.tiles == 1) return pl.C;
  if (positions % pl.HW == 0) return positions / pl.HW;
  return std::min(pl.C, (positions + pl.HW - 2) / pl.HW + 1);
}

// A plan the kernels can run: its vector one of the dtype's, its grid
// covering the samples and the plane once, its threads and slots within
// the kernels' arrays, a ticket a tile only where tiles hold whole
// channels.
bool valid(int dtype, int vector, const TilePlan& pl, int threads) {
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

// -- dx on the first design's grid -------------------------------------------

struct Plan {
  int N, C, HW, chunk, S, ntiles;
  __device__ int plane() const { return C * HW; }
};

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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Every pointer is on the current device;
// x, g, y and dx are contiguous (N, C, H, W); sums, gsums, scale, bias,
// mean and var float32 (C,); sums is (2C + 1,): s1, s2 and the count n
// (the stats pass writes this rank's n = N*HW; a mesh sums all three), gsums
// (2C,).
//
// The tiled kernels take the plan of ops/bn_cuda.tile_plan: vector, tile,
// rows, threads, tiles, chunk, chunks, slots, group; x, y and g lie on
// multiples of the vector's bytes. partial is 2 * tiles * chunks * slots
// floats; tickets holds one zero unsigned a ticket group (ceil(tiles /
// group)), and is zero again when the launch ends: launches that share the
// tickets run in one stream's order. dx takes (chunk, S) of
// ops/bn_cuda.backward_plan.

int bn_train_stats(const void* x, int dtype, int N, int C, int HW, int vector, int tile,
                   int rows, int threads, int tiles, int chunk, int chunks, int slots, int group,
                   float* partial, unsigned* tickets, float* sums, void* stream) {
  const TilePlan pl{N, C, HW, C * HW / vector, tile, rows, tiles, chunk, chunks, slots, group};
  if (!valid(dtype, vector, pl, threads) || !aligned(x, dtype, vector)) {
    return cudaErrorInvalidValue;
  }
  return by_variant(dtype, vector, [&](auto elem, auto v) {
    using E = typename decltype(elem)::type;
    stats_kernel<E, decltype(v)::value>
        <<<dim3(pl.tiles, pl.chunks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const E*>(x), pl, partial, tickets, sums);
    return static_cast<int>(cudaGetLastError());
  });
}

int bn_train_apply(const void* x, int dtype, const float* sums, const float* scale,
                   const float* bias, float eps, int N, int C, int HW, int vector, int tile,
                   int rows, int threads, int tiles, int chunk, int chunks, int slots, int group,
                   void* y, float* mean, float* var, void* stream) {
  const TilePlan pl{N, C, HW, C * HW / vector, tile, rows, tiles, chunk, chunks, slots, group};
  if (!valid(dtype, vector, pl, threads) || !aligned(x, dtype, vector) ||
      !aligned(y, dtype, vector)) {
    return cudaErrorInvalidValue;
  }
  return by_variant(dtype, vector, [&](auto elem, auto v) {
    using E = typename decltype(elem)::type;
    apply_kernel<E, decltype(v)::value>
        <<<dim3(pl.tiles, pl.chunks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const E*>(x), sums, scale, bias, eps, pl, static_cast<E*>(y), mean, var);
    return static_cast<int>(cudaGetLastError());
  });
}

int bn_train_backward_reduce(const void* g, const void* x, int dtype, const float* sums,
                             float eps, int N, int C, int HW, int vector, int tile, int rows,
                             int threads, int tiles, int chunk, int chunks, int slots, int group,
                             float* partial, unsigned* tickets, float* gsums, void* stream) {
  const TilePlan pl{N, C, HW, C * HW / vector, tile, rows, tiles, chunk, chunks, slots, group};
  if (!valid(dtype, vector, pl, threads) || !aligned(g, dtype, vector) ||
      !aligned(x, dtype, vector)) {
    return cudaErrorInvalidValue;
  }
  return by_variant(dtype, vector, [&](auto elem, auto v) {
    using E = typename decltype(elem)::type;
    backward_reduce_kernel<E, decltype(v)::value>
        <<<dim3(pl.tiles, pl.chunks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const E*>(g), static_cast<const E*>(x), sums, eps, pl, partial, tickets,
            gsums);
    return static_cast<int>(cudaGetLastError());
  });
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
// dx tile), stats' and apply's CTAs an SM, channel slots of a tile,
// backward_reduce's CTAs an SM.
int bn_train_constant(int which) {
  switch (which) {
    case 0: return kThreads;
    case 1: return kCtasPerSm;
    case 2: return kMaxSlots;
    case 3: return kReduceCtasPerSm;
    default: return -1;
  }
}

const char* bn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
