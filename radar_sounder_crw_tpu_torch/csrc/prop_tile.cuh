// The tile core shared by prop_step.cu and the all-frames selection of
// prop_seq.cu and prop_all.cu (prop_frames.cuh): the exact top-knn of a
// tile of kQ queries over a run of candidate rows.
//
// For candidate r of the run [r_begin, r_end) (slot s = r / N, node
// i = r - s*N) and query n:
//
//   aff[r, n] = ((rows.row(r) . query[n] + mask[i, n]) + rows.bias(s)) / temperature
//
// in float32 on the FMA pipes (no tensor cores: the TPU side computes the
// product at Precision.HIGHEST) with a true division. Each query keeps a
// running list of its knn best candidates in (value descending, index
// ascending) order, the order of `lax.top_k` (prop_common.cuh); the
// affinity column itself is never stored.
//
// Design. The CTA (8 warps) walks the run in tiles of kR = 128 rows. Each
// tile's product is register-tiled: the rows and the queries stream
// through two shared-memory stages of kKC channels (cp.async, the next
// stage in flight while the current one is computed; the small footprint
// lets three CTAs share an SM), and each thread owns a 4-row x 8-query
// micro-tile, so one staged float4 of a row serves 8 queries with 32 FMAs
// and no cross-lane reduction. The epilogue adds mask, bias and the
// temperature division in registers and writes the tile's 128 x 64 values
// to shared memory (over the stages). Then warp w selects for queries
// w, w + 8, ...: the tile values that beat the query's current knn-th entry
// survive and are merged into its sorted list (`offer`, below). After the
// first tile few values beat the threshold, so most merges are a handful
// of insertions.
//
// Bound on this card: the product's float32 FMAs (67 TFLOP/s). What holds
// the core back from it: each FMA reads about a byte of shared memory (a
// float4 of a row or a query serves 32 FMAs), and an SM reads 128 bytes of
// shared memory per clock against 128 FMAs; the epilogue's IEEE divisions
// and the selection's shuffles add instructions beside the product.
//
// A row source `Rows` gives `row(r)` (a pointer to C floats, or nullptr for
// an all-zero row) and `bias(s)` (the slot's validity bias): the explicit
// ring for prop_step, the embeddings through the slot table for prop_seq
// and prop_all.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "prop_common.cuh"

namespace prop {
namespace tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 64;                  // queries per tile
constexpr int kMinBlocks = 3;           // CTAs an SM holds (registers <= 85 a thread)
constexpr int kRowsPer = 4;             // rows of a thread's micro-tile (x 8 queries)
constexpr int kR = kWarps * 4 * kRowsPer;  // candidate rows per tile: 128
constexpr int kKC = 32;                 // channels per stage
constexpr int kStageStride = kKC + 4;   // floats per staged row (16-byte aligned, no conflicts)
constexpr int kTvStride = kR + 4;       // floats per query in the tile's values
constexpr int kSlots = kR / 32;         // tile values per lane in the selection
constexpr int kMaxListChunks = 8;       // knn <= 256: a lane holds one list entry per 32
constexpr int kInsertMax = 12;          // survivors inserted one by one; more are sorted
// the two stages, and the tile's values over them once the product is done
constexpr int kStageFloats = 2 * kR * kStageStride > kQ * kTvStride ? 2 * kR * kStageStride
                                                                     : kQ * kTvStride;
static_assert(8 * 8 == kQ, "8 query groups x 8 queries");

// Entries of a warp's buffer in `offer`.
__host__ __device__ inline int buf_len(int knn) { return knn > 32 ? knn : 32; }

// Dynamic shared memory of the core: the query stages, the row stages (the
// tile values over them), the kQ running lists and one buffer per warp.
inline size_t smem_bytes(int knn) {
  return sizeof(float) * (2 * kQ * kStageStride + kStageFloats +
                          2 * (static_cast<size_t>(kQ) * knn + kWarps * buf_len(knn)));
}

struct Smem {
  float* q;      // 2 stages of (kQ, kStageStride): the queries' channels
  float* stage;  // 2 stages of (kR, kStageStride); (kQ, kTvStride) values after the product
  float* lv;     // (kQ, knn) running lists: values
  int* li;       //                          candidate indices
  float* wv;     // (kWarps, buf_len) warp buffers
  int* wi;
  float* end;    // what a kernel keeps beyond the core
};

__device__ inline Smem carve(float* base, int knn) {
  Smem s;
  s.q = base;
  s.stage = s.q + 2 * kQ * kStageStride;
  s.lv = s.stage + kStageFloats;
  s.li = reinterpret_cast<int*>(s.lv + kQ * knn);
  s.wv = reinterpret_cast<float*>(s.li + kQ * knn);
  s.wi = reinterpret_cast<int*>(s.wv + kWarps * buf_len(knn));
  s.end = reinterpret_cast<float*>(s.wi + kWarps * buf_len(knn));
  return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- selection --------------------------------------------------------------
//
// A query's running list holds its knn best (value, index) pairs so far in
// winner order, sentinels (-inf, INT_MAX) past the candidates seen. A
// warp merges a candidate set (kU per lane) into it without a chain of
// selection passes. Survivors are the candidates better than the list's
// last entry. With knn <= 32 the list sits in registers, one entry per
// lane, and
//   * a few survivors (<= kInsertMax) are inserted one by one: a ballot
//     gives the rank, the entries below move down one lane (`insert`);
//   * up to 32 are compacted one per lane, sorted by a bitonic network and
//     merged with the list by a bitonic merge (`sort_merge`);
//   * more than 32 (a fresh list) are first cut to those at or above the
//     knn-th best of the 32 lanes' own bests, a lower bound of the knn-th
//     best of the set (`prefilter`).
// With knn > 32, or still more than 32 survivors, each survivor is
// broadcast in turn and every element's rank in the pool of list and
// survivors is counted (`rank_merge`).

// One step of a bitonic network across the warp: lanes l and l ^ j
// exchange, and in a block ordered best first the lower lane keeps the
// better entry.
__device__ __forceinline__ void bitonic_step(float& v, int& i, int j, bool best_first) {
  const float ov = __shfl_xor_sync(kFull, v, j);
  const int oi = __shfl_xor_sync(kFull, i, j);
  const bool lower = (threadIdx.x & j) == 0;
  if ((lower == best_first) == lex_better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// Sorts one (value, index) per lane across the warp, best in lane 0.
__device__ __forceinline__ void warp_sort(float& v, int& i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) bitonic_step(v, i, j, (lane & k) == 0);
}

// Candidates ok[u] that beat (tv, ti); returns their count over the warp.
template <int kU>
__device__ __forceinline__ int survivors(const float (&v)[kU], const int (&r)[kU], bool (&ok)[kU],
                                         float tv, int ti) {
  int S = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    ok[u] = ok[u] && lex_better(v[u], r[u], tv, ti);
    S += __popc(__ballot_sync(kFull, ok[u]));
  }
  return S;
}

// More than 32 survivors: keep those at or above the knn-th best (knn <= 32)
// of the lanes' own bests; returns the new count.
template <int kU>
__device__ inline int prefilter(const float (&v)[kU], const int (&r)[kU], bool (&ok)[kU], int S,
                                int knn) {
  float mv = -INFINITY;
  int mi = INT_MAX;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (ok[u] && lex_better(v[u], r[u], mv, mi)) {
      mv = v[u];
      mi = r[u];
    }
  }
  warp_sort(mv, mi);
  const float bv = __shfl_sync(kFull, mv, knn - 1);
  const int bi = __shfl_sync(kFull, mi, knn - 1);
  if (bi == INT_MAX) return S;  // fewer than knn lanes hold candidates
  S = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    ok[u] = ok[u] && !lex_better(bv, bi, v[u], r[u]);
    S += __popc(__ballot_sync(kFull, ok[u]));
  }
  return S;
}

// (cv, ci) into the register list (xv, xi) at its rank.
__device__ __forceinline__ void insert(float cv, int ci, float& xv, int& xi) {
  const int lane = threadIdx.x & 31;
  const int p = __popc(__ballot_sync(kFull, lex_better(xv, xi, cv, ci)));
  const float yv = __shfl_up_sync(kFull, xv, 1);
  const int yi = __shfl_up_sync(kFull, xi, 1);
  if (lane == p) {
    xv = cv;
    xi = ci;
  } else if (lane > p) {
    xv = yv;
    xi = yi;
  }
}

// Up to 32 survivors into the register list (xv, xi): compacted one per
// lane through the warp buffer (wv, wi), sorted, and merged: the best 32 of
// the two sorted lists form a bitonic sequence, which a last pass sorts.
template <int kU>
__device__ inline void sort_merge(const float (&v)[kU], const int (&r)[kU], const bool (&ok)[kU],
                                  int S, float& xv, int& xi, float* wv, int* wi) {
  const int lane = threadIdx.x & 31;
  int base = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const unsigned m = __ballot_sync(kFull, ok[u]);
    if (ok[u]) {
      const int pos = base + __popc(m & ((1u << lane) - 1u));
      wv[pos] = v[u];
      wi[pos] = r[u];
    }
    base += __popc(m);
  }
  __syncwarp();
  float cv = lane < S ? wv[lane] : -INFINITY;
  int ci = lane < S ? wi[lane] : INT_MAX;
  __syncwarp();  // the buffer is free again
  warp_sort(cv, ci);
  const float rv = __shfl_sync(kFull, cv, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (lex_better(rv, ri, xv, xi)) {
    xv = rv;
    xi = ri;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) bitonic_step(xv, xi, j, true);
}

// Any knn, any number of survivors: the list in shared memory, each
// survivor broadcast once, ranks counted, elements of rank < knn written
// to their place through the warp buffer.
template <int kU>
__device__ inline void rank_merge(const float (&v)[kU], const int (&r)[kU], const bool (&ok)[kU],
                                  float* lv, int* li, float* wv, int* wi, int knn) {
  const int lane = threadIdx.x & 31;
  const int nc = (knn + 31) / 32;
  float ev[kMaxListChunks];
  int ei[kMaxListChunks], erank[kMaxListChunks];
#pragma unroll
  for (int c = 0; c < kMaxListChunks; ++c) {
    const int j = c * 32 + lane;
    const bool in = c < nc && j < knn;
    ev[c] = in ? lv[j] : -INFINITY;
    ei[c] = in ? li[j] : INT_MAX;
    erank[c] = j;
  }
  int srank[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) srank[u] = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    unsigned mm = __ballot_sync(kFull, ok[u]);
    while (mm != 0) {
      const int src = __ffs(mm) - 1;
      mm &= mm - 1;
      const float cv = __shfl_sync(kFull, v[u], src);
      const int ci = __shfl_sync(kFull, r[u], src);
      int above = 0;  // list entries better than the survivor
#pragma unroll
      for (int c = 0; c < kMaxListChunks; ++c) {
        if (c < nc) {
          above += __popc(__ballot_sync(kFull, lex_better(ev[c], ei[c], cv, ci)));
          erank[c] += lex_better(cv, ci, ev[c], ei[c]);
        }
      }
      if (lane == src) srank[u] += above;
#pragma unroll
      for (int w = 0; w < kU; ++w) srank[w] += ok[w] && lex_better(cv, ci, v[w], r[w]);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxListChunks; ++c) {
    if (c < nc && c * 32 + lane < knn && erank[c] < knn) {
      wv[erank[c]] = ev[c];
      wi[erank[c]] = ei[c];
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (ok[u] && srank[u] < knn) {
      wv[srank[u]] = v[u];
      wi[srank[u]] = r[u];
    }
  }
  __syncwarp();
  for (int j = lane; j < knn; j += 32) {
    lv[j] = wv[j];
    li[j] = wi[j];
  }
  __syncwarp();
}

// The candidate set (v, r, ok) of one query into its list (lv, li); wv, wi:
// a warp buffer of buf_len(knn) entries. Warp-uniform; ends with the list
// visible to the whole warp.
template <int kU>
__device__ inline void offer(const float (&v)[kU], const int (&r)[kU], bool (&ok)[kU], float* lv,
                             int* li, float* wv, int* wi, int knn) {
  const int lane = threadIdx.x & 31;
  int S = survivors(v, r, ok, lv[knn - 1], li[knn - 1]);
  if (S == 0) return;
  if (knn <= 32 && S > 32) S = prefilter(v, r, ok, S, knn);
  if (knn > 32 || S > 32) {
    rank_merge(v, r, ok, lv, li, wv, wi, knn);
    return;
  }
  float xv = lane < knn ? lv[lane] : -INFINITY;
  int xi = lane < knn ? li[lane] : INT_MAX;
  if (S <= kInsertMax) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      for (unsigned mm = __ballot_sync(kFull, ok[u]); mm != 0; mm &= mm - 1) {
        const int src = __ffs(mm) - 1;
        insert(__shfl_sync(kFull, v[u], src), __shfl_sync(kFull, r[u], src), xv, xi);
      }
    }
  } else {
    sort_merge(v, r, ok, S, xv, xi, wv, wi);
  }
  __syncwarp();
  if (lane < knn) {
    lv[lane] = xv;
    li[lane] = xi;
  }
  __syncwarp();
}

// One tile's values tv (query ql at ql * kTvStride, row r0 + rl at rl)
// into the lists of this warp's queries ql = warp, warp + kWarps, ...
// below nq, one query after the other.
__device__ inline void select_tile(const float* tv, float* lv, int* li, float* wv, int* wi,
                                   int knn, int nq, int r0, int r_end) {
  const int lane = threadIdx.x & 31;
  for (int ql = threadIdx.x >> 5; ql < nq; ql += kWarps) {
    float v[kSlots];
    int r[kSlots];
    bool ok[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      v[u] = tv[ql * kTvStride + lane + 32 * u];
      r[u] = r0 + lane + 32 * u;
      ok[u] = r[u] < r_end;
    }
    offer(v, r, ok, lv + ql * knn, li + ql * knn, wv, wi, knn);
  }
}

// The rows [r0, r0 + kRows) ∩ [., r_end), channels [k0, k0 + kw), into one
// stage; rows past r_end, nullptr rows and channels past C read zeros.
template <bool kVec4, int kRows, class Rows>
__device__ __forceinline__ void load_stage(const Rows& rows, int r0, int r_end, int k0, int kw,
                                           int C, float* st) {
  const int per_row = kw >> 2;
  for (int x = threadIdx.x; x < kRows * per_row; x += kThreads) {
    const int rr = x / per_row;
    const int c = k0 + (x - rr * per_row) * 4;
    float* dst = st + rr * kStageStride + (c - k0);
    const int r = r0 + rr;
    const float* src = r < r_end ? rows.row(r) : nullptr;
    if (kVec4) {
      cp_async16(dst, src != nullptr ? src + c : rows.base(), src != nullptr ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[k] = (src != nullptr && c + k < C) ? src[c + k] : 0.f;
    }
  }
}

// The top-knn lists of queries n0 .. n0 + kQ - 1 (query n at qsrc + n*C)
// over the candidates [r_begin, r_end), left in sm.lv / sm.li (query ql at
// ql*knn, sentinels (-inf, INT_MAX) past the candidate count). Called by
// all threads; ends with a __syncthreads().
// The query tile's source: query n at qsrc + n*C.
struct QueryRows {
  const float* qsrc;
  int C;
  __device__ const float* row(int n) const { return qsrc + static_cast<size_t>(n) * C; }
  __device__ const float* base() const { return qsrc; }
};

template <bool kVec4, class Rows>
__device__ void run(const Rows& rows, const float* __restrict__ qsrc,
                    const float* __restrict__ mask, int n0, int N, int C, float temperature,
                    int knn, int r_begin, int r_end, const Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane >> 3;  // row group: rows warp*4*kRowsPer + rg + 4*i
  const int qg = lane & 7;   // query group: queries qg + 8*j
  const int c_pad = (C + 3) & ~3;
  const QueryRows queries{qsrc, C};
  // rows and queries, channels [k0, k0 + kw), into stage `buf`
  auto load = [&](int r0, int k0, int buf) {
    const int kw = min(kKC, c_pad - k0);
    load_stage<kVec4, kR>(rows, r0, r_end, k0, kw, C, sm.stage + buf * kR * kStageStride);
    load_stage<kVec4, kQ>(queries, n0, N, k0, kw, C, sm.q + buf * kQ * kStageStride);
    if (kVec4) cp_async_commit();
  };
  for (int x = threadIdx.x; x < kQ * knn; x += kThreads) {
    sm.lv[x] = -INFINITY;
    sm.li[x] = INT_MAX;
  }
  __syncthreads();

  const int nk = (c_pad + kKC - 1) / kKC;
  for (int r0 = r_begin; r0 < r_end; r0 += kR) {
    float acc[kRowsPer][8];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load(r0, 0, 0);
    for (int kc = 0; kc < nk; ++kc) {
      const int k0 = kc * kKC;
      const int kw = min(kKC, c_pad - k0);
      if (kc + 1 < nk) {
        load(r0, k0 + kKC, (kc + 1) & 1);
        if (kVec4) cp_async_wait<1>();
      } else if (kVec4) {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* st =
          sm.stage + (kc & 1) * kR * kStageStride + (warp * 4 * kRowsPer + rg) * kStageStride;
      const float* qq = sm.q + (kc & 1) * kQ * kStageStride + qg * kStageStride;
      for (int c = 0; c < kw; c += 4) {
        float4 a[kRowsPer];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i)
          a[i] = *reinterpret_cast<const float4*>(st + 4 * i * kStageStride + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(qq + 8 * j * kStageStride + c);
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
          }
        }
      }
      __syncthreads();  // the stage is refilled two steps on, or overwritten below
    }

    // epilogue: mask, slot bias, temperature; the values over the stages
    float* tv = sm.stage;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int rl = warp * 4 * kRowsPer + rg + 4 * i;
      const int r = r0 + rl;
      const bool live = r < r_end;
      const int s = r / N;
      const float* mrow = mask + static_cast<size_t>(r - s * N) * N + n0;
      const float bias = live ? rows.bias(s) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ql = qg + 8 * j;
        tv[ql * kTvStride + rl] = (live && n0 + ql < N)
                                      ? ((acc[i][j] + mrow[ql]) + bias) / temperature
                                      : -INFINITY;
      }
    }
    __syncthreads();

    select_tile(tv, sm.lv, sm.li, sm.wv + warp * buf_len(knn), sm.wi + warp * buf_len(knn), knn,
                min(kQ, N - n0), r0, r_end);
    __syncthreads();  // the values are overwritten by the next tile's stages
  }
}

// Sets a kernel's dynamic shared-memory limit once per process for each
// larger size (`done` holds the largest size set so far); returns the
// cudaError_t (0 = success).
template <class Kernel>
inline int reserve_smem(Kernel kernel, size_t bytes, size_t& done) {
  if (bytes <= done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) done = bytes;
  return static_cast<int>(err);
}

// Dynamic shared memory bytes a CTA of `kernel` may use; -1 on a CUDA error.
template <class Kernel>
inline int max_dynamic_smem(Kernel kernel) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

}  // namespace tile
}  // namespace prop
