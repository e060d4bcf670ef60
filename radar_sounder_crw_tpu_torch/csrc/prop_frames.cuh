// The two kernels the whole-sequence propagations prop_seq.cu and
// prop_all.cu are built from: every frame's selection at once, and the
// label chain over the selected lists.
//
// A frame's winners depend on the embeddings alone, not on any label, so
// the frame chain of a radargram splits in two. For radargram b and frame
// t = 1..T-1, over the valid slot prefix ns = L + min(t, cxt)
// (L = len(long_mem)):
//
//   slot s < L   (pin j = s):  frame long_mem[j] once it was pushed (t >
//                long_mem[j]), else empty; valid iff t - long_mem[j] > cxt;
//   slot L + r   (ring, r < min(t, cxt)): the last frame f < t with
//                f mod cxt == r; always valid;
//   aff[s*N+i] = ((emb[b,f,i] . emb[b,t,n] + mask[i,n]) + bias_s) / temperature,
//                bias_s = 0 or NEG_INVALID; an empty slot reads zeros.
//
//   `select`: one CTA per (query tile, frame t, radargram b),
//      B x (T-1) x ceil(N/64) in all, each running the tile core of
//      prop_tile.cuh over frame t's prefix read straight from `emb` through
//      the slot table. It leaves each query's knn winners (value v_j,
//      candidate row r_j) in winner order in shared memory, and its epilogue
//      writes them out as (source, value) pairs: source (f + 1)*N + i for
//      node i of frame f (below N: no label, an unwritten pin or a missing
//      winner). With e_j = exp(v_j - v_0) (0 for a missing winner):
//        kWeights = false  (prop_seq): value e_j, in winner order;
//        kWeights = true   (prop_all): den = sum_j e_j in winner order, value
//                          w_j = e_j / den (an IEEE division), the entries
//                          in ASCENDING candidate row r_j, missing winners
//                          last.
//   `chain`: one CTA per radargram walks t = 1..T-1 in order, a
//      __syncthreads() between frames, summing value_j * soft[b,f_j,i_j] in
//      the stored order, the product and the sum rounded separately
//      (prop_common.cuh):
//        kDivide = true   (prop_seq): soft[b,t,n] = sum / sum_j value_j;
//        kDivide = false  (prop_all): soft[b,t,n] = sum.
//      The radargram's labels stay in shared memory where T*N*M floats fit
//      (the survey's 120 KB) and are written out once; otherwise they are
//      read and written in global memory (MC3 width: 456 KB).
//
// No (ns*N, N) affinity is ever stored and no label is read before the
// chain. An entry of an invalid slot (NEG_INVALID: a pin whose frame is
// still in the ring, or not yet written) wins only when knn exceeds the
// valid candidates and then has e_j = 0 exactly: it adds +0 to den and to
// the sum wherever it is sorted.

#pragma once

#include <algorithm>

#include "prop_tile.cuh"

namespace prop {
namespace frames {

constexpr int kChainThreads = 256;

// Frame t's candidates: slot s holds frame slot_frame[s] (-1: empty, a
// zero row) with bias slot_bias[s].
struct SlotRows {
  const float* emb_b;  // (T, N, C) of radargram b
  const int* slot_frame;
  const float* slot_bias;
  int N, C;
  __device__ const float* row(int r) const {
    const int s = r / N;
    const int f = slot_frame[s];
    return f >= 0 ? emb_b + (static_cast<size_t>(f) * N + (r - s * N)) * C : nullptr;
  }
  __device__ const float* base() const { return emb_b; }
  __device__ float bias(int s) const { return slot_bias[s]; }
};

template <bool kVec4, bool kWeights>
__global__ void __launch_bounds__(tile::kThreads, tile::kMinBlocks)
select(const float* __restrict__ emb,     // (B, T, N, C)
       const float* __restrict__ mask,    // (N, N) [src, query]
       const int* __restrict__ long_mem,  // (L,) pinned frames
       int* __restrict__ src_out,         // (B, T-1, N, knn)
       float* __restrict__ val_out,       // (B, T-1, N, knn)
       int T, int N, int C, int L, int cxt, float temperature, int knn) {
  extern __shared__ float4 smem4[];
  const tile::Smem sm = tile::carve(reinterpret_cast<float*>(smem4), knn);
  const int n0 = blockIdx.x * tile::kQ;
  const int t = blockIdx.y + 1;
  const int b = blockIdx.z;
  const int ns = L + min(t, cxt);
  int* slot_frame = reinterpret_cast<int*>(sm.end);
  float* slot_bias = sm.end + ns;
  for (int s = threadIdx.x; s < ns; s += tile::kThreads) {
    int f;
    bool valid;
    if (s < L) {
      const int fj = long_mem[s];
      f = fj < t ? fj : -1;
      valid = t - fj > cxt;
    } else {
      const int r = s - L;
      f = r + cxt * ((t - 1 - r) / cxt);
      valid = true;
    }
    slot_frame[s] = f;
    slot_bias[s] = valid ? 0.f : kNegInvalid;
  }
  __syncthreads();
  const float* emb_b = emb + static_cast<size_t>(b) * T * N * C;
  tile::run<kVec4>(SlotRows{emb_b, slot_frame, slot_bias, N, C},
                   emb_b + static_cast<size_t>(t) * N * C, mask, n0, N, C, temperature, knn, 0,
                   ns * N, sm);
  const int lane = threadIdx.x & 31;
  // candidate row r -> source (INT_MAX: a missing winner, no label)
  auto source = [&](int r) {
    if (r == INT_MAX) return 0;
    const int s = r / N;
    return (slot_frame[s] + 1) * N + (r - s * N);
  };
  for (int ql = threadIdx.x >> 5; ql < tile::kQ && n0 + ql < N; ql += tile::kWarps) {
    float* lv = sm.lv + ql * knn;
    const int* li = sm.li + ql * knn;
    const size_t out = ((static_cast<size_t>(b) * (T - 1) + (t - 1)) * N + n0 + ql) * knn;
    const float v0 = lv[0];
    if constexpr (!kWeights) {
      for (int j = lane; j < knn; j += 32) {
        src_out[out + j] = source(li[j]);
        val_out[out + j] = li[j] != INT_MAX ? expf(lv[j] - v0) : 0.f;
      }
    } else {
      __syncwarp();  // every lane holds v0 before e_0 takes its place
      for (int j = lane; j < knn; j += 32) lv[j] = li[j] != INT_MAX ? expf(lv[j] - v0) : 0.f;
      __syncwarp();
      float den = 0.f;  // in winner order, the same chain in every lane
      for (int j = 0; j < knn; ++j) den += lv[j];
      // each entry to its rank by candidate row (rows are distinct; the
      // missing winners, all INT_MAX, keep their order at the end)
      for (int j = lane; j < knn; j += 32) {
        const int r = li[j];
        int rank = 0;
        for (int k = 0; k < knn; ++k) {
          const int rk = li[k];
          rank += (rk < r || (rk == r && k < j)) ? 1 : 0;
        }
        src_out[out + rank] = source(r);
        val_out[out + rank] = lv[j] / den;
      }
    }
  }
}

template <bool kDivide>
__global__ void __launch_bounds__(kChainThreads)
chain(const int* __restrict__ src,    // (B, T-1, N, knn)
      const float* __restrict__ val,  // (B, T-1, N, knn)
      float* soft,                    // (B, T, N, M); frame 0 = seeds
      int T, int N, int M, int knn, int in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  int* ls = reinterpret_cast<int*>(smem);  // frame t's lists
  float* lw = smem + N * knn;
  float* soft_b = soft + static_cast<size_t>(b) * T * N * M;
  float* lab = in_smem ? lw + N * knn : soft_b;  // (T, N, M)
  if (in_smem) {
    for (int x = threadIdx.x; x < N * M; x += kChainThreads) lab[x] = soft_b[x];
  }
  for (int t = 1; t < T; ++t) {
    __syncthreads();  // frame t-1's labels are in place; the lists are free
    const size_t base = (static_cast<size_t>(b) * (T - 1) + (t - 1)) * N * knn;
    for (int x = threadIdx.x; x < N * knn; x += kChainThreads) {
      ls[x] = src[base + x];
      lw[x] = val[base + x];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < N * M; x += kChainThreads) {
      const int n = x / M;
      const int m = x - n * M;
      float num = 0.f, den = 0.f;
      for (int j = 0; j < knn; ++j) {
        const int s = ls[n * knn + j];
        const float w = lw[n * knn + j];
        num = add_weighted(num, w, s >= N ? lab[(s - N) * M + m] : 0.f);
        if (kDivide) den += w;
      }
      lab[(static_cast<size_t>(t) * N + n) * M + m] = kDivide ? num / den : num;
    }
  }
  if (in_smem) {
    __syncthreads();
    for (int x = N * M + threadIdx.x; x < T * N * M; x += kChainThreads) soft_b[x] = lab[x];
  }
}

template <bool kWeights>
decltype(&select<true, kWeights>) select_for(int vec4) {
  return vec4 ? select<true, kWeights> : select<false, kWeights>;
}

inline size_t select_smem_bytes(int knn, int ns_max) {
  return tile::smem_bytes(knn) + 2 * sizeof(float) * static_cast<size_t>(ns_max);
}

inline size_t chain_smem_bytes(int T, int N, int M, int knn, bool in_smem) {
  return sizeof(float) * (2 * static_cast<size_t>(N) * knn +
                          (in_smem ? static_cast<size_t>(T) * N * M : 0));
}

// Dynamic shared memory bytes a CTA of either kernel may use; -1 on a CUDA
// error.
template <bool kWeights, bool kDivide>
int max_dynamic_smem() {
  const int a = tile::max_dynamic_smem(select<true, kWeights>);
  const int b = tile::max_dynamic_smem(select<false, kWeights>);
  const int c = tile::max_dynamic_smem(chain<kDivide>);
  if (a < 0 || b < 0 || c < 0) return -1;
  return std::min(a, std::min(b, c));
}

// Every frame's lists on `stream`. Returns the cudaError_t of the launch
// (0 = success).
template <bool kWeights>
int select_launch(const float* emb, const float* mask, const int* long_mem, int* src, float* val,
                  int B, int T, int N, int C, int L, int cxt, float temperature, int knn,
                  int ns_max, int vec4, void* stream) {
  static size_t done[2] = {0, 0};
  const size_t dyn = select_smem_bytes(knn, ns_max);
  const auto kernel = select_for<kWeights>(vec4);
  const int err = tile::reserve_smem(kernel, dyn, done[vec4 ? 1 : 0]);
  if (err != 0) return err;
  const dim3 grid((N + tile::kQ - 1) / tile::kQ, T - 1, B);
  kernel<<<grid, tile::kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      emb, mask, long_mem, src, val, T, N, C, L, cxt, temperature, knn);
  return static_cast<int>(cudaGetLastError());
}

// The label chain of every radargram from `select`'s lists on `stream`;
// soft[:, 0] must hold the seeds. Returns the cudaError_t of the launch
// (0 = success).
template <bool kDivide>
int chain_launch(const int* src, const float* val, float* soft, int B, int T, int N, int M,
                 int knn, int in_smem, void* stream) {
  static size_t done = 0;
  const size_t dyn = chain_smem_bytes(T, N, M, knn, in_smem != 0);
  const auto kernel = chain<kDivide>;
  const int err = tile::reserve_smem(kernel, dyn, done);
  if (err != 0) return err;
  kernel<<<B, kChainThreads, dyn, static_cast<cudaStream_t>(stream)>>>(src, val, soft, T, N, M,
                                                                       knn, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frames
}  // namespace prop
