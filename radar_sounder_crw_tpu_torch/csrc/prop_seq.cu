// Whole-sequence label propagation for a batch of radargrams, by hand for
// sm_90a: all B x (T-1) frames in two launches.
//
// Replaces the Pallas TPU kernel `_prop_seq_v2_kernel` in
// radar_sounder_crw_tpu/ops/labelprop_pallas.py (entries
// `propagate_all_pallas_v2` and `propagate_all_pallas_v2_batched`). It
// computes what that kernel computes, without its TPU layout (lane packing,
// padded rows and lanes, slot chunks). For radargram b and frame t = 1..T-1,
// over the valid slot prefix ns = L + min(t, cxt) (L = len(long_mem)):
//
//   slot s < L   (pin j = s):  frame long_mem[j] once it was pushed (t >
//                long_mem[j]), else empty; valid iff t - long_mem[j] > cxt;
//   slot L + r   (ring, r < min(t, cxt)): the last frame f < t with
//                f mod cxt == r; always valid;
//   aff[s*N+i] = ((emb[b,f,i] . emb[b,t,n] + mask[i,n]) + bias_s) / temperature,
//                bias_s = 0 or NEG_INVALID; an empty slot reads zeros;
//   soft[b,t,n] = the knn winners' softmax-weighted labels soft[b,f,i]
//                (prop_common.cuh), frame 0 being the seed.
//
// Design. A frame's winners depend on the embeddings alone, not on any
// label, so the frame chain splits in two:
//   A. `prop_seq_select`: one CTA per (query tile, frame t, radargram b),
//      B x (T-1) x ceil(N/64) in all, each running the tile core of
//      prop_tile.cuh over frame t's prefix read straight from `emb` through
//      the slot table, and writing each query's knn winners in winner order
//      as (source, e): source (f + 1)*N + i for frame f, node i (below N: no
//      label, an unwritten pin or a missing winner), e = exp(v - v_0) (0 for
//      a missing winner).
//   B. `prop_seq_chain`: one CTA per radargram walks t = 1..T-1 in order:
//      soft[b,t,n] = (sum_j e_j * soft[b,f_j,i_j]) / sum_j e_j, unfused and
//      in winner order, a __syncthreads() between frames. The radargram's
//      labels stay in shared memory where they fit (the survey's 120 KB)
//      and are written out once.
//
// Bound: the affinity products, 2*ns*N*N*C float32 operations per frame
// (2.06e11 over the Miguel survey, 3.1 ms at 67 TFLOP/s); phase A is that
// product plus the selection, phase B ~37 M multiply-adds in a chain of
// T-1 steps per radargram.
//
// Plain C interface, loaded with ctypes (ops/labelprop_cuda.py).

#include <algorithm>

#include "prop_tile.cuh"

namespace {

namespace tile = prop::tile;

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

template <bool kVec4>
__global__ void __launch_bounds__(tile::kThreads, tile::kMinBlocks)
prop_seq_select(const float* __restrict__ emb,     // (B, T, N, C)
                const float* __restrict__ mask,    // (N, N) [src, query]
                const int* __restrict__ long_mem,  // (L,) pinned frames
                int* __restrict__ src_out,         // (B, T-1, N, knn)
                float* __restrict__ e_out,         // (B, T-1, N, knn)
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
    slot_bias[s] = valid ? 0.f : prop::kNegInvalid;
  }
  __syncthreads();
  const float* emb_b = emb + static_cast<size_t>(b) * T * N * C;
  tile::run<kVec4>(SlotRows{emb_b, slot_frame, slot_bias, N, C},
                   emb_b + static_cast<size_t>(t) * N * C, mask, n0, N, C, temperature, knn, 0,
                   ns * N, sm);
  const int lane = threadIdx.x & 31;
  for (int ql = threadIdx.x >> 5; ql < tile::kQ && n0 + ql < N; ql += tile::kWarps) {
    const float* lv = sm.lv + ql * knn;
    const int* li = sm.li + ql * knn;
    const size_t out = ((static_cast<size_t>(b) * (T - 1) + (t - 1)) * N + n0 + ql) * knn;
    for (int j = lane; j < knn; j += 32) {
      const int r = li[j];
      int src = 0;
      float e = 0.f;
      if (r != INT_MAX) {
        const int s = r / N;
        src = (slot_frame[s] + 1) * N + (r - s * N);
        e = expf(lv[j] - lv[0]);
      }
      src_out[out + j] = src;
      e_out[out + j] = e;
    }
  }
}

__global__ void __launch_bounds__(kChainThreads)
prop_seq_chain(const int* __restrict__ src,    // (B, T-1, N, knn)
               const float* __restrict__ e,    // (B, T-1, N, knn)
               float* soft,                    // (B, T, N, M); frame 0 = seeds
               int T, int N, int M, int knn, int in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  int* ls = reinterpret_cast<int*>(smem);  // frame t's lists
  float* le = smem + N * knn;
  float* soft_b = soft + static_cast<size_t>(b) * T * N * M;
  float* lab = in_smem ? le + N * knn : soft_b;  // (T, N, M)
  if (in_smem) {
    for (int x = threadIdx.x; x < N * M; x += kChainThreads) lab[x] = soft_b[x];
  }
  for (int t = 1; t < T; ++t) {
    __syncthreads();  // frame t-1's labels are in place; the lists are free
    const size_t base = (static_cast<size_t>(b) * (T - 1) + (t - 1)) * N * knn;
    for (int x = threadIdx.x; x < N * knn; x += kChainThreads) {
      ls[x] = src[base + x];
      le[x] = e[base + x];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < N * M; x += kChainThreads) {
      const int n = x / M;
      const int m = x - n * M;
      float num = 0.f, den = 0.f;
      for (int j = 0; j < knn; ++j) {
        const int s = ls[n * knn + j];
        const float w = le[n * knn + j];
        num = prop::add_weighted(num, w, s >= N ? lab[(s - N) * M + m] : 0.f);
        den += w;
      }
      lab[(static_cast<size_t>(t) * N + n) * M + m] = num / den;
    }
  }
  if (in_smem) {
    __syncthreads();
    for (int x = N * M + threadIdx.x; x < T * N * M; x += kChainThreads) soft_b[x] = lab[x];
  }
}

decltype(&prop_seq_select<true>) select_for(int vec4) {
  return vec4 ? prop_seq_select<true> : prop_seq_select<false>;
}

size_t select_smem_bytes(int knn, int ns_max) {
  return tile::smem_bytes(knn) + 2 * sizeof(float) * static_cast<size_t>(ns_max);
}

size_t chain_smem_bytes(int T, int N, int M, int knn, bool in_smem) {
  return sizeof(float) * (2 * static_cast<size_t>(N) * knn +
                          (in_smem ? static_cast<size_t>(T) * N * M : 0));
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes a CTA of either phase may use.
int prop_seq_max_dynamic_smem(void) {
  const int a = tile::max_dynamic_smem(prop_seq_select<true>);
  const int b = tile::max_dynamic_smem(prop_seq_select<false>);
  const int c = tile::max_dynamic_smem(prop_seq_chain);
  if (a < 0 || b < 0 || c < 0) return -1;
  return std::min(a, std::min(b, c));
}

long long prop_seq_select_smem_bytes(int knn, int ns_max) {
  return static_cast<long long>(select_smem_bytes(knn, ns_max));
}

long long prop_seq_chain_smem_bytes(int T, int N, int M, int knn, int in_smem) {
  return static_cast<long long>(chain_smem_bytes(T, N, M, knn, in_smem != 0));
}

int prop_seq_max_classes(void) { return prop::kMaxClasses; }

const char* prop_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Phase A on `stream`: every frame's winner lists. Returns the cudaError_t
// of the launch (0 = success).
int prop_seq_select_launch(const float* emb, const float* mask, const int* long_mem,
                           int* src, float* e, int B, int T, int N, int C, int L, int cxt,
                           float temperature, int knn, int ns_max, int vec4, void* stream) {
  static size_t done[2] = {0, 0};
  const size_t dyn = select_smem_bytes(knn, ns_max);
  const int err = tile::reserve_smem(select_for(vec4), dyn, done[vec4 ? 1 : 0]);
  if (err != 0) return err;
  const dim3 grid((N + tile::kQ - 1) / tile::kQ, T - 1, B);
  select_for(vec4)<<<grid, tile::kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      emb, mask, long_mem, src, e, T, N, C, L, cxt, temperature, knn);
  return static_cast<int>(cudaGetLastError());
}

// Phase B on `stream`: the label chain of every radargram from phase A's
// lists; soft[:, 0] must hold the seeds. Returns the cudaError_t of the
// launch (0 = success).
int prop_seq_chain_launch(const int* src, const float* e, float* soft, int B, int T, int N,
                          int M, int knn, int in_smem, void* stream) {
  static size_t done = 0;
  const size_t dyn = chain_smem_bytes(T, N, M, knn, in_smem != 0);
  const int err = tile::reserve_smem(prop_seq_chain, dyn, done);
  if (err != 0) return err;
  prop_seq_chain<<<B, kChainThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      src, e, soft, T, N, M, knn, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
