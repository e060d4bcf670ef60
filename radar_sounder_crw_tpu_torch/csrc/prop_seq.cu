// Whole-sequence label propagation for a batch of radargrams, by hand for
// sm_90a: one launch computes all B x (T-1) frames.
//
// Replaces the Pallas TPU kernel `_prop_seq_v2_kernel` in
// radar_sounder_crw_tpu/ops/labelprop_pallas.py (entries
// `propagate_all_pallas_v2` and `propagate_all_pallas_v2_batched`). It
// computes what that kernel computes, without its TPU layout (lane packing,
// padded rows and lanes, slot chunks). For radargram b and frame t, over the
// valid slot prefix and with the affinity column of prop_cluster.cuh:
//
//   soft[b,t,n] = the knn winners' softmax-weighted labels soft[b,f,i]
//                (prop_common.cuh), frame 0 being the seed.
//
// Design (simple first): the frame loop of prop_cluster.cuh, one
// thread-block cluster per radargram. Warps g and g + 8 run the knn
// read-only selection passes for query g of the group, each over half of
// its column, meeting at a named barrier after every pass, and sum each
// winner's weighted label as it is found.
//
// Bound: the affinity products, 2*ns*N*N*C float32 operations per frame
// (2.06e11 over the Miguel survey, 3.1 ms at 67 TFLOP/s); the embeddings
// are read from DRAM about once (161 MB, 0.05 ms). The kernel is far from
// it: each CTA's frame is a chain of dependent steps (a candidate-row load
// from L2, the FMAs, the reduce-scatter) with 16 warps to hide the latency,
// and each row is read from L2 ceil(N/8) times per frame.
//
// Plain C interface, loaded with ctypes (ops/labelprop_cuda.py).

#include "prop_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using prop::kClassesPerLane;
using prop::kGroup;
using prop::kSplit;
using prop::kThreads;
using prop::lex_better;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
prop_seq_kernel(const float* __restrict__ emb,     // (B, T, N, C)
                const float* __restrict__ mask,    // (N, N) [src, query]
                const int* __restrict__ long_mem,  // (L,) pinned frames
                float* soft,                       // (B, T, N, M); frame 0 = seeds
                float* gscratch,                   // (grid, kGroup, col_len) or null
                int T, int N, int C, int M, int L, int cxt, float temperature,
                int knn, int ns_max) {
  extern __shared__ float4 smem4[];
  __shared__ float split_v[2][kSplit][kGroup];  // per-pass bests, by pass parity
  __shared__ int split_i[2][kSplit][kGroup];
  // one cluster per radargram; CTA `rank` takes query groups rank, rank +
  // ncl, ... of every frame
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / ncl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c_pad = (C + 3) & ~3;
  const int col_len = ns_max * N;
  float* q = reinterpret_cast<float*>(smem4);  // (kGroup, c_pad), 16-byte aligned
  int* slot_frame = reinterpret_cast<int*>(q + kGroup * c_pad);  // (ns_max,)
  float* slot_bias = reinterpret_cast<float*>(slot_frame + ns_max);  // (ns_max,)
  float* col = gscratch != nullptr
                   ? gscratch + static_cast<size_t>(blockIdx.x) * kGroup * col_len
                   : slot_bias + ns_max;  // (kGroup, col_len)
  const float* emb_b = emb + static_cast<size_t>(b) * T * N * C;
  float* soft_b = soft + static_cast<size_t>(b) * T * N * M;

  for (int t = 1; t < T; ++t) {
    const int ns = L + min(t, cxt);
    const int ncand = ns * N;
    prop::slot_table(long_mem, L, cxt, t, ns, slot_frame, slot_bias);

    for (int g0 = rank * kGroup; g0 < N; g0 += ncl * kGroup) {
      prop::load_queries(emb_b, t, g0, N, C, c_pad, q);
      __syncthreads();
      prop::group_columns<kVec4>(emb_b, mask, slot_frame, slot_bias, q, col, col_len, ncand, g0,
                                 N, C, c_pad, temperature);
      __syncthreads();

      // warps g, g + 8, ... select the knn winners of query g0 + g, each
      // over its share of the column, lowest candidate first on ties, and
      // sum their weighted labels (lane: classes lane, lane + 32, ...)
      const int g = warp % kGroup;
      const int part = warp / kGroup;
      const int n = g0 + g;
      if (n < N) {
        const float* cw = col + static_cast<size_t>(g) * col_len;
        float v_last = INFINITY;
        int i_last = -1;
        float v1 = 0.f, den = 0.f;
        float num[kClassesPerLane];
#pragma unroll
        for (int j = 0; j < kClassesPerLane; ++j) num[j] = 0.f;
        for (int k = 0; k < knn; ++k) {
          float bv = -INFINITY;
          int bi = INT_MAX;
          for (int r = part * 32 + lane; r < ncand; r += kSplit * 32) {
            const float a = cw[r];
            if (prop::after(a, r, v_last, i_last) && lex_better(a, r, bv, bi)) {
              bv = a;
              bi = r;
            }
          }
          prop::warp_best(bv, bi);
          if (lane == 0) {
            split_v[k & 1][part][g] = bv;
            split_i[k & 1][part][g] = bi;
          }
          prop::split_sync(g);
#pragma unroll
          for (int h = 0; h < kSplit; ++h) {
            if (lex_better(split_v[k & 1][h][g], split_i[k & 1][h][g], bv, bi)) {
              bv = split_v[k & 1][h][g];
              bi = split_i[k & 1][h][g];
            }
          }
          if (bi == INT_MAX) break;  // knn exceeds the candidate count (uniform)
          if (k == 0) v1 = bv;
          const float e = expf(bv - v1);
          den += e;
          const int s = bi / N;
          const int f = slot_frame[s];
          const size_t src = (static_cast<size_t>(f) * N + (bi - s * N)) * M;
#pragma unroll
          for (int j = 0; j < kClassesPerLane; ++j) {
            const int m = lane + 32 * j;
            if (m < M) num[j] = prop::add_weighted(num[j], e, f >= 0 ? soft_b[src + m] : 0.f);
          }
          v_last = bv;
          i_last = bi;
        }
#pragma unroll
        for (int j = 0; j < kClassesPerLane; ++j) {
          const int m = lane + 32 * j;
          if (part == 0 && m < M) soft_b[(static_cast<size_t>(t) * N + n) * M + m] = num[j] / den;
        }
      }
      __syncthreads();  // q and the columns are rewritten next
    }
    // frame t's labels, written by every CTA of the cluster, are in place
    // (release/acquire at cluster scope) before any CTA reads them
    cluster.sync();
  }
}

// Floats of one CTA's columns (the work area).
size_t work_floats(int N, int ns_max) {
  return static_cast<size_t>(kGroup) * ns_max * N;
}

size_t smem_bytes(int C, int N, int ns_max, bool global_work) {
  return prop::dynamic_smem_bytes(C, ns_max, global_work ? 0 : work_floats(N, ns_max));
}

decltype(&prop_seq_kernel<true>) kernel_for(int vec4) {
  return vec4 ? prop_seq_kernel<true> : prop_seq_kernel<false>;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one CTA may use; above it the wrapper puts
// the affinity columns in global scratch.
int prop_seq_max_dynamic_smem(void) { return prop::max_dynamic_smem(prop_seq_kernel<true>); }

// Dynamic shared memory a launch asks for (columns in shared memory or
// not). knn is not used: the interface is prop_all's.
long long prop_seq_smem_bytes(int C, int N, int ns_max, int knn, int global_work) {
  (void)knn;
  return static_cast<long long>(smem_bytes(C, N, ns_max, global_work != 0));
}

// Floats of global scratch per CTA when the columns do not fit.
long long prop_seq_scratch_floats(int N, int ns_max, int knn) {
  (void)knn;
  return static_cast<long long>(work_floats(N, ns_max));
}

int prop_seq_max_classes(void) { return prop::kMaxClasses; }

const char* prop_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs per radargram (prop_cluster.cuh: cluster_size); <= 0 on a CUDA error.
int prop_seq_cluster_size(int B, int N, int C, int ns_max, int knn, int global_work, int vec4) {
  (void)knn;
  return prop::cluster_size(kernel_for(vec4), B, N, smem_bytes(C, N, ns_max, global_work != 0));
}

// One launch over B radargrams, `ncl` CTAs each (prop_seq_cluster_size), on
// `stream`; returns the cudaError_t of the launch (0 = success). soft[:, 0]
// must hold the seeds.
int prop_seq_launch(const float* emb, const float* mask, const int* long_mem, float* soft,
                    float* gscratch, int B, int T, int N, int C, int M, int L, int cxt,
                    float temperature, int knn, int ns_max, int ncl, int vec4, void* stream) {
  return prop::launch(kernel_for(vec4), B, ncl, smem_bytes(C, N, ns_max, gscratch != nullptr),
                      stream, emb, mask, long_mem, soft, gscratch, T, N, C, M, L, cxt,
                      temperature, knn, ns_max);
}

}  // extern "C"
