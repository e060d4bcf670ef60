// Whole-sequence label propagation with the TPU resident kernel's weight
// arithmetic, by hand for sm_90a: one launch computes all B x (T-1) frames.
//
// Replaces the Pallas TPU kernel `_prop_all_kernel` in
// radar_sounder_crw_tpu/ops/labelprop_pallas.py (entry
// `propagate_all_pallas`, batched under `jax.vmap`). That kernel keeps one
// radargram's ring in scratch and, per frame, extracts the knn winners by
// passes over the whole untiled affinity that MARK each winner with -inf,
// then builds every winner's weight in one pass and takes the product of
// the label ring with the weights. Here, for radargram b and frame t, with
// the affinity column and the implicit ring of prop_cluster.cuh:
//
//   winners  v_0 >= v_1 >= ... (rows r_j), k = min(knn, ns*N) argmax passes
//            over the column, the lowest row first on ties; each pass writes
//            -INFINITY at its winner's row (the mark), so the next pass
//            cannot take it again. Inputs must be finite, so no real value
//            is -inf;
//   den      = sum_j e_j in winner order, e_j = expf(v_j - v_0);
//   w_j      = e_j / den (an IEEE division);
//   soft[b,t,n] = sum_j w_j * soft[b,f_j,i_j] over the winners in ASCENDING
//            row order (how the TPU kernel's labels . W reads them), the
//            product and the sum rounded separately (prop_common.cuh:
//            add_weighted).
//
// This is the contract of the plain twin `_prop_all_step_batched` in
// ops/labelprop.py; the two agree bit for bit where the dot products are
// exact. It differs from prop_seq's (sum_j e_j * label_j) / den by an ulp.
// Slots past the valid prefix carry NEG_INVALID in the TPU kernel, so a
// winner there has e_j = 0 exactly and adds +0: they are not read here.
//
// Design (simple first): the frame loop of prop_cluster.cuh, one
// thread-block cluster per radargram. Warps g and g + 8 run the marking
// passes for query g of the group, each over half of its column, meeting at
// a named barrier after every pass; the thread that scans the winner's row
// writes its mark, so its own next scan sees it and no other thread reads
// that row. Warp g keeps (row, e) of each winner in a short list beside the
// columns, then walks the list in ascending row order (knn warp-wide
// minimum searches over at most knn entries) for the label sum. Per query:
// a column of ns*N floats (5,050 at the survey's N = 50, in shared memory)
// plus 2*min(knn, ns*N) for the list; at MC3 width a column is 76.8 KB, so
// the 8 columns of a group go to a global scratch.
//
// Bound: as prop_seq's, the affinity products, 2*ns*N*N*C float32
// operations per frame; the kernel is far from it for the same reason (a
// latency-bound chain of row loads and reductions per CTA).
//
// Plain C interface, loaded with ctypes (ops/labelprop_cuda.py).

#include <algorithm>

#include "prop_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using prop::kClassesPerLane;
using prop::kFull;
using prop::kGroup;
using prop::kSplit;
using prop::kThreads;
using prop::lex_better;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
prop_all_kernel(const float* __restrict__ emb,     // (B, T, N, C)
                const float* __restrict__ mask,    // (N, N) [src, query]
                const int* __restrict__ long_mem,  // (L,) pinned frames
                float* soft,                       // (B, T, N, M); frame 0 = seeds
                float* gscratch,                   // (grid, work floats) or null
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
  const int kmax = min(knn, col_len);  // winners a query can have
  float* q = reinterpret_cast<float*>(smem4);  // (kGroup, c_pad), 16-byte aligned
  int* slot_frame = reinterpret_cast<int*>(q + kGroup * c_pad);  // (ns_max,)
  float* slot_bias = reinterpret_cast<float*>(slot_frame + ns_max);  // (ns_max,)
  const size_t work = static_cast<size_t>(kGroup) * (col_len + 2 * kmax);
  float* col = gscratch != nullptr ? gscratch + static_cast<size_t>(blockIdx.x) * work
                                   : slot_bias + ns_max;  // (kGroup, col_len)
  int* win_row = reinterpret_cast<int*>(col + static_cast<size_t>(kGroup) * col_len);
  float* win_e = reinterpret_cast<float*>(win_row + kGroup * kmax);  // (kGroup, kmax) each
  const float* emb_b = emb + static_cast<size_t>(b) * T * N * C;
  float* soft_b = soft + static_cast<size_t>(b) * T * N * M;

  for (int t = 1; t < T; ++t) {
    const int ns = L + min(t, cxt);
    const int ncand = ns * N;
    const int k_n = min(knn, ncand);
    prop::slot_table(long_mem, L, cxt, t, ns, slot_frame, slot_bias);

    for (int g0 = rank * kGroup; g0 < N; g0 += ncl * kGroup) {
      prop::load_queries(emb_b, t, g0, N, C, c_pad, q);
      __syncthreads();
      prop::group_columns<kVec4>(emb_b, mask, slot_frame, slot_bias, q, col, col_len, ncand, g0,
                                 N, C, c_pad, temperature);
      __syncthreads();

      const int g = warp % kGroup;
      const int part = warp / kGroup;
      const int n = g0 + g;
      if (n < N) {
        float* cw = col + static_cast<size_t>(g) * col_len;
        int* rows = win_row + g * kmax;
        float* es = win_e + g * kmax;
        // 1. k_n marking passes: the best unmarked row, lowest row on ties
        // (a marked -inf row loses to every finite value; k_n <= ncand
        // leaves one in the column at every pass)
        float v0 = 0.f, den = 0.f;
        for (int k = 0; k < k_n; ++k) {
          float bv = -INFINITY;
          int bi = INT_MAX;
          for (int r = part * 32 + lane; r < ncand; r += kSplit * 32) {
            const float a = cw[r];
            if (lex_better(a, r, bv, bi)) {
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
          if (bi % (kSplit * 32) == part * 32 + lane) cw[bi] = -INFINITY;  // the mark
          if (k == 0) v0 = bv;
          const float e = expf(bv - v0);
          den += e;  // in winner order
          if (part == 0 && lane == 0) {
            rows[k] = bi;
            es[k] = e;
          }
        }
        // 2. warp g: the winners' weighted labels in ascending row order
        // (lane: classes lane, lane + 32, ...)
        if (part == 0) {
          __syncwarp();
          float acc[kClassesPerLane];
#pragma unroll
          for (int j = 0; j < kClassesPerLane; ++j) acc[j] = 0.f;
          int last = -1;
          for (int k = 0; k < k_n; ++k) {
            int br = INT_MAX;
            float be = 0.f;
            for (int j = lane; j < k_n; j += 32) {
              const int r = rows[j];
              if (r > last && r < br) {
                br = r;
                be = es[j];
              }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              const int o_r = __shfl_xor_sync(kFull, br, off);
              const float o_e = __shfl_xor_sync(kFull, be, off);
              if (o_r < br) {
                br = o_r;
                be = o_e;
              }
            }
            last = br;
            const float w = be / den;
            const int s = br / N;
            const int f = slot_frame[s];
            const size_t src = (static_cast<size_t>(f) * N + (br - s * N)) * M;
#pragma unroll
            for (int j = 0; j < kClassesPerLane; ++j) {
              const int m = lane + 32 * j;
              if (m < M) acc[j] = prop::add_weighted(acc[j], w, f >= 0 ? soft_b[src + m] : 0.f);
            }
          }
#pragma unroll
          for (int j = 0; j < kClassesPerLane; ++j) {
            const int m = lane + 32 * j;
            if (m < M) soft_b[(static_cast<size_t>(t) * N + n) * M + m] = acc[j];
          }
        }
      }
      __syncthreads();  // q, the columns and the lists are rewritten next
    }
    // frame t's labels, written by every CTA of the cluster, are in place
    // (release/acquire at cluster scope) before any CTA reads them
    cluster.sync();
  }
}

// Floats of one CTA's work area: kGroup columns, then kGroup winner lists
// of min(knn, ns_max*N) rows and as many weights.
size_t work_floats(int N, int ns_max, int knn) {
  const size_t col_len = static_cast<size_t>(ns_max) * N;
  const size_t kmax = std::min(static_cast<size_t>(knn), col_len);
  return kGroup * (col_len + 2 * kmax);
}

size_t smem_bytes(int C, int N, int ns_max, int knn, bool global_work) {
  return prop::dynamic_smem_bytes(C, ns_max, global_work ? 0 : work_floats(N, ns_max, knn));
}

decltype(&prop_all_kernel<true>) kernel_for(int vec4) {
  return vec4 ? prop_all_kernel<true> : prop_all_kernel<false>;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one CTA may use; above it the wrapper puts
// the work area (columns and winner lists) in global scratch.
int prop_all_max_dynamic_smem(void) { return prop::max_dynamic_smem(prop_all_kernel<true>); }

// Dynamic shared memory a launch asks for (work area in shared memory or not).
long long prop_all_smem_bytes(int C, int N, int ns_max, int knn, int global_work) {
  return static_cast<long long>(smem_bytes(C, N, ns_max, knn, global_work != 0));
}

// Floats of global scratch per CTA when the work area does not fit.
long long prop_all_scratch_floats(int N, int ns_max, int knn) {
  return static_cast<long long>(work_floats(N, ns_max, knn));
}

int prop_all_max_classes(void) { return prop::kMaxClasses; }

const char* prop_all_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs per radargram (prop_cluster.cuh: cluster_size); <= 0 on a CUDA error.
int prop_all_cluster_size(int B, int N, int C, int ns_max, int knn, int global_work, int vec4) {
  return prop::cluster_size(kernel_for(vec4), B, N,
                            smem_bytes(C, N, ns_max, knn, global_work != 0));
}

// One launch over B radargrams, `ncl` CTAs each (prop_all_cluster_size), on
// `stream`; returns the cudaError_t of the launch (0 = success). soft[:, 0]
// must hold the seeds.
int prop_all_launch(const float* emb, const float* mask, const int* long_mem, float* soft,
                    float* gscratch, int B, int T, int N, int C, int M, int L, int cxt,
                    float temperature, int knn, int ns_max, int ncl, int vec4, void* stream) {
  return prop::launch(kernel_for(vec4), B, ncl,
                      smem_bytes(C, N, ns_max, knn, gscratch != nullptr), stream, emb, mask,
                      long_mem, soft, gscratch, T, N, C, M, L, cxt, temperature, knn, ns_max);
}

}  // extern "C"
