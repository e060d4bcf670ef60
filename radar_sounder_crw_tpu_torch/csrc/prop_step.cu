// One label-propagation frame for all N query nodes, by hand for sm_90a.
//
// Replaces the Pallas TPU kernel `_prop_step_kernel` (body
// `_single_block_pipeline`) in radar_sounder_crw_tpu/ops/labelprop_pallas.py.
// It computes what that kernel computes, without its TPU layout (8-row
// sublanes, 128-lane queries, padded slots):
//
//   aff[r]  = ((feats[r] . query[n] + mask[i, n]) + slot_bias[s]) / temperature
//             for every candidate r = s*N + i of the valid slot prefix
//             s < nslots (plain float32 FMAs, no TF32; a true division, not a
//             multiply by the reciprocal, so ties stay where they are);
//   winners = the knn largest aff, lowest r first on ties, by read-only
//             passes under the lexicographic threshold
//             (a < v_last) | (a == v_last & r > i_last);
//   pred[n] = sum_j e_j * labels[winner_j] / sum_j e_j, e_j = exp(v_j - v_0),
//             accumulated in winner order (prop_common.cuh).
//
// Design (simple first): one CTA per query node. The CTA keeps its affinity
// column (nslots*N floats, ~77 KB at MC3) in dynamic shared memory, or in a
// global scratch column the wrapper allocates when the column does not fit.
// Each warp computes kRows candidates' dot products per step (coalesced
// 512-byte row reads, kRows of them in flight), then knn block-wide argmax
// passes run over shared memory.
//
// Bound: the affinity product, 2*nslots*N*N*C float32 operations per frame
// (0.93 GFLOP for a saturated MC3 ring), i.e. operations on the float32 FMA
// units; the ring itself (nslots*N*C*4 bytes, 9.8 MB at MC3) is read once
// from DRAM and then from L2 by all N CTAs. Every CTA re-reads the whole
// ring (1.9 GB of L2 reads per saturated MC3 launch), so this kernel runs
// far from the FMA bound; tiling several queries per CTA, so that one ring
// read serves many queries, is the next step.
//
// Plain C interface, loaded with ctypes (radar_sounder_crw_tpu_torch/ops/
// labelprop_cuda.py).

#include <cstdint>

#include "prop_common.cuh"

namespace {

using prop::kFull;
using prop::lex_better;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // candidate rows a warp reads at once

__global__ void __launch_bounds__(kThreads)
prop_step_kernel(const float* __restrict__ feats,      // (nslots*N, C)
                 const float* __restrict__ query,      // (N, C)
                 const float* __restrict__ mask,       // (N, N) [src, query]
                 const float* __restrict__ slot_bias,  // (K,)
                 const float* __restrict__ labels,     // (nslots*N, M)
                 float* __restrict__ pred,             // (N, M)
                 float* __restrict__ gscratch,         // (N, nslots*N) or null
                 int N, int C, int M, float temperature, int knn, int nslots) {
  extern __shared__ float4 smem4[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ncand = nslots * N;
  float* q = reinterpret_cast<float*>(smem4);  // C floats, 16-byte aligned
  const int c_pad = (C + 3) & ~3;
  float* col = gscratch != nullptr ? gscratch + static_cast<size_t>(n) * ncand
                                   : q + c_pad;

  for (int c = threadIdx.x; c < C; c += kThreads) q[c] = query[static_cast<size_t>(n) * C + c];
  __syncthreads();

  // 1. the affinity column: each warp takes kRows consecutive candidate rows
  // at a time, so kRows independent row loads are in flight per lane instead
  // of one (a row per warp step leaves the warps waiting on L2 latency).
  // Rows past the end re-read the last row and are not stored.
  const bool vec4 = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  for (int r0 = warp * kRows; r0 < ncand; r0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = 0.f;
    if (vec4) {
      const float4* q4 = reinterpret_cast<const float4*>(q);
      for (int c = lane; c < (C >> 2); c += 32) {
        const float4 b = q4[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int r = min(r0 + u, ncand - 1);
          const float4 a =
              __ldg(reinterpret_cast<const float4*>(feats + static_cast<size_t>(r) * C) + c);
          acc[u] = fmaf(a.x, b.x, acc[u]);
          acc[u] = fmaf(a.y, b.y, acc[u]);
          acc[u] = fmaf(a.z, b.z, acc[u]);
          acc[u] = fmaf(a.w, b.w, acc[u]);
        }
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        const float b = q[c];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int r = min(r0 + u, ncand - 1);
          acc[u] = fmaf(__ldg(feats + static_cast<size_t>(r) * C + c), b, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      for (int off = 16; off > 0; off >>= 1) acc[u] += __shfl_xor_sync(kFull, acc[u], off);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u;
      if (lane == u && r < ncand) {
        const int s = r / N;
        const int i = r - s * N;
        col[r] = ((acc[u] + mask[static_cast<size_t>(i) * N + n]) + slot_bias[s]) / temperature;
      }
    }
  }
  __syncthreads();

  // 2. knn read-only extraction passes, the lowest row winning ties; each
  // winner's weighted label goes straight into the sum (thread m: class m)
  float v_last = INFINITY;
  int i_last = -1;
  float v1 = 0.f, num = 0.f, den = 0.f;
  for (int k = 0; k < knn; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int r = threadIdx.x; r < ncand; r += kThreads) {
      const float a = col[r];
      if (prop::after(a, r, v_last, i_last) && lex_better(a, r, bv, bi)) {
        bv = a;
        bi = r;
      }
    }
    prop::warp_best(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
    for (int w = 1; w < kWarps; ++w) {
      if (lex_better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
    __syncthreads();  // red_* is rewritten by the next pass
    if (bi == INT_MAX) break;  // knn exceeds the candidate count (uniform)
    if (k == 0) v1 = bv;
    const float e = expf(bv - v1);
    den += e;
    if (threadIdx.x < M) {
      num = prop::add_weighted(num, e, labels[static_cast<size_t>(bi) * M + threadIdx.x]);
    }
    v_last = bv;
    i_last = bi;
  }

  // 3. the softmax-weighted label sum
  if (threadIdx.x < M) pred[static_cast<size_t>(n) * M + threadIdx.x] = num / den;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one CTA may use beside the kernel's static
// arrays; the wrapper puts the affinity column in global scratch above it.
int prop_step_max_dynamic_smem(void) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, prop_step_kernel) != cudaSuccess) return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

int prop_step_max_classes(void) { return prop::kMaxClasses; }

const char* prop_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int prop_step_launch(const float* feats, const float* query, const float* mask,
                     const float* slot_bias, const float* labels, float* pred,
                     float* gscratch, int N, int C, int M, float temperature,
                     int knn, int nslots, void* stream) {
  const int c_pad = (C + 3) & ~3;
  size_t dyn = static_cast<size_t>(c_pad) * sizeof(float);
  if (gscratch == nullptr) dyn += static_cast<size_t>(nslots) * N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      prop_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  prop_step_kernel<<<N, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      feats, query, mask, slot_bias, labels, pred, gscratch, N, C, M, temperature, knn,
      nslots);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
