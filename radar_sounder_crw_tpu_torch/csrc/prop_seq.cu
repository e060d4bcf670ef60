// Whole-sequence label propagation for a batch of radargrams, by hand for
// sm_90a: one launch computes all B x (T-1) frames.
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
// The ring stays implicit: a slot's features are a frame of `emb` and its
// labels a frame already written to `soft`, so nothing is copied between
// frames. Slots past the prefix have not been written and carry weight
// exactly 0 in the TPU kernel, so they are not read here.
//
// Design (simple first): one thread-block cluster per radargram, frames in
// order. The N queries of a frame go in groups of 8, dealt round-robin to
// the cluster's CTAs; a cluster.sync() (release/acquire at cluster scope)
// ends every frame, so frame t's labels, written by all the CTAs, are in
// place before frame t+1 reads them. The cluster size is the largest power
// of two up to 8 that has groups to take and keeps B x size within the
// card's SMs (2 at the survey's B = 63, 4 for one radargram of N = 50, 8 at
// N = 190). Within a CTA all 16 warps compute the group's affinity columns
// together (each candidate row is read once per group and serves 8
// queries; a warp's 4 rows x 8 queries partial sums meet in one 31-shuffle
// reduce-scatter), then warps g and g + 8 run the knn selection passes for
// query g of the group, each over half of its column, meeting at a named
// barrier after every pass. The columns (8 x ns*N floats, 162 KB at the
// survey shape N = 50) sit in dynamic shared memory where they fit, else in
// a global scratch the wrapper allocates.
//
// Bound: the affinity products, 2*ns*N*N*C float32 operations per frame
// (2.06e11 over the Miguel survey, 3.1 ms at 67 TFLOP/s); the embeddings
// are read from DRAM about once (161 MB, 0.05 ms). The kernel is far from
// it: each CTA's frame is a chain of dependent steps (a candidate-row load
// from L2, the FMAs, the reduce-scatter) with 16 warps to hide the latency,
// and each row is read from L2 ceil(N/8) times per frame.
//
// Plain C interface, loaded with ctypes (ops/labelprop_cuda.py).

#include <cooperative_groups.h>

#include <cstdint>

#include "prop_common.cuh"

namespace cg = cooperative_groups;

namespace {

using prop::kFull;
using prop::lex_better;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                // queries per group
constexpr int kSplit = kWarps / kGroup;  // warps sharing one query's selection
constexpr int kRows = 4;                 // candidate rows a warp reads at once
constexpr int kClassesPerLane = prop::kMaxClasses / 32;
constexpr int kMaxCluster = 8;  // the portable thread-block cluster size
static_assert(kRows * kGroup == 32, "one partial sum per lane after the reduce-scatter");

// One butterfly stage: lanes with bit W set keep the upper half of a[0, 2W)
// and receive their partner's upper half; the others keep the lower half.
template <int W>
__device__ __forceinline__ void fold(float (&a)[32], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? a[i] : a[i + W];
    const float keep = upper ? a[i + W] : a[i];
    a[i] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// a[32] per lane -> lane l returns the sum over the warp of a[l].
__device__ __forceinline__ float reduce_scatter32(float (&a)[32], int lane) {
  fold<16>(a, lane);
  fold<8>(a, lane);
  fold<4>(a, lane);
  fold<2>(a, lane);
  fold<1>(a, lane);
  return a[0];
}

// The kSplit warps selecting for group query g meet here (named barrier 1 + g).
__device__ __forceinline__ void split_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(kSplit * 32) : "memory");
}

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
    // the frame each slot holds at step t (-1: not written yet) and its bias;
    // read only after the __syncthreads() below
    for (int s = threadIdx.x; s < ns; s += kThreads) {
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

    for (int g0 = rank * kGroup; g0 < N; g0 += ncl * kGroup) {
      for (int x = threadIdx.x; x < kGroup * c_pad; x += kThreads) {
        const int g = x / c_pad;
        const int c = x - g * c_pad;
        const int n = g0 + g;
        q[x] = (n < N && c < C) ? emb_b[(static_cast<size_t>(t) * N + n) * C + c] : 0.f;
      }
      __syncthreads();

      // 1. the group's affinity columns. Rows past the end re-read the last
      // row and are not stored; an empty slot's row reads as zeros.
      for (int r0 = warp * kRows; r0 < ncand; r0 += kWarps * kRows) {
        float acc[32];
#pragma unroll
        for (int v = 0; v < 32; ++v) acc[v] = 0.f;
        const float* rows[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int r = min(r0 + u, ncand - 1);
          const int s = r / N;
          const int f = slot_frame[s];
          rows[u] = f >= 0 ? emb_b + (static_cast<size_t>(f) * N + (r - s * N)) * C : nullptr;
        }
        if (kVec4) {
          for (int c4 = lane; c4 < (C >> 2); c4 += 32) {
            float4 a[kRows];
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
              a[u] = rows[u] != nullptr ? __ldg(reinterpret_cast<const float4*>(rows[u]) + c4)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const float4 b4 = reinterpret_cast<const float4*>(q + g * c_pad)[c4];
#pragma unroll
              for (int u = 0; u < kRows; ++u) {
                float& s = acc[u * kGroup + g];
                s = fmaf(a[u].x, b4.x, s);
                s = fmaf(a[u].y, b4.y, s);
                s = fmaf(a[u].z, b4.z, s);
                s = fmaf(a[u].w, b4.w, s);
              }
            }
          }
        } else {
          for (int c = lane; c < C; c += 32) {
            float a[kRows];
#pragma unroll
            for (int u = 0; u < kRows; ++u) a[u] = rows[u] != nullptr ? __ldg(rows[u] + c) : 0.f;
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const float bq = q[g * c_pad + c];
#pragma unroll
              for (int u = 0; u < kRows; ++u) acc[u * kGroup + g] = fmaf(a[u], bq, acc[u * kGroup + g]);
            }
          }
        }
        const float dot = reduce_scatter32(acc, lane);
        const int r = r0 + lane / kGroup;
        const int g = lane % kGroup;
        const int n = g0 + g;
        if (r < ncand && n < N) {
          const int s = r / N;
          const int i = r - s * N;
          col[static_cast<size_t>(g) * col_len + r] =
              ((dot + mask[static_cast<size_t>(i) * N + n]) + slot_bias[s]) / temperature;
        }
      }
      __syncthreads();

      // 2. warps g, g + 8, ... select the knn winners of query g0 + g, each
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
          split_sync(g);
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

size_t dynamic_smem_bytes(int C, int N, int ns_max, bool global_columns) {
  const size_t c_pad = static_cast<size_t>((C + 3) & ~3);
  size_t bytes = (kGroup * c_pad + 2 * static_cast<size_t>(ns_max)) * sizeof(float);
  if (!global_columns) bytes += static_cast<size_t>(kGroup) * ns_max * N * sizeof(float);
  return bytes;
}

cudaLaunchConfig_t launch_config(int B, int ncl, size_t dyn, void* stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B * ncl));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = dyn;
  config.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(ncl);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

decltype(&prop_seq_kernel<true>) kernel_for(int vec4) {
  return vec4 ? prop_seq_kernel<true> : prop_seq_kernel<false>;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one CTA may use; above it the wrapper puts
// the affinity columns in global scratch.
int prop_seq_max_dynamic_smem(void) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, prop_seq_kernel<true>) != cudaSuccess) return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

// Dynamic shared memory a launch asks for (columns in shared memory or not).
long long prop_seq_smem_bytes(int C, int N, int ns_max, int global_columns) {
  return static_cast<long long>(dynamic_smem_bytes(C, N, ns_max, global_columns != 0));
}

int prop_seq_group(void) { return kGroup; }

int prop_seq_max_classes(void) { return prop::kMaxClasses; }

const char* prop_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs per radargram: the largest power of two up to kMaxCluster that has
// query groups to take, keeps B * ncl within the card's SMs, and that the
// card can hold as one cluster at this shared-memory size. Returns <= 0 on
// a CUDA error.
int prop_seq_cluster_size(int B, int N, int C, int ns_max, int global_columns, int vec4) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const size_t dyn = dynamic_smem_bytes(C, N, ns_max, global_columns != 0);
  auto kernel = kernel_for(vec4);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dyn)) != cudaSuccess)
    return -1;
  const int groups = (N + kGroup - 1) / kGroup;
  int ncl = 1;
  while (2 * ncl <= kMaxCluster && 2 * ncl <= groups && B * 2 * ncl <= sms) ncl *= 2;
  for (; ncl > 1; ncl /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t config = launch_config(B, ncl, dyn, nullptr, &attr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) == cudaSuccess &&
        clusters > 0)
      break;
    cudaGetLastError();  // a refused size is not an error of the launch
  }
  return ncl;
}

// One launch over B radargrams, `ncl` CTAs each (prop_seq_cluster_size), on
// `stream`; returns the cudaError_t of the launch (0 = success). soft[:, 0]
// must hold the seeds.
int prop_seq_launch(const float* emb, const float* mask, const int* long_mem, float* soft,
                    float* gscratch, int B, int T, int N, int C, int M, int L, int cxt,
                    float temperature, int knn, int ns_max, int ncl, int vec4, void* stream) {
  const size_t dyn = dynamic_smem_bytes(C, N, ns_max, gscratch != nullptr);
  auto kernel = kernel_for(vec4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = launch_config(B, ncl, dyn, stream, &attr);
  err = cudaLaunchKernelEx(&config, kernel, emb, mask, long_mem, soft, gscratch, T, N, C, M,
                           L, cxt, temperature, knn, ns_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
