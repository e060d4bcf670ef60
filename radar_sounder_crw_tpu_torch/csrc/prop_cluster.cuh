// The frame loop of the whole-sequence kernel prop_all.cu, its only user
// (prop_seq.cu split its chain into two phases on prop_tile.cuh): one
// thread-block cluster per radargram, frames in order.
//
// For radargram b and frame t = 1..T-1, over the valid slot prefix
// ns = L + min(t, cxt) (L = len(long_mem)):
//
//   slot s < L   (pin j = s):  frame long_mem[j] once it was pushed (t >
//                long_mem[j]), else empty; valid iff t - long_mem[j] > cxt;
//   slot L + r   (ring, r < min(t, cxt)): the last frame f < t with
//                f mod cxt == r; always valid;
//   aff[s*N+i] = ((emb[b,f,i] . emb[b,t,n] + mask[i,n]) + bias_s) / temperature,
//                bias_s = 0 or NEG_INVALID; an empty slot reads zeros.
//
// The ring stays implicit: a slot's features are a frame of `emb` and its
// labels a frame already written to `soft`, so nothing is copied between
// frames. Slots past the prefix have not been written and carry weight
// exactly 0 in the TPU kernels, so they are not read here.
//
// The N queries of a frame go in groups of kGroup, dealt round-robin to the
// cluster's CTAs; a cluster.sync() (release/acquire at cluster scope) ends
// every frame, so frame t's labels, written by all the CTAs, are in place
// before frame t+1 reads them. The cluster size is the largest power of two
// up to 8 that has groups to take and keeps B x size within the card's SMs
// (2 at the survey's B = 63, 4 for one radargram of N = 50, 8 at N = 190).
// Within a CTA all 16 warps compute the group's affinity columns together
// (`group_columns`: each candidate row is read once per group and serves 8
// queries; a warp's 4 rows x 8 queries partial sums meet in one 31-shuffle
// reduce-scatter); then each kernel runs its own selection, warps g and
// g + 8 for query g of the group. The columns, and what a selection keeps
// beside them, sit in dynamic shared memory where they fit, else in a
// global scratch the wrapper allocates.

#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "prop_common.cuh"

namespace prop {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                // queries per group
constexpr int kSplit = kWarps / kGroup;  // warps sharing one query's selection
constexpr int kRows = 4;                 // candidate rows a warp reads at once
constexpr int kClassesPerLane = kMaxClasses / 32;
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

// Frame t's slot table over the prefix s < ns: the frame each slot holds
// (-1: not written yet) and its bias. Read only after a __syncthreads().
__device__ __forceinline__ void slot_table(const int* __restrict__ long_mem, int L, int cxt,
                                           int t, int ns, int* slot_frame, float* slot_bias) {
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
    slot_bias[s] = valid ? 0.f : kNegInvalid;
  }
}

// Queries g0 .. g0 + kGroup - 1 of frame t into q (kGroup, c_pad), zeros
// past N and C.
__device__ __forceinline__ void load_queries(const float* __restrict__ emb_b, int t, int g0,
                                             int N, int C, int c_pad, float* q) {
  for (int x = threadIdx.x; x < kGroup * c_pad; x += kThreads) {
    const int g = x / c_pad;
    const int c = x - g * c_pad;
    const int n = g0 + g;
    q[x] = (n < N && c < C) ? emb_b[(static_cast<size_t>(t) * N + n) * C + c] : 0.f;
  }
}

// The affinity columns of the group at g0: col[g * col_len + r] for the
// ncand candidates r. Rows past the end re-read the last row and are not
// stored; an empty slot's row reads as zeros.
template <bool kVec4>
__device__ __forceinline__ void group_columns(const float* __restrict__ emb_b,
                                              const float* __restrict__ mask,
                                              const int* slot_frame, const float* slot_bias,
                                              const float* q, float* col, int col_len, int ncand,
                                              int g0, int N, int C, int c_pad, float temperature) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
}

// Host side. Dynamic shared memory of a launch: the group's queries, the
// slot table and `work` floats (the columns and what the selection keeps
// beside them; 0 when they go to global scratch).
inline size_t dynamic_smem_bytes(int C, int ns_max, size_t work) {
  const size_t c_pad = static_cast<size_t>((C + 3) & ~3);
  return (kGroup * c_pad + 2 * static_cast<size_t>(ns_max) + work) * sizeof(float);
}

inline cudaLaunchConfig_t launch_config(int B, int ncl, size_t dyn, void* stream,
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

// Dynamic shared memory bytes one CTA of `kernel` may use beside its static
// arrays; -1 on a CUDA error.
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

// CTAs per radargram: the largest power of two up to kMaxCluster that has
// query groups to take, keeps B * ncl within the card's SMs, and that the
// card can hold as one cluster at this shared-memory size. Returns <= 0 on
// a CUDA error.
template <class Kernel>
inline int cluster_size(Kernel kernel, int B, int N, size_t dyn) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
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

// One launch of B clusters of `ncl` CTAs on `stream`; returns the
// cudaError_t of the launch (0 = success).
template <class Kernel, class... Args>
inline int launch(Kernel kernel, int B, int ncl, size_t dyn, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = launch_config(B, ncl, dyn, stream, &attr);
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace prop
