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
//   winners = the knn largest aff, lowest r first on ties;
//   pred[n] = sum_j e_j * labels[winner_j] / sum_j e_j, e_j = exp(v_j - v_0),
//             accumulated in winner order (prop_common.cuh).
//
// Design: two steps, the block top-k and merge of the TPU kernel's tiled
// grid (`phase`, `blk`).
//   1. `prop_step_tiles`: a 2-D grid of (64-query tile x candidate chunk)
//      CTAs. Each runs the tile core of prop_tile.cuh over its chunk (a
//      register-tiled float32 product with a running top-knn per query)
//      and writes each query's knn best (value, index) of the chunk, in
//      winner order, to a scratch the wrapper allocates. The chunk is sized
//      so that the grid fills the card once at every prefix.
//   2. `prop_step_merge`: one CTA of 4 warps per query merges its chunk
//      lists (one contiguous run per query) into the global top-knn with
//      the same `offer` as step 1, each warp a quarter of them, then one
//      warp the four partial lists, and forms the weighted label sum winner
//      by winner.
//
// Bound: the affinity product, 2*nslots*N*N*C float32 operations per frame
// (0.93 GFLOP for a saturated MC3 ring, 0.014 ms at 67 TFLOP/s); the ring
// (9.8 MB) is read from DRAM once and from L2 once per query tile.
//
// Plain C interface, loaded with ctypes (radar_sounder_crw_tpu_torch/ops/
// labelprop_cuda.py).

#include <algorithm>

#include "prop_tile.cuh"

namespace {

namespace tile = prop::tile;

constexpr int kMergeWarps = 4;  // warps sharing one query's merge
constexpr int kBlock = 4;  // chunk-list entries per lane per merge step
constexpr int kClassesPerLane = prop::kMaxClasses / 32;

// The explicit ring: candidate r is row r of feats (nslots*N, C).
struct RingRows {
  const float* feats;
  const float* slot_bias;
  int C;
  __device__ const float* row(int r) const { return feats + static_cast<size_t>(r) * C; }
  __device__ const float* base() const { return feats; }
  __device__ float bias(int s) const { return slot_bias[s]; }
};

template <bool kVec4>
__global__ void __launch_bounds__(tile::kThreads, tile::kMinBlocks)
prop_step_tiles(const float* __restrict__ feats,      // (nslots*N, C)
                const float* __restrict__ query,      // (N, C)
                const float* __restrict__ mask,       // (N, N) [src, query]
                const float* __restrict__ slot_bias,  // (K,)
                float* __restrict__ list_v,           // (N, nch, knn)
                int* __restrict__ list_i,             // (N, nch, knn)
                int N, int C, float temperature, int knn, int ncand, int chunk_rows) {
  extern __shared__ float4 smem4[];
  const tile::Smem sm = tile::carve(reinterpret_cast<float*>(smem4), knn);
  const int n0 = blockIdx.x * tile::kQ;
  const int chunk = blockIdx.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(ncand, r_begin + chunk_rows);
  tile::run<kVec4>(RingRows{feats, slot_bias, C}, query, mask, n0, N, C, temperature, knn,
                   r_begin, r_end, sm);
  const int lane = threadIdx.x & 31;
  for (int ql = threadIdx.x >> 5; ql < tile::kQ && n0 + ql < N; ql += tile::kWarps) {
    const size_t out = (static_cast<size_t>(n0 + ql) * gridDim.y + chunk) * knn;
    for (int j = lane; j < knn; j += 32) {
      list_v[out + j] = sm.lv[ql * knn + j];
      list_i[out + j] = sm.li[ql * knn + j];
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
prop_step_merge(const float* __restrict__ list_v,  // (N, nch, knn)
                const int* __restrict__ list_i,
                const float* __restrict__ labels,  // (nslots*N, M)
                float* __restrict__ pred,          // (N, M)
                int N, int M, int knn, int nch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x;
  const int wlen = tile::buf_len(knn);
  float* lv_all = smem;                                            // (kMergeWarps, knn)
  int* li_all = reinterpret_cast<int*>(smem + kMergeWarps * knn);  // (kMergeWarps, knn)
  float* lv = lv_all + warp * knn;
  int* li = li_all + warp * knn;
  float* wv = smem + 2 * kMergeWarps * knn + warp * wlen;
  int* wi = reinterpret_cast<int*>(smem + 2 * kMergeWarps * knn + kMergeWarps * wlen) + warp * wlen;
  for (int j = lane; j < knn; j += 32) {
    lv[j] = -INFINITY;
    li[j] = INT_MAX;
  }
  __syncwarp();
  // the query's chunk lists are one run of nch*knn entries; warp w merges
  // the blocks of 128 entries w, w + kMergeWarps, ... into its own list, the
  // next block's loads in flight while one is merged
  const int total = nch * knn;
  const float* qv = list_v + static_cast<size_t>(n) * total;
  const int* qi = list_i + static_cast<size_t>(n) * total;
  auto load = [&](const float* src_v, const int* src_i, int count, int j0, float (&bv)[kBlock],
                  int (&bi)[kBlock]) {
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      const int j = j0 + 32 * u + lane;
      bv[u] = j < count ? src_v[j] : -INFINITY;
      bi[u] = j < count ? src_i[j] : INT_MAX;
    }
  };
  float v[kBlock], nv[kBlock];
  int r[kBlock], nr[kBlock];
  bool ok[kBlock];
  constexpr int kStride = kMergeWarps * 32 * kBlock;
  load(qv, qi, total, warp * 32 * kBlock, v, r);
  for (int j0 = warp * 32 * kBlock; j0 < total; j0 += kStride) {
    load(qv, qi, total, j0 + kStride, nv, nr);
#pragma unroll
    for (int u = 0; u < kBlock; ++u) ok[u] = r[u] != INT_MAX;
    tile::offer(v, r, ok, lv, li, wv, wi, knn);
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      v[u] = nv[u];
      r[u] = nr[u];
    }
  }
  __syncthreads();
  if (warp != 0) return;  // no block-wide barrier below
  // warp 0 takes in the other warps' lists, which follow its own
  const int rest = (kMergeWarps - 1) * knn;
  for (int j0 = 0; j0 < rest; j0 += 32 * kBlock) {
    load(lv_all + knn, li_all + knn, rest, j0, v, r);
#pragma unroll
    for (int u = 0; u < kBlock; ++u) ok[u] = r[u] != INT_MAX;
    tile::offer(v, r, ok, lv, li, wv, wi, knn);
  }

  // the softmax-weighted label sum, winner by winner
  const float v0 = lv[0];
  float den = 0.f;
  float num[kClassesPerLane];
#pragma unroll
  for (int jj = 0; jj < kClassesPerLane; ++jj) num[jj] = 0.f;
  for (int k = 0; k < knn; ++k) {
    const int r = li[k];
    if (r == INT_MAX) break;  // knn exceeds the candidate count
    const float e = expf(lv[k] - v0);
    den += e;
#pragma unroll
    for (int jj = 0; jj < kClassesPerLane; ++jj) {
      const int m = lane + 32 * jj;
      if (m < M) num[jj] = prop::add_weighted(num[jj], e, labels[static_cast<size_t>(r) * M + m]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < kClassesPerLane; ++jj) {
    const int m = lane + 32 * jj;
    if (m < M) pred[static_cast<size_t>(n) * M + m] = num[jj] / den;
  }
}

decltype(&prop_step_tiles<true>) tiles_for(int vec4) {
  return vec4 ? prop_step_tiles<true> : prop_step_tiles<false>;
}

size_t merge_smem_bytes(int knn) {
  return 2 * sizeof(float) * kMergeWarps * (knn + tile::buf_len(knn));
}

// The largest dynamic shared memory set so far for each kernel
// (tile::reserve_smem): step 1 by vec4, step 2.
size_t reserved_tiles[2] = {0, 0};
size_t reserved_merge = 0;

}  // namespace

extern "C" {

// Dynamic shared memory bytes a CTA of either step may use.
int prop_step_max_dynamic_smem(void) {
  const int a = tile::max_dynamic_smem(prop_step_tiles<true>);
  const int b = tile::max_dynamic_smem(prop_step_tiles<false>);
  const int c = tile::max_dynamic_smem(prop_step_merge);
  if (a < 0 || b < 0 || c < 0) return -1;
  return std::min(a, std::min(b, c));
}

// Dynamic shared memory of the larger step at knn.
long long prop_step_smem_bytes(int knn) {
  const size_t a = tile::smem_bytes(knn);
  const size_t b = merge_smem_bytes(knn);
  return static_cast<long long>(a > b ? a : b);
}

// CTAs of step 1 the card holds at once (SMs x CTAs per SM); <= 0 on a
// CUDA error.
int prop_step_wave(int knn) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const size_t dyn = tile::smem_bytes(knn);
  if (tile::reserve_smem(prop_step_tiles<true>, dyn, reserved_tiles[1]) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prop_step_tiles<true>,
                                                    tile::kThreads, dyn) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

int prop_step_max_classes(void) { return prop::kMaxClasses; }

const char* prop_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Step 1 over chunks of `chunk_rows` candidates into (list_v, list_i), then,
// when `merge` is set, step 2 into pred; on `stream`. Returns the
// cudaError_t of the launches (0 = success).
int prop_step_launch(const float* feats, const float* query, const float* mask,
                     const float* slot_bias, const float* labels, float* pred, float* list_v,
                     int* list_i, int N, int C, int M, float temperature, int knn, int nslots,
                     int chunk_rows, int vec4, int merge, void* stream) {
  const int ncand = nslots * N;
  const int nch = (ncand + chunk_rows - 1) / chunk_rows;
  const size_t dyn = tile::smem_bytes(knn);
  int err = tile::reserve_smem(tiles_for(vec4), dyn, reserved_tiles[vec4 ? 1 : 0]);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + tile::kQ - 1) / tile::kQ, nch);
  tiles_for(vec4)<<<grid, tile::kThreads, dyn, s>>>(feats, query, mask, slot_bias, list_v,
                                                     list_i, N, C, temperature, knn, ncand,
                                                     chunk_rows);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !merge) return err;
  const size_t mdyn = merge_smem_bytes(knn);
  err = tile::reserve_smem(prop_step_merge, mdyn, reserved_merge);
  if (err != 0) return err;
  prop_step_merge<<<N, kMergeWarps * 32, mdyn, s>>>(
      list_v, list_i, labels, pred, N, M, knn, nch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
