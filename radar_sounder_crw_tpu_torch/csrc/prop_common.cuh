// Pieces shared by the propagation kernels (prop_step.cu, prop_seq.cu,
// prop_all.cu and their headers prop_tile.cuh, prop_frames.cuh).
//
// Winner order: candidates compare by (value descending, index ascending),
// the order of `lax.top_k` and of a stable descending sort. Every kernel
// keeps a running list of the knn best per query (prop_tile.cuh).
//
// Softmax-weighted label sum, in winner order j = 0, 1, ...:
//   e_j = exp(v_j - v_0);  num += e_j * label_j;  den += e_j;  pred = num / den
// with the product and the sum rounded separately (no fused multiply-add),
// the arithmetic of the plain twin `_prop_step_batched` in ops/labelprop.py
// (prop_all normalises each weight first and sums in ascending row order:
// `_prop_all_step_batched`).

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace prop {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxClasses = 128;  // M: a warp's lanes hold 4 classes each
constexpr float kNegInvalid = -1e12f;  // ops/labelprop.py NEG_INVALID

__device__ __forceinline__ bool lex_better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Lexicographic best across a warp; every lane ends with the result.
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (lex_better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// One step of the weighted label sum: num += e * label, unfused.
__device__ __forceinline__ float add_weighted(float num, float e, float label) {
  return __fadd_rn(num, __fmul_rn(e, label));
}

}  // namespace prop
