// Whole-sequence label propagation with the TPU resident kernel's weight
// arithmetic, by hand for sm_90a: all B x (T-1) frames in two launches.
//
// Replaces the Pallas TPU kernel `_prop_all_kernel` in
// radar_sounder_crw_tpu/ops/labelprop_pallas.py (entry
// `propagate_all_pallas`, batched under `jax.vmap`). That kernel keeps one
// radargram's ring in scratch and, per frame, extracts the knn winners by
// passes over the whole untiled affinity that mark each winner (the lowest
// row on ties), then rebuilds every winner's weight from the marks in one
// pass and takes the product of the label ring with the weights. The
// marking passes select the lexicographic top-knn, the winners prop_seq
// finds; what differs is the weight arithmetic. For radargram b and frame
// t, over the ring of prop_frames.cuh:
//
//   winners  v_0 >= v_1 >= ... at candidate rows r_j, the lowest row first
//            on ties;
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
//
// Design: none of that reads a label before the final sum, so only the sum
// is a chain. The two kernels of prop_frames.cuh:
//   1. `select<., true>`: every (query tile, frame, radargram) at once on
//      the tile core, prop_seq's selection. Its epilogue, with the query's
//      list still in shared memory beside its candidate rows, sums den,
//      divides, and writes the entries at their rank by row as (source, w).
//   2. `chain<false>`: one CTA per radargram walks the frames in order:
//      soft[b,t,n] = sum_j w_j * soft[b,f_j,i_j] in the stored order; no
//      denominator and no division in the chain.
// No (ns*N, N) affinity is stored, no copy of it, no marks.
//
// Bound: as prop_seq's, the affinity products, 2*ns*N*N*C float32
// operations per frame; what holds the selection back from it is the tile
// core's (prop_tile.cuh).
//
// Plain C interface, loaded with ctypes (ops/labelprop_cuda.py).

#include "prop_frames.cuh"

namespace frames = prop::frames;

extern "C" {

// Dynamic shared memory bytes a CTA of either step may use.
int prop_all_max_dynamic_smem(void) { return frames::max_dynamic_smem<true, false>(); }

long long prop_all_select_smem_bytes(int knn, int ns_max) {
  return static_cast<long long>(frames::select_smem_bytes(knn, ns_max));
}

long long prop_all_chain_smem_bytes(int T, int N, int M, int knn, int in_smem) {
  return static_cast<long long>(frames::chain_smem_bytes(T, N, M, knn, in_smem != 0));
}

int prop_all_max_classes(void) { return prop::kMaxClasses; }

const char* prop_all_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Steps 1 and 2 on `stream`: every frame's lists (source, w) in row order.
int prop_all_select_launch(const float* emb, const float* mask, const int* long_mem,
                           int* src, float* w, int B, int T, int N, int C, int L, int cxt,
                           float temperature, int knn, int ns_max, int vec4, void* stream) {
  return frames::select_launch<true>(emb, mask, long_mem, src, w, B, T, N, C, L, cxt,
                                     temperature, knn, ns_max, vec4, stream);
}

// Step 3 on `stream`: the weights-only label chain from those lists.
int prop_all_chain_launch(const int* src, const float* w, float* soft, int B, int T, int N,
                          int M, int knn, int in_smem, void* stream) {
  return frames::chain_launch<false>(src, w, soft, B, T, N, M, knn, in_smem, stream);
}

}  // extern "C"
