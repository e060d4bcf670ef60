// Whole-sequence label propagation for a batch of radargrams, by hand for
// sm_90a: all B x (T-1) frames in two launches.
//
// Replaces the Pallas TPU kernel `_prop_seq_v2_kernel` in
// radar_sounder_crw_tpu/ops/labelprop_pallas.py (entries
// `propagate_all_pallas_v2` and `propagate_all_pallas_v2_batched`). It
// computes what that kernel computes, without its TPU layout (lane packing,
// padded rows and lanes, slot chunks): for radargram b and frame t, over
// the ring of prop_frames.cuh,
//
//   soft[b,t,n] = the knn winners' softmax-weighted labels soft[b,f,i]
//                (prop_common.cuh), frame 0 being the seed.
//
// Design: the two kernels of prop_frames.cuh.
//   A. `select<., false>`: every (query tile, frame, radargram) at once on
//      the tile core, writing each query's winners in winner order as
//      (source, e), e = exp(v - v_0).
//   B. `chain<true>`: one CTA per radargram walks the frames in order:
//      soft[b,t,n] = (sum_j e_j * soft[b,f_j,i_j]) / sum_j e_j, unfused and
//      in winner order.
//
// Bound: the affinity products, 2*ns*N*N*C float32 operations per frame
// (2.06e11 over the Miguel survey, 3.1 ms at 67 TFLOP/s); phase A is that
// product plus the selection, phase B ~37 M multiply-adds in a chain of
// T-1 steps per radargram.
//
// Plain C interface, loaded with ctypes (ops/labelprop_cuda.py).

#include "prop_frames.cuh"

namespace frames = prop::frames;

extern "C" {

// Dynamic shared memory bytes a CTA of either phase may use.
int prop_seq_max_dynamic_smem(void) { return frames::max_dynamic_smem<false, true>(); }

long long prop_seq_select_smem_bytes(int knn, int ns_max) {
  return static_cast<long long>(frames::select_smem_bytes(knn, ns_max));
}

long long prop_seq_chain_smem_bytes(int T, int N, int M, int knn, int in_smem) {
  return static_cast<long long>(frames::chain_smem_bytes(T, N, M, knn, in_smem != 0));
}

int prop_seq_max_classes(void) { return prop::kMaxClasses; }

const char* prop_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Phase A on `stream`: every frame's winner lists (source, e).
int prop_seq_select_launch(const float* emb, const float* mask, const int* long_mem,
                           int* src, float* e, int B, int T, int N, int C, int L, int cxt,
                           float temperature, int knn, int ns_max, int vec4, void* stream) {
  return frames::select_launch<false>(emb, mask, long_mem, src, e, B, T, N, C, L, cxt,
                                      temperature, knn, ns_max, vec4, stream);
}

// Phase B on `stream`: the label chain from phase A's lists.
int prop_seq_chain_launch(const int* src, const float* e, float* soft, int B, int T, int N,
                          int M, int knn, int in_smem, void* stream) {
  return frames::chain_launch<true>(src, e, soft, B, T, N, M, knn, in_smem, stream);
}

}  // extern "C"
