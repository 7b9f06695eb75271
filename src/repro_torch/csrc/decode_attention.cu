// Contiguous one-token decode attention, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel), reached through
// repro.kernels.ops.flash_attention_grouped when S == 1: the vlm family's
// cross-attention over the cached image k/v at every decode step.
//
// q (B, K, G, D) attends over k/v in the model layout (B, T, K, D), read
// through its strides (no (B, K, T, D) transpose as the Pallas adapter
// makes), up to one scalar valid_len <= T shared by every slot. T need not
// be a multiple of any block: the ragged tail is masked here (the Pallas
// kernel asserts T % min(512, T) == 0, so it cannot take the vision
// config's T = 1601). valid_len 0 gives zeros.
//
// Two bodies, each split over the rows: valid_len rows are cut into n_split
// (at most 8) spans of split_rows, one block per (span, KV head, slot), so
// 8 slots x 8 KV heads fill the SMs instead of 64 blocks each walking all T
// rows; the spans of one (slot, KV head) form a cluster and fold their
// partials in span order through distributed shared memory (decode_split.cuh
// fold_cluster), in the same launch.
// - bf16 at D in {64, 128}: the tensor-core body (decode_mma.cuh):
//   cp.async ring of 64-row bf16 tiles, S and P.V on mma.sync.
// - f32 at D in {16, 32, 64, 128}: the SIMT body (decode_split.cuh).
// bf16 at D in {16, 32} has no body: the wrapper raises before a launch.
//
// What bounds it on the H100: one pass over K and V (2 * B * valid_len * K
// * D elements) for 4 * G * D flops per row and head: bound by bytes. Each
// row's D elements are contiguous, so the copies coalesce.
#include <type_traits>

#include "decode_mma.cuh"

using namespace repro;
using namespace repro::decode_split;

namespace {

struct ContiguousRows {
  size_t base, row_stride;
  __device__ __forceinline__ size_t operator()(int t) const {
    return base + (size_t)t * row_stride;
  }
};

// f32: the SIMT body
template <int D>
__global__ void __launch_bounds__(NT) decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int T_len, int K,
    int G, int valid_len, int split_rows, float sm_scale) {
  __shared__ Partial<D> part;
  __shared__ Inbox<D> inbox;
  cluster_started();
  const int s = blockIdx.x;
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  const int t0 = min(s * split_rows, valid_len);
  const int t1 = min(t0 + split_rows, valid_len);
  const ContiguousRows rows{(size_t)blockIdx.z * T_len * K * D +
                                (size_t)blockIdx.y * D,
                            (size_t)K * D};
  attend_span<float, D>(q + bk * G * D, k, v, rows, G, t0, t1, sm_scale,
                        part.m, part.l, part.acc);
  fold_cluster<float, D>(part, inbox, G, out + bk * G * D);
}

// bf16: the tensor-core body
template <int D>
__global__ void __launch_bounds__(decode_mma::NT) decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* k,
    const __nv_bfloat16* v, __nv_bfloat16* __restrict__ out, int T_len,
    int K, int G, int valid_len, int split_rows, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Partial<D> part;
  __shared__ Inbox<D> inbox;
  cluster_started();
  const int s = blockIdx.x;
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  const int t0 = min(s * split_rows, valid_len);
  const int t1 = min(t0 + split_rows, valid_len);
  const ContiguousRows rows{(size_t)blockIdx.z * T_len * K * D +
                                (size_t)blockIdx.y * D,
                            (size_t)K * D};
  decode_mma::attend_span_mma<D>(q + bk * G * D, k, v, rows, G, t0, t1,
                                 sm_scale, part.m, part.l, part.acc, smem,
                                 -1, nullptr, nullptr);
  fold_cluster<__nv_bfloat16, D>(part, inbox, G,
                                             out + bk * G * D);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T_len, int K, int G, int valid_len,
                   int n_split, int split_rows, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if constexpr (std::is_same_v<T, float>) {
    return launch_clusters(
        decode_kernel<D>, n_split, K, B, NT, 0, stream,
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), T_len, K, G,
        valid_len, split_rows, scale);
  } else {
    constexpr int smem = decode_mma::Layout<D>::kBytes;
    const cudaError_t e = decode_mma::allow_smem<decode_mma_kernel<D>>(smem);
    if (e != cudaSuccess) return e;
    return launch_clusters(
        decode_mma_kernel<D>, n_split, K, B, decode_mma::NT, smem, stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), T_len, K, G,
        valid_len, split_rows, scale);
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int T_len, int K, int G, int D,
                     int valid_len, int n_split, int split_rows, int dtype,
                     cudaStream_t st) {
  if (dtype == kBFloat16) {
    switch (D) {
      case 64: return launch<__nv_bfloat16, 64>(q, k, v, out, B, T_len, K, G, valid_len, n_split, split_rows, st);
      case 128: return launch<__nv_bfloat16, 128>(q, k, v, out, B, T_len, K, G, valid_len, n_split, split_rows, st);
    }
  } else if (dtype == kFloat32) {
    switch (D) {
      case 16: return launch<float, 16>(q, k, v, out, B, T_len, K, G, valid_len, n_split, split_rows, st);
      case 32: return launch<float, 32>(q, k, v, out, B, T_len, K, G, valid_len, n_split, split_rows, st);
      case 64: return launch<float, 64>(q, k, v, out, B, T_len, K, G, valid_len, n_split, split_rows, st);
      case 128: return launch<float, 128>(q, k, v, out, B, T_len, K, G, valid_len, n_split, split_rows, st);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, int B,
                                    int T_len, int K, int G, int D,
                                    int valid_len, int n_split,
                                    int split_rows, int dtype, void* stream) {
  if (G < 1 || G > GMAX || B < 1 || K < 1 || T_len < 1 || valid_len < 0 ||
      valid_len > T_len || n_split < 1 ||
      n_split > MAX_SPLIT || split_rows < 1 ||
      (long long)n_split * split_rows < valid_len)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(q, k, v, out, B, T_len, K, G, D,
                                   valid_len, n_split, split_rows, dtype,
                                   static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of the tensor-core body at head dim D (both kernels
// that run it), for the build report.
extern "C" int decode_mma_smem_bytes(int D) {
  return D == 64    ? decode_mma::Layout<64>::kBytes
         : D == 128 ? decode_mma::Layout<128>::kBytes
                    : 0;
}
