// Contiguous one-token decode attention, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel), reached through
// repro.kernels.ops.flash_attention_grouped when S == 1: the vlm family's
// cross-attention over the cached image k/v at every decode step.
//
// q (B, K, G, D) attends over k/v in the model layout (B, T, K, D), read
// through its strides (no (B, K, T, D) transpose as the Pallas adapter
// makes), up to a valid length <= T. T need not be a multiple of any
// block: the ragged tail is masked here (the Pallas kernel asserts
// T % min(512, T) == 0, so it cannot take the vision config's T = 1601).
// A valid length of 0 gives zeros. Two forms of the length:
// - scalar: one valid_len shared by every slot (the vision model's
//   cross-attention over its image tokens). The host cuts valid_len rows
//   into n_split spans.
// - per slot: vlen, a (B,) int32 device array, read here by each block
//   (clamped into [0, T]), never on the host, so a CUDA graph captures
//   the launch: the contiguous KV layout's self-attention at pos + 1 and
//   whisper's cross-attention at enc_len. The host cuts all T rows into
//   spans from T alone, with the fused paged kernel's plan (128-row spans,
//   at most 8), and a span that starts at or past the slot's length
//   attends nothing and reads no row; so a contiguous slot folds the same
//   spans, in the same order, as the fused paged kernel over the same
//   rows, and gives its bits.
//
// Two bodies, each split over the rows into n_split (at most 8) spans of
// split_rows, one block per (span, KV head, slot), so 8 slots x 8 KV
// heads fill the SMs instead of 64 blocks each walking all T rows; the
// spans of one (slot, KV head) form a cluster and fold their partials in
// span order through distributed shared memory (decode_split.cuh
// fold_cluster), in the same launch.
// - bf16 at D in {64, 96, 128}: the tensor-core body (decode_mma.cuh):
//   cp.async ring of 64-row bf16 tiles, S and P.V on mma.sync.
// - f32 at D in {16, 32, 64, 96, 128}: the SIMT body (decode_split.cuh).
// Each body is instantiated at R = 8 rows (G <= 8) and R = 16 (G 9-16),
// but the SIMT body at D = 128, whose shared memory at R = 16 passes the
// static limit. Any other (dtype, G, D) has no body: the wrapper raises
// before a launch.
//
// What bounds it on the H100: one pass over K and V (2 * B * valid_len * K
// * D elements) for 4 * G * D flops per row and head: bound by bytes. Each
// row's D elements are contiguous, so the copies coalesce.
#include <type_traits>

#include "decode_mma.cuh"

using namespace repro;
using namespace repro::decode_split;

namespace {

// Block (s, kh, b)'s span: [x, y) of the slot's valid rows
__device__ __forceinline__ int2 span_of(const int* __restrict__ vlen,
                                        int valid_len, int T_len,
                                        int split_rows) {
  const int valid =
      vlen != nullptr ? min(max(vlen[blockIdx.z], 0), T_len) : valid_len;
  const int t0 = min((int)blockIdx.x * split_rows, valid);
  return make_int2(t0, min(t0 + split_rows, valid));
}

struct ContiguousRows {
  size_t base, row_stride;
  __device__ __forceinline__ size_t operator()(int t) const {
    return base + (size_t)t * row_stride;
  }
};

// f32: the SIMT body
template <int D, int R>
__global__ void __launch_bounds__(NT) decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ vlen,
    float* __restrict__ out, int T_len, int K, int G, int valid_len,
    int split_rows, float sm_scale) {
  __shared__ Partial<D, R> part;
  __shared__ Inbox<D, R> inbox;
  cluster_started();
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  const int2 sp = span_of(vlen, valid_len, T_len, split_rows);
  const ContiguousRows rows{(size_t)blockIdx.z * T_len * K * D +
                                (size_t)blockIdx.y * D,
                            (size_t)K * D};
  attend_span<float, D, R>(q + bk * G * D, k, v, rows, G, sp.x, sp.y,
                           sm_scale, part.m, part.l, part.acc);
  fold_cluster<float, D, R>(part, inbox, G, out + bk * G * D);
}

// bf16: the tensor-core body
template <int D, int R>
__global__ void __launch_bounds__(decode_mma::NT) decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const int* __restrict__ vlen,
    __nv_bfloat16* __restrict__ out, int T_len, int K, int G, int valid_len,
    int split_rows, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Partial<D, R> part;
  __shared__ Inbox<D, R> inbox;
  cluster_started();
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  const int2 sp = span_of(vlen, valid_len, T_len, split_rows);
  const ContiguousRows rows{(size_t)blockIdx.z * T_len * K * D +
                                (size_t)blockIdx.y * D,
                            (size_t)K * D};
  decode_mma::attend_span_mma<D, R>(q + bk * G * D, k, v, rows, G, sp.x,
                                    sp.y, sm_scale, part.m, part.l,
                                    part.acc, smem, -1, nullptr, nullptr);
  fold_cluster<__nv_bfloat16, D, R>(part, inbox, G, out + bk * G * D);
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* vlen, void* out, int B, int T_len, int K,
                   int G, int valid_len, int n_split, int split_rows,
                   cudaStream_t stream) {
  const int* vl = static_cast<const int*>(vlen);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if constexpr (std::is_same_v<T, float>) {
    return launch_clusters(
        decode_kernel<D, R>, n_split, K, B, NT, 0, stream,
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), vl, static_cast<float*>(out), T_len,
        K, G, valid_len, split_rows, scale);
  } else {
    constexpr int smem = decode_mma::Layout<D>::kBytes;
    const cudaError_t e =
        decode_mma::allow_smem<decode_mma_kernel<D, R>>(smem);
    if (e != cudaSuccess) return e;
    return launch_clusters(
        decode_mma_kernel<D, R>, n_split, K, B, decode_mma::NT, smem, stream,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), vl, static_cast<T*>(out), T_len, K, G,
        valid_len, split_rows, scale);
  }
}

#define DECODE_ARGS q, k, v, vlen, out, B, T_len, K, G, valid_len, \
    n_split, split_rows, st

// The body of G's row count (decode_split.cuh rows_for)
template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* vlen, void* out, int B, int T_len, int K,
                        int G, int valid_len, int n_split, int split_rows,
                        cudaStream_t st) {
  if (rows_for(G) == 8) return launch<T, D, 8>(DECODE_ARGS);
  if constexpr (std::is_same_v<T, float> && !simt_fits<D, 16>())
    return cudaErrorInvalidValue;
  else
    return launch<T, D, 16>(DECODE_ARGS);
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* vlen, void* out, int B, int T_len, int K,
                     int G, int D,
                     int valid_len, int n_split, int split_rows, int dtype,
                     cudaStream_t st) {
  if (dtype == kBFloat16) {
    switch (D) {
      case 64: return launch_rows<__nv_bfloat16, 64>(DECODE_ARGS);
      case 96: return launch_rows<__nv_bfloat16, 96>(DECODE_ARGS);
      case 128: return launch_rows<__nv_bfloat16, 128>(DECODE_ARGS);
    }
  } else if (dtype == kFloat32) {
    switch (D) {
      case 16: return launch_rows<float, 16>(DECODE_ARGS);
      case 32: return launch_rows<float, 32>(DECODE_ARGS);
      case 64: return launch_rows<float, 64>(DECODE_ARGS);
      case 96: return launch_rows<float, 96>(DECODE_ARGS);
      case 128: return launch_rows<float, 128>(DECODE_ARGS);
    }
  }
  return cudaErrorInvalidValue;
}

#undef DECODE_ARGS

}  // namespace

// vlen: the per-slot lengths (B,) on the device, or null for the scalar
// valid_len. The spans must cover valid_len rows (scalar) or all T rows
// (per slot).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* vlen,
                                    void* out, int B, int T_len, int K,
                                    int G, int D, int valid_len, int n_split,
                                    int split_rows, int dtype, void* stream) {
  const int rows = vlen != nullptr ? T_len : valid_len;
  if (G < 1 || G > GMAX || B < 1 || K < 1 || T_len < 1 || valid_len < 0 ||
      valid_len > T_len || n_split < 1 ||
      n_split > MAX_SPLIT || split_rows < 1 ||
      (long long)n_split * split_rows < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(q, k, v, vlen, out, B, T_len, K, G, D,
                                   valid_len, n_split, split_rows, dtype,
                                   static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of the tensor-core body at head dim D (both kernels
// that run it), for the build report.
extern "C" int decode_mma_smem_bytes(int D) {
  return D == 64    ? decode_mma::Layout<64>::kBytes
         : D == 96  ? decode_mma::Layout<96>::kBytes
         : D == 128 ? decode_mma::Layout<128>::kBytes
                    : 0;
}
