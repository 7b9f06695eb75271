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
// Design: split-T flash-decode (decode_split.cuh): valid_len rows are cut
// into n_split spans of split_rows, one block per (span, KV head, slot),
// and a second pass combines the spans in order, so 8 slots x 8 KV heads
// fill the SMs instead of 64 blocks each walking all T rows.
//
// What bounds it on the H100: one pass over K and V (2 * B * valid_len * K
// * D elements) for 4 * G * D flops per row and head: bound by bytes. Each
// row's D elements are contiguous, so the staging loads coalesce. The
// products run on the f32 SIMT pipes.
#include "decode_split.cuh"

using namespace repro;
using namespace repro::decode_split;

namespace {

struct ContiguousRows {
  size_t base, row_stride;
  __device__ __forceinline__ size_t operator()(int t) const {
    return base + (size_t)t * row_stride;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, Workspace ws, int T_len, int K, int G,
    int valid_len, int split_rows, float sm_scale) {
  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = min(s * split_rows, valid_len);
  const int t1 = min(t0 + split_rows, valid_len);
  ContiguousRows rows;
  rows.row_stride = (size_t)K * D;
  rows.base = (size_t)b * T_len * K * D + (size_t)kh * D;
  float *pm, *pl, *pa;
  ws.at(b, kh, s, K, G, D, gridDim.x, &pm, &pl, &pa);
  attend_span<T, D>(q + ((size_t)b * K + kh) * G * D, k, v, rows, G, t0, t1,
                    sm_scale, pm, pl, pa);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, float* ws,
            void* out, int B, int T_len, int K, int G, int valid_len,
            int n_split, int split_rows, cudaStream_t stream) {
  const size_t n_part = (size_t)B * K * n_split;
  const Workspace w{ws, ws + n_part * G, ws + 2 * n_part * G};
  decode_kernel<T, D><<<dim3(n_split, K, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), w, T_len, K, G, valid_len, split_rows,
      1.0f / sqrtf(static_cast<float>(D)));
  combine_kernel<T><<<dim3(K, B), NT, 0, stream>>>(
      w.m, w.l, w.acc, static_cast<T*>(out), K, G, D, n_split);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, float* ws,
               void* out, int B, int T_len, int K, int G, int D,
               int valid_len, int n_split, int split_rows, cudaStream_t st) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, ws, out, B, T_len, K, G, valid_len, n_split, split_rows, st); break;
    case 32: launch<T, 32>(q, k, v, ws, out, B, T_len, K, G, valid_len, n_split, split_rows, st); break;
    case 64: launch<T, 64>(q, k, v, ws, out, B, T_len, K, G, valid_len, n_split, split_rows, st); break;
    case 128: launch<T, 128>(q, k, v, ws, out, B, T_len, K, G, valid_len, n_split, split_rows, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ws: 2 * B * K * n_split * G + B * K * n_split * G * D floats.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* ws, void* out,
                                    int B, int T_len, int K, int G, int D,
                                    int valid_len, int n_split,
                                    int split_rows, int dtype, void* stream) {
  if (G < 1 || G > GMAX || B < 1 || K < 1 || T_len < 1 || valid_len < 0 ||
      valid_len > T_len || n_split < 1 || split_rows < 1 ||
      (long long)n_split * split_rows < valid_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, w, out, B, T_len, K, G, D,
                                     valid_len, n_split, split_rows, st);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k, v, w, out, B, T_len, K, G, D, valid_len,
                             n_split, split_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
