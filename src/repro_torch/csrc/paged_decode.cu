// Paged one-token decode attention, attend only, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (paged_decode_attention / _paged_decode_kernel), reached from
// repro.models.layers.paged_attention_core: the audio family's
// cross-attention over its paged encoder k/v at every decode step.
//
// For slot b the kernel attends q (K x G x D) over the slot's logical rows
// [0, valid_len[b]) of a shared page pool through its block table: row t
// lives at pool[bt[b, t / ps], t % ps]. Block-table entries are clamped
// into [0, n_phys - 1], as the Pallas wrapper clamps them; with the serving
// engine's kernel pool layout the sentinel lands on its trash page. Unlike
// the fused kernel (fused_paged_decode.cu) it writes nothing, and the
// length is each slot's own, not tied to a write position. valid_len is
// clamped into [0, P * ps]; a slot with valid_len 0 gets zeros.
//
// What bounds it on the H100: one pass over the live pages' K/V rows
// (2 * valid_len * K * D elements per slot) for 4 * G * D flops per row:
// bound by bytes. At the engine's shapes the bytes are few (about 4.9 MB at
// 8 slots of whisper-base's 300 encoder frames: 1.5 us at the card's
// rate), so launch latency and one span's load round trip set the time.
// The design, the fused kernel's minus its write:
// - Split-KV: the host cuts the slot's P * ps logical rows into n_split
//   (at most 8) spans of split_rows from P and ps alone (no read of
//   valid_len), one block per (span, KV head, slot), so every SM has
//   blocks whose loads overlap. A span that starts at or past the slot's
//   length attends nothing and reads no page; rows past the length inside
//   a live span are zero-filled, never read.
// - One launch, no workspace: the spans of one (slot, KV head) form a
//   cluster and fold their partials in span order through distributed
//   shared memory (decode_split.cuh fold_cluster), with no float atomics,
//   so two calls give the same bits.
// - Two bodies. bf16 at D in {64, 128}: the tensor-core body
//   (decode_mma.cuh), 64-row bf16 tiles through a cp.async ring of 16-byte
//   copies, S and P.V on mma.sync. f32 at D in {16, 32, 64, 128}: the SIMT
//   body (decode_split.cuh). bf16 at D in {16, 32} has no body: the wrapper
//   raises before a launch.
// Each live row is read once, in rows of D contiguous elements, and the
// gathered (B, P * ps, K, D) view that the plain version builds is never
// materialised.
#include <type_traits>

#include "decode_mma.cuh"

using namespace repro;
using namespace repro::decode_split;

namespace {

// Block (s, kh, b)'s span of slot b's live rows: [x, y)
__device__ __forceinline__ int2 live_span(const int* __restrict__ vlen,
                                          int ps, int P, int split_rows) {
  const int valid = min(max(vlen[blockIdx.z], 0), P * ps);
  const int t0 = min((int)blockIdx.x * split_rows, valid);
  return make_int2(t0, min(t0 + split_rows, valid));
}

// f32: the SIMT body
template <int D>
__global__ void __launch_bounds__(NT) paged_decode_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ bt,
    const int* __restrict__ vlen, float* __restrict__ out, int K, int G,
    int n_phys, int ps, int P, int split_rows, float sm_scale) {
  __shared__ Partial<D> part;
  __shared__ Inbox<D> inbox;
  cluster_started();
  const int2 sp = live_span(vlen, ps, P, split_rows);
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  const PagedRows rows =
      PagedRows::of(bt, blockIdx.z, blockIdx.y, K, D, n_phys, ps, P);
  attend_span<float, D>(q + bk * G * D, k_pool, v_pool, rows, G, sp.x, sp.y,
                        sm_scale, part.m, part.l, part.acc);
  fold_cluster<float, D>(part, inbox, G, out + bk * G * D);
}

// bf16: the tensor-core body
template <int D>
__global__ void __launch_bounds__(decode_mma::NT) paged_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* k_pool,
    const __nv_bfloat16* v_pool, const int* __restrict__ bt,
    const int* __restrict__ vlen, __nv_bfloat16* __restrict__ out, int K,
    int G, int n_phys, int ps, int P, int split_rows, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Partial<D> part;
  __shared__ Inbox<D> inbox;
  cluster_started();
  const int2 sp = live_span(vlen, ps, P, split_rows);
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  const PagedRows rows =
      PagedRows::of(bt, blockIdx.z, blockIdx.y, K, D, n_phys, ps, P);
  decode_mma::attend_span_mma<D>(q + bk * G * D, k_pool, v_pool, rows, G,
                                 sp.x, sp.y, sm_scale, part.m, part.l,
                                 part.acc, smem, -1, nullptr, nullptr);
  fold_cluster<__nv_bfloat16, D>(part, inbox, G, out + bk * G * D);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* bt, const void* vlen, void* out, int B, int K,
                   int G, int n_phys, int ps, int P, int n_split,
                   int split_rows, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qq = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const int* bti = static_cast<const int*>(bt);
  const int* vl = static_cast<const int*>(vlen);
  T* o = static_cast<T*>(out);
  if constexpr (std::is_same_v<T, float>) {
    return launch_clusters(paged_decode_simt_kernel<D>, n_split, K, B, NT,
                           0, stream, qq, kp, vp, bti, vl, o, K, G, n_phys,
                           ps, P, split_rows, scale);
  } else {
    constexpr int smem = decode_mma::Layout<D>::kBytes;
    const cudaError_t e =
        decode_mma::allow_smem<paged_decode_mma_kernel<D>>(smem);
    if (e != cudaSuccess) return e;
    return launch_clusters(paged_decode_mma_kernel<D>, n_split, K, B,
                           decode_mma::NT, smem, stream, qq, kp, vp, bti, vl,
                           o, K, G, n_phys, ps, P, split_rows, scale);
  }
}

#define PAGED_ARGS q, k_pool, v_pool, bt, vlen, out, B, K, G, n_phys, ps, \
    P, n_split, split_rows, st

cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const void* bt, const void* vlen, void* out, int B,
                     int K, int G, int D, int n_phys, int ps, int P,
                     int n_split, int split_rows, int dtype,
                     cudaStream_t st) {
  if (dtype == kBFloat16) {
    switch (D) {
      case 64: return launch<__nv_bfloat16, 64>(PAGED_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(PAGED_ARGS);
    }
  } else if (dtype == kFloat32) {
    switch (D) {
      case 16: return launch<float, 16>(PAGED_ARGS);
      case 32: return launch<float, 32>(PAGED_ARGS);
      case 64: return launch<float, 64>(PAGED_ARGS);
      case 128: return launch<float, 128>(PAGED_ARGS);
    }
  }
  return cudaErrorInvalidValue;
}

#undef PAGED_ARGS

}  // namespace

extern "C" int paged_decode_fwd(const void* q, const void* k_pool,
                                const void* v_pool, const void* bt,
                                const void* vlen, void* out, int B, int K,
                                int G, int D, int n_phys, int ps, int P,
                                int n_split, int split_rows, int dtype,
                                void* stream) {
  if (G < 1 || G > GMAX || B < 1 || K < 1 || P < 1 || ps < 1 ||
      n_phys < 1 || n_split < 1 || n_split > MAX_SPLIT ||
      split_rows < 1 || (long long)n_split * split_rows < (long long)P * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(q, k_pool, v_pool, bt, vlen, out, B, K,
                                   G, D, n_phys, ps, P, n_split, split_rows,
                                   dtype,
                                   static_cast<cudaStream_t>(stream)));
}
