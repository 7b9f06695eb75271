// Fused paged decode attention (KV write + attend), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (fused_paged_decode_attention / _fused_paged_decode_kernel), reached from
// repro.models.layers.paged_update_attend.
//
// One decode token per slot. For slot b the kernel writes the token's new
// k/v row at logical position pos[b] into the slot's write page
// (bt[b, clip(pos // ps, 0, P - 1)], row pos % ps) in place, then attends
// over the slot's block table with valid length pos + 1. Block-table entries
// are clamped into [0, n_phys - 1], as the Pallas wrapper clamps them.
//
// Split-KV (FlashDecoding): the slot's P * ps logical rows are cut into
// n_split (at most 8) spans of split_rows, one block per (span, KV head,
// slot); the spans of one (slot, KV head) form a cluster and fold their
// partials in span order through distributed shared memory (decode_split.cuh
// fold_cluster), in the same launch: no float atomics, so two calls give
// the same outputs bit for bit. The host cuts the spans from P and ps
// alone (no read of pos); a span that starts at or past the slot's valid
// length writes an empty partial and exits, so pages past the length are
// never read. The block whose span holds the write row does the write (a
// bit copy of the new k/v row into its page) and takes that row from
// k_new / v_new for its own scores, never reading it back through the
// pool; no other span covers it. Two bodies:
// - bf16 at D in {64, 128}: the tensor-core body (decode_mma.cuh):
//   cp.async ring of 64-row bf16 tiles, S and P.V on mma.sync.
// - f32 at D in {16, 32, 64, 128}: the SIMT body (decode_split.cuh).
// bf16 at D in {16, 32} has no body: the wrapper raises before a launch.
//
// Pool contract (the serving engine's kernel layout, as for the Pallas
// kernel): the pool carries one trash page at index n_phys - 1, equal to the
// block table's sentinel, and a page that a slot writes is private to that
// slot. So no two live slots write one page. An inactive slot (all-
// sentinel row) would write its garbage row into the trash page; the kernel
// drops a write whose page is the trash page instead, so that no block
// writes a row that another block of the launch reads: an inactive slot's
// spans read only trash-page rows, which then stay fixed, and its output,
// discarded by the engine, is the same on every call. No live slot reads a
// trash-page row without masking it (its positions lie at or past the
// slot's valid length).
//
// What bounds it on the H100: one pass over each slot's live KV rows
// (2 * valid_len * K * D elements) for 4 * G * D flops per position, far
// below the card's ridge point: it is bound by bytes. Each live page row is
// read once, in 16-byte pieces of rows of D contiguous elements, and the
// gathered (B, P * ps, K, D) view that the plain version builds is never
// materialised. At the engine's shapes the bytes are few (about 2.5 MB at
// 8 slots of llama3.2-1b), so launch latency and one span's load round trip
// set the time; the split gives every SM blocks to overlap them.
#include <type_traits>

#include "decode_mma.cuh"

using namespace repro;
using namespace repro::decode_split;

namespace {

// What one block needs besides its body: its span, its rows, and the write.
struct Span {
  int t0, t1;     // the span's live rows
  int t_w;        // logical row of the write: wblk * ps + pos % ps
  PagedRows rows;
};

// Block (s, kh, b): its span of slot b's rows, and the write of the new
// k/v row if the span holds it.
template <typename T>
__device__ __forceinline__ Span span_and_write(
    const T* __restrict__ k_new, const T* __restrict__ v_new, T* k_pool,
    T* v_pool, const int* __restrict__ bt, const int* __restrict__ pos_arr,
    int K, int D, int n_phys, int ps, int P, int split_rows) {
  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int pos = pos_arr[b];
  const int valid = min(pos + 1, P * ps);
  const int wblk = min(max(pos / ps, 0), P - 1);
  const int woff = pos % ps;
  Span sp;
  sp.t0 = min(s * split_rows, valid);
  sp.t1 = min(sp.t0 + split_rows, valid);
  sp.t_w = wblk * ps + woff;
  sp.rows = PagedRows::of(bt, b, kh, K, D, n_phys, ps, P);
  // the span holding the write row, unless its page (clamped) is the trash
  if (sp.t_w >= s * split_rows && sp.t_w < (s + 1) * split_rows &&
      sp.rows.bt_row[wblk] < n_phys - 1) {
    // the write: a bit copy of the new row into its page, in place
    const size_t off = sp.rows(sp.t_w);
    const size_t src = ((size_t)b * K + kh) * D;
    for (int d = threadIdx.x; d < D; d += NT) {
      k_pool[off + d] = k_new[src + d];
      v_pool[off + d] = v_new[src + d];
    }
  }
  return sp;
}

// f32: the SIMT body
template <int D>
__global__ void __launch_bounds__(NT) fused_decode_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k_new,
    const float* __restrict__ v_new, float* k_pool, float* v_pool,
    const int* __restrict__ bt, const int* __restrict__ pos_arr,
    float* __restrict__ out, int K, int G, int n_phys, int ps, int P,
    int split_rows, float sm_scale) {
  __shared__ Partial<D> part;
  __shared__ Inbox<D> inbox;
  cluster_started();
  const Span sp = span_and_write<float>(k_new, v_new, k_pool, v_pool, bt,
                                        pos_arr, K, D, n_phys, ps, P,
                                        split_rows);
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  attend_span<float, D, PagedRows, true>(
      q + bk * G * D, k_pool, v_pool, sp.rows, G, sp.t0, sp.t1, sm_scale,
      part.m, part.l, part.acc, sp.t_w, k_new + bk * D, v_new + bk * D);
  fold_cluster<float, D>(part, inbox, G, out + bk * G * D);
}

// bf16: the tensor-core body
template <int D>
__global__ void __launch_bounds__(decode_mma::NT) fused_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* k_new,
    const __nv_bfloat16* v_new, __nv_bfloat16* k_pool,
    __nv_bfloat16* v_pool, const int* __restrict__ bt,
    const int* __restrict__ pos_arr, __nv_bfloat16* __restrict__ out, int K,
    int G, int n_phys, int ps, int P, int split_rows, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Partial<D> part;
  __shared__ Inbox<D> inbox;
  cluster_started();
  const Span sp = span_and_write<__nv_bfloat16>(
      k_new, v_new, k_pool, v_pool, bt, pos_arr, K, D, n_phys, ps, P,
      split_rows);
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  decode_mma::attend_span_mma<D>(q + bk * G * D, k_pool, v_pool, sp.rows, G,
                                 sp.t0, sp.t1, sm_scale, part.m, part.l,
                                 part.acc, smem, sp.t_w, k_new + bk * D,
                                 v_new + bk * D);
  fold_cluster<__nv_bfloat16, D>(part, inbox, G,
                                             out + bk * G * D);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pool, void* v_pool, const void* bt,
                   const void* pos, void* out, int B, int K, int G,
                   int n_phys, int ps, int P, int n_split, int split_rows,
                   cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T* qq = static_cast<const T*>(q);
  const T* kn = static_cast<const T*>(k_new);
  const T* vn = static_cast<const T*>(v_new);
  T* kp = static_cast<T*>(k_pool);
  T* vp = static_cast<T*>(v_pool);
  const int* bti = static_cast<const int*>(bt);
  const int* pi = static_cast<const int*>(pos);
  T* o = static_cast<T*>(out);
  if constexpr (std::is_same_v<T, float>) {
    return launch_clusters(
        fused_decode_simt_kernel<D>, n_split, K, B, NT, 0, stream, qq, kn,
        vn, kp, vp, bti, pi, o, K, G, n_phys, ps, P, split_rows, scale);
  } else {
    constexpr int smem = decode_mma::Layout<D>::kBytes;
    const cudaError_t e =
        decode_mma::allow_smem<fused_decode_mma_kernel<D>>(smem);
    if (e != cudaSuccess) return e;
    return launch_clusters(
        fused_decode_mma_kernel<D>, n_split, K, B, decode_mma::NT, smem,
        stream, qq, kn, vn, kp, vp, bti, pi, o, K, G, n_phys, ps, P,
        split_rows, scale);
  }
}

#define FUSED_ARGS q, k_new, v_new, k_pool, v_pool, bt, pos, out, B, K, G, \
    n_phys, ps, P, n_split, split_rows, st

cudaError_t dispatch(const void* q, const void* k_new, const void* v_new,
                     void* k_pool, void* v_pool, const void* bt,
                     const void* pos, void* out, int B, int K, int G, int D,
                     int n_phys, int ps, int P, int n_split, int split_rows,
                     int dtype, cudaStream_t st) {
  if (dtype == kBFloat16) {
    switch (D) {
      case 64: return launch<__nv_bfloat16, 64>(FUSED_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(FUSED_ARGS);
    }
  } else if (dtype == kFloat32) {
    switch (D) {
      case 16: return launch<float, 16>(FUSED_ARGS);
      case 32: return launch<float, 32>(FUSED_ARGS);
      case 64: return launch<float, 64>(FUSED_ARGS);
      case 128: return launch<float, 128>(FUSED_ARGS);
    }
  }
  return cudaErrorInvalidValue;
}

#undef FUSED_ARGS

}  // namespace

extern "C" int fused_paged_decode_fwd(const void* q, const void* k_new,
                                      const void* v_new, void* k_pool,
                                      void* v_pool, const void* bt,
                                      const void* pos, void* out, int B,
                                      int K, int G, int D, int n_phys,
                                      int ps, int P, int n_split,
                                      int split_rows, int dtype,
                                      void* stream) {
  if (G < 1 || G > GMAX || B < 1 || K < 1 || P < 1 || ps < 1 ||
      n_phys < 1 || n_split < 1 || n_split > MAX_SPLIT ||
      split_rows < 1 || (long long)n_split * split_rows < (long long)P * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(q, k_new, v_new, k_pool, v_pool, bt, pos,
                                   out, B, K, G, D, n_phys, ps, P, n_split,
                                   split_rows, dtype,
                                   static_cast<cudaStream_t>(stream)));
}
