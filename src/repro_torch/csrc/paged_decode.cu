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
// Design: split-T flash-decode (decode_split.cuh). The slot's logical rows
// are cut into n_split spans of split_rows; each (span, KV head, slot) is
// one block, and a second pass combines the spans in order. Spans that
// start at or past valid_len exit at once, so pages at or past the length
// are never read, and rows past it inside a live page are staged as zeros.
//
// What bounds it on the H100: one pass over the live pages' K/V rows
// (2 * valid_len * K * D elements per slot) for 4 * G * D flops per row:
// bound by bytes. The kernel reads each live row once, in rows of D
// contiguous elements, and never materialises the gathered (B, P * ps, K,
// D) view that the plain version builds. Splitting the span fills the SMs
// that one block per (slot, head) would leave idle (64 blocks on 132 SMs
// at 8 slots x 8 heads). The products run on the f32 SIMT pipes.
#include "decode_split.cuh"

using namespace repro;
using namespace repro::decode_split;

namespace {

struct PagedRows {
  const int* bt_row;
  int ps, n_phys;
  size_t page_stride, row_stride, head_off;
  __device__ __forceinline__ size_t operator()(int t) const {
    const int page = min(max(bt_row[t / ps], 0), n_phys - 1);
    return (size_t)page * page_stride + (size_t)(t % ps) * row_stride +
           head_off;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ bt,
    const int* __restrict__ vlen, Workspace ws, int K, int G, int n_phys,
    int ps, int P, int split_rows, float sm_scale) {
  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int valid = min(max(vlen[b], 0), P * ps);
  const int t0 = min(s * split_rows, valid);
  const int t1 = min(t0 + split_rows, valid);
  PagedRows rows;
  rows.bt_row = bt + (size_t)b * P;
  rows.ps = ps;
  rows.n_phys = n_phys;
  rows.row_stride = (size_t)K * D;
  rows.page_stride = (size_t)ps * K * D;
  rows.head_off = (size_t)kh * D;
  float *pm, *pl, *pa;
  ws.at(b, kh, s, K, G, D, gridDim.x, &pm, &pl, &pa);
  attend_span<T, D>(q + ((size_t)b * K + kh) * G * D, k_pool, v_pool, rows,
                    G, t0, t1, sm_scale, pm, pl, pa);
}

template <typename T, int D>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* bt, const void* vlen, float* ws, void* out, int B,
            int K, int G, int n_phys, int ps, int P, int n_split,
            int split_rows, cudaStream_t stream) {
  const size_t n_part = (size_t)B * K * n_split;
  const Workspace w{ws, ws + n_part * G, ws + 2 * n_part * G};
  paged_decode_kernel<T, D><<<dim3(n_split, K, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(bt),
      static_cast<const int*>(vlen), w, K, G, n_phys, ps, P, split_rows,
      1.0f / sqrtf(static_cast<float>(D)));
  combine_kernel<T><<<dim3(K, B), NT, 0, stream>>>(
      w.m, w.l, w.acc, static_cast<T*>(out), K, G, D, n_split);
}

template <typename T>
int dispatch_d(const void* q, const void* k_pool, const void* v_pool,
               const void* bt, const void* vlen, float* ws, void* out, int B,
               int K, int G, int D, int n_phys, int ps, int P, int n_split,
               int split_rows, cudaStream_t st) {
  switch (D) {
    case 16: launch<T, 16>(q, k_pool, v_pool, bt, vlen, ws, out, B, K, G, n_phys, ps, P, n_split, split_rows, st); break;
    case 32: launch<T, 32>(q, k_pool, v_pool, bt, vlen, ws, out, B, K, G, n_phys, ps, P, n_split, split_rows, st); break;
    case 64: launch<T, 64>(q, k_pool, v_pool, bt, vlen, ws, out, B, K, G, n_phys, ps, P, n_split, split_rows, st); break;
    case 128: launch<T, 128>(q, k_pool, v_pool, bt, vlen, ws, out, B, K, G, n_phys, ps, P, n_split, split_rows, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ws: 2 * B * K * n_split * G + B * K * n_split * G * D floats.
extern "C" int paged_decode_fwd(const void* q, const void* k_pool,
                                const void* v_pool, const void* bt,
                                const void* vlen, void* ws, void* out, int B,
                                int K, int G, int D, int n_phys, int ps,
                                int P, int n_split, int split_rows,
                                int dtype, void* stream) {
  if (G < 1 || G > GMAX || B < 1 || K < 1 || P < 1 || ps < 1 ||
      n_phys < 1 || n_split < 1 || split_rows < 1 ||
      (long long)n_split * split_rows < (long long)P * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k_pool, v_pool, bt, vlen, w, out, B,
                                     K, G, D, n_phys, ps, P, n_split,
                                     split_rows, st);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k_pool, v_pool, bt, vlen, w, out, B, K, G, D,
                             n_phys, ps, P, n_split, split_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
