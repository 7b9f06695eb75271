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
// Grid: one block per (slot, KV head). The block serves all G query heads of
// its KV head: q (G x D) sits in shared memory, and the block walks the
// slot's live pages in order, 32 page rows at a time, staging their K/V rows
// for this head in shared memory as f32. Its own new row is taken from the
// k_new/v_new inputs when the write page is staged, so the score pass sees
// it without a round trip through device memory. Each warp scores the 32
// staged rows for one query head (one row per lane), folds them into that
// head's running (max, sum) with warp shuffles, and every thread then updates
// its share of the f32 (G x D) accumulator. Rows at or past valid_len get
// probability exactly zero.
//
// Pool contract (the serving engine's kernel layout, as for the Pallas
// kernel): the pool carries one trash page at index n_phys - 1, equal to the
// block table's sentinel, and a page that a slot writes is private to that
// slot. So no two live slots write one page, and an inactive slot (all-
// sentinel row) writes its garbage row into the trash page. Several inactive
// slots may scribble on the trash page at once; that is harmless because no
// live slot reads a trash-page row without masking it (its positions lie at
// or past the slot's valid length), and what an inactive slot computes is
// discarded.
//
// What bounds it on the H100: one pass over each slot's live KV pages
// (2 * valid_len * K * D elements) for 4 * G * D flops per position, far
// below the card's ridge point: it is bound by bytes. The design reads each
// live page row once, in coalesced rows of D elements, and never
// materialises the gathered (B, P * ps, K, D) view that the plain version
// builds. Known limit: at B = 8 slots and K = 8 heads it launches 64 blocks
// on 132 SMs; splitting each slot's pages across blocks (FlashDecoding) is
// later work.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int NT = 128;  // threads per block (4 warps)
constexpr int TC = 32;   // page rows staged per step: one per lane
constexpr int DMAX = 128;
constexpr int GMAX = 8;
constexpr int ACC = GMAX * DMAX / NT;  // accumulator entries per thread

template <typename T>
__global__ void __launch_bounds__(NT) fused_paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_pool, T* v_pool,
    const int* __restrict__ bt, const int* __restrict__ pos_arr,
    T* __restrict__ out, int K, int G, int D, int n_phys, int ps, int P,
    float sm_scale) {
  __shared__ float qs[GMAX][DMAX];
  __shared__ float ks[TC][DMAX + 1];  // padded: lanes read distinct banks
  __shared__ float vs[TC][DMAX];
  __shared__ float prob[GMAX][TC];
  __shared__ float alpha_s[GMAX];
  __shared__ float m_s[GMAX];
  __shared__ float l_s[GMAX];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = pos_arr[b];
  const int valid_len = pos + 1;
  const int wblk = min(max(pos / ps, 0), P - 1);
  const int woff = pos % ps;
  const int* bt_row = bt + (size_t)b * P;
  const int wpage = min(max(bt_row[wblk], 0), n_phys - 1);
  const size_t row_stride = (size_t)K * D;
  const size_t page_stride = (size_t)ps * row_stride;
  const T* kn = k_new + ((size_t)b * K + kh) * D;
  const T* vn = v_new + ((size_t)b * K + kh) * D;

  // the write: a bit copy of the new row into its page, in place
  for (int d = tid; d < D; d += NT) {
    const size_t off = (size_t)wpage * page_stride + (size_t)woff * row_stride +
                       (size_t)kh * D + d;
    k_pool[off] = kn[d];
    v_pool[off] = vn[d];
  }
  const T* qb = q + ((size_t)b * K + kh) * G * D;
  for (int e = tid; e < G * D; e += NT) qs[e / D][e % D] = to_f32(qb[e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int n_live = min(P, (valid_len + ps - 1) / ps);
  for (int j = 0; j < n_live; ++j) {
    const int page = min(max(bt_row[j], 0), n_phys - 1);
    const bool is_w = j == wblk;
    for (int r0 = 0; r0 < ps; r0 += TC) {
      const int t0 = j * ps + r0;
      if (t0 >= valid_len) break;
      const int rows = min(TC, ps - r0);
      __syncthreads();  // the previous chunk is consumed; qs/m_s are set
      for (int e = tid; e < rows * D; e += NT) {
        const int r = e / D;
        const int d = e % D;
        const int rr = r0 + r;
        float kk, vv;
        if (is_w && rr == woff) {
          kk = to_f32(kn[d]);
          vv = to_f32(vn[d]);
        } else {
          const size_t off = (size_t)page * page_stride +
                             (size_t)rr * row_stride + (size_t)kh * D + d;
          kk = to_f32(k_pool[off]);
          vv = to_f32(v_pool[off]);
        }
        ks[r][d] = kk;
        vs[r][d] = vv;
      }
      __syncthreads();
      for (int g = warp; g < G; g += NT / 32) {
        const bool ok = lane < rows && t0 + lane < valid_len;
        float sv = kNegInf;
        if (ok) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += qs[g][d] * ks[lane][d];
          sv = dot * sm_scale;
        }
        float mc = sv;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, w));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mc);
        const float p = ok ? expf(sv - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, w);
        prob[g][lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          alpha_s[g] = a;
          l_s[g] = l_s[g] * a + psum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int idx = tid + i * NT;
        if (idx < G * D) {
          const int g = idx / D;
          const int d = idx % D;
          float a = acc[i] * alpha_s[g];
          for (int r = 0; r < rows; ++r) a += prob[g][r] * vs[r][d];
          acc[i] = a;
        }
      }
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * K + kh) * G * D;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D) ob[idx] = from_f32<T>(acc[i] / fmaxf(l_s[idx / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const void* bt, const void* pos, void* out, int B,
           int K, int G, int D, int n_phys, int ps, int P,
           cudaStream_t stream) {
  if (G > GMAX || D > DMAX || G * D > NT * ACC || B < 1 || K < 1 || P < 1 ||
      ps < 1 || n_phys < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, K);
  fused_paged_decode_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pool),
      static_cast<T*>(v_pool), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<T*>(out), K, G, D, n_phys,
      ps, P, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_paged_decode_fwd(const void* q, const void* k_new,
                                      const void* v_new, void* k_pool,
                                      void* v_pool, const void* bt,
                                      const void* pos, void* out, int B,
                                      int K, int G, int D, int n_phys,
                                      int ps, int P, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_pool, v_pool, bt, pos,
                                 out, B, K, G, D, n_phys, ps, P, st);
  if (dtype == kFloat32)
    return launch<float>(q, k_new, v_new, k_pool, v_pool, bt, pos, out, B, K,
                         G, D, n_phys, ps, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
