// Split-T one-token decode attention (FlashDecoding), shared by the
// attend-only paged kernel (paged_decode.cu) and the contiguous kernel
// (decode_attention.cu).
//
// Pass 1: one block per (split, KV head, slot). The block serves all G
// query heads of its KV head over its own span of the slot's logical rows
// [s * split_rows, min((s + 1) * split_rows, valid_len)): q (G x D) sits in
// shared memory, and the block stages 32 rows of K/V for this head at a
// time in shared memory as f32 (rows at or past valid_len are staged as
// zeros, never read, so stale or garbage rows cannot leak into the sum).
// Each warp scores the 32 staged rows for one query head (one row per
// lane) and folds them into that head's running (max, sum) with warp
// shuffles; every thread then updates its share of the f32 (G x D)
// accumulator. The block writes its partial (m, l, acc) to a workspace.
//
// Pass 2: one block per (KV head, slot) combines the splits in split order
// (deterministic: no atomics) and writes acc / max(l, 1e-30), which is 0
// for a slot with nothing to attend, as the Pallas kernels give.
//
// Where a row of the slot lives is the caller's business: a functor maps
// logical row t to the element offset of its (row, head) vector of D.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode_split {

constexpr int NT = 128;   // threads per block (4 warps)
constexpr int TC = 32;    // rows staged per step: one per lane
constexpr int GMAX = 8;   // query heads per KV head

// Pass 1 body: partial attention of the G heads of q_head over rows
// [t0, t1) of one (slot, KV head); writes m, l (G each) and acc (G x D).
template <typename T, int D, typename RowOffset>
__device__ __forceinline__ void attend_span(
    const T* __restrict__ q_head, const T* __restrict__ k,
    const T* __restrict__ v, const RowOffset& row_offset, int G, int t0,
    int t1, float sm_scale, float* __restrict__ ws_m,
    float* __restrict__ ws_l, float* __restrict__ ws_acc) {
  constexpr int ACC = (GMAX * D + NT - 1) / NT;
  __shared__ float qs[GMAX][D];
  __shared__ float ks[TC][D + 1];  // padded: lanes read distinct banks
  __shared__ float vs[TC][D];
  __shared__ float prob[GMAX][TC];
  __shared__ float alpha_s[GMAX];
  __shared__ float m_s[GMAX];
  __shared__ float l_s[GMAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int e = tid; e < G * D; e += NT) qs[e / D][e % D] = to_f32(q_head[e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int c0 = t0; c0 < t1; c0 += TC) {
    const int rows = min(TC, t1 - c0);
    __syncthreads();  // the previous chunk is consumed; qs/m_s are set
    for (int e = tid; e < TC * D; e += NT) {
      const int r = e / D;
      const int d = e % D;
      float kk = 0.f, vv = 0.f;
      if (r < rows) {
        const size_t off = row_offset(c0 + r) + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[r][d] = kk;
      vs[r][d] = vv;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NT / 32) {
      const bool ok = lane < rows;
      float sv = kNegInf;
      if (ok) {
        float dot = 0.f;
#pragma unroll 8
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
  __syncthreads();
  if (tid < G) {
    ws_m[tid] = m_s[tid];
    ws_l[tid] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D) ws_acc[idx] = acc[i];
  }
}

// Pass 2: grid (K, B). Workspace layout, per (slot, KV head): n_split
// consecutive entries of G (m, l) and G x D (acc).
template <typename T>
__global__ void __launch_bounds__(NT) combine_kernel(
    const float* __restrict__ ws_m, const float* __restrict__ ws_l,
    const float* __restrict__ ws_acc, T* __restrict__ out, int K, int G,
    int D, int n_split) {
  const int bk = blockIdx.y * K + blockIdx.x;
  const float* m = ws_m + (size_t)bk * n_split * G;
  const float* l = ws_l + (size_t)bk * n_split * G;
  const float* a = ws_acc + (size_t)bk * n_split * G * D;
  T* o = out + (size_t)bk * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m[s * G + g]);
    float lsum = 0.f, acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(m[s * G + g] - mx);
      lsum += l[s * G + g] * w;
      acc += a[(size_t)s * G * D + idx] * w;
    }
    o[idx] = from_f32<T>(acc / fmaxf(lsum, 1e-30f));
  }
}

// Workspace pointers of split s of (slot b, KV head kh).
struct Workspace {
  float* m;
  float* l;
  float* acc;
  __device__ __forceinline__ void at(int b, int kh, int s, int K, int G,
                                     int D, int n_split, float** pm,
                                     float** pl, float** pa) const {
    const size_t e = ((size_t)b * K + kh) * n_split + s;
    *pm = m + e * G;
    *pl = l + e * G;
    *pa = acc + e * G * D;
  }
};

}  // namespace decode_split
}  // namespace repro
