// Causal GQA flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel), reached through
// repro.kernels.ops.flash_attention_grouped.
//
// Layout: q and o in the model layout (B, S, K, G, D), k and v in
// (B, T, K, D), all contiguous; the kernel reads them through their strides,
// so neither the (B, H, S, D) transpose of q nor the (B, K, T, D) transpose of
// k/v that the Pallas adapter makes is needed. The KV head of q head h is
// h / G, so K/V are never repeated.
//
// Grid: one block per (q tile of 64 rows, q head, batch). Two threads own a
// query row, each holding half of its D dims (interleaved, d = 2*i + half) in
// registers with the f32 accumulator; the pair combines its partial dot
// products with one shuffle. The block walks KV tiles of BK rows staged in
// shared memory as f32, scoring 16 keys at a time and updating the running
// (max, sum, acc) of the online softmax in f32, as _flash_kernel does. The
// probabilities stay f32 through the PV product (the Pallas body does the
// same; the plain version casts them to q.dtype first).
//
// Masking: key t is live for query row s iff t < valid_len and, when causal,
// t <= s + q_offset. Tiles wholly past valid_len or above the diagonal are
// skipped. Unlike the Pallas kernel, ragged edges (S or T not a multiple of
// the tile) are masked here, so no shape needs padding.
//
// What bounds it on the H100: at prefill widths (S = T = a few hundred, D =
// 64) the work is 4*S*T*D/2 flops per head against S*D + T*D elements read,
// so it is bound by operations. This first version does its products on the
// f32 SIMT pipes (67 TFLOP/s peak), not the bf16 tensor cores (989 TFLOP/s);
// mma.sync/wgmma and TMA staging are the next step for speed.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int NT = 128;  // threads per block: two per query row
constexpr int CH = 16;   // keys per online-softmax update

template <typename T, int D, int BK>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int T_len, int K,
    int G, int q_offset, int valid_len, int causal, float sm_scale) {
  constexpr int HD = D / 2;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int H = K * G;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int s = qt * BQ + (tid >> 1);
  const bool row_ok = s < S;
  const int qpos = s + q_offset;

  float qr[HD];
  float acc[HD];
  const T* qrow = q + ((size_t)(b * S + (row_ok ? s : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    qr[i] = row_ok ? to_f32(qrow[2 * i + half]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // keys this tile can see: [0, kv_end)
  int kv_end = valid_len;
  if (causal) {
    const int last = min(qt * BQ + BQ, S) - 1 + q_offset;
    kv_end = min(kv_end, last + 1);
  }
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int t = e / D;
      const int d = e % D;
      const int tt = k0 + t;
      float kk = 0.f, vv = 0.f;
      if (tt < T_len) {
        const size_t off = ((size_t)(b * T_len + tt) * K + kh) * D + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[t][d] = kk;
      vs[t][d] = vv;
    }
    __syncthreads();
    const int nk = min(BK, kv_end - k0);
    for (int c0 = 0; c0 < nk; c0 += CH) {
      float sc[CH];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int t = c0 + j;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < HD; ++i) part += qr[i] * ks[t][2 * i + half];
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        const int tt = k0 + t;
        const bool ok = tt < valid_len && (!causal || tt <= qpos);
        const float sv = ok ? part * sm_scale : kNegInf;
        sc[j] = sv;
        mc = fmaxf(mc, sv);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        sc[j] = expf(sc[j] - m_new);
        psum += sc[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        float a = acc[i] * alpha;
#pragma unroll
        for (int j = 0; j < CH; ++j) a += sc[j] * vs[c0 + j][2 * i + half];
        acc[i] = a;
      }
      m = m_new;
    }
  }
  if (row_ok) {
    const float lsum = fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)(b * S + s) * H + h) * D;
#pragma unroll
    for (int i = 0; i < HD; ++i) orow[2 * i + half] = from_f32<T>(acc[i] / lsum);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int S, int T_len, int K, int G, int q_offset, int valid_len,
            int causal, cudaStream_t stream) {
  constexpr int BK = D <= 64 ? 64 : 32;  // two f32 tiles stay under 48 KB
  const dim3 grid((S + BQ - 1) / BQ, K * G, B);
  flash_fwd_kernel<T, D, BK><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, K, G, q_offset,
      valid_len, causal, 1.0f / sqrtf(static_cast<float>(D)));
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int S, int T_len, int K, int G, int D, int q_offset,
               int valid_len, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, stream); break;
    case 32: launch<T, 32>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, stream); break;
    case 64: launch<T, 64>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, stream); break;
    case 128: launch<T, 128>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int T_len, int K, int G, int D,
                                   int q_offset, int valid_len, int causal,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, T_len, K, G, D,
                                     q_offset, valid_len, causal, st);
  if (dtype == kFloat32)
    return dispatch_d<float>(q, k, v, o, B, S, T_len, K, G, D, q_offset,
                             valid_len, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
