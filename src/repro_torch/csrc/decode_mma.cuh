// Split-KV one-token decode attention on the tensor cores (bf16): the bf16
// body of the three decode kernels, contiguous (decode_attention.cu), fused
// paged (fused_paged_decode.cu) and attend-only paged (paged_decode.cu).
// Their f32 bodies run the SIMT body of decode_split.cuh, which also holds
// the fold of the spans that both bodies of every kernel end in.
//
// One block (4 warps) per (span, KV head, slot) serves the G <= 16 query
// heads of its KV head over the span's rows [t0, t1). The host cuts the
// rows into at most MAX_SPLIT spans from sizes it knows (no read of pos or
// lengths), so the grid fills the card; a span that starts at or past the
// slot's length has nothing to attend. The spans of one (slot, KV head)
// form a thread-block cluster and fold their partials through distributed
// shared memory (decode_split.cuh fold_cluster): one launch, no workspace.
//
// - Bytes in flight: the span's rows arrive in tiles of 64 rows through
//   16-byte cp.async copies into a ring of STAGES tiles in shared memory,
//   the next tile's copies issued before the current tile is consumed.
//   Rows stay bf16 (16-byte chunks XOR-swizzled by row, so that ldmatrix
//   reads hit distinct banks); rows past the span are zero-filled without
//   a read, so stale or garbage rows cannot reach the sum.
// - Scores on the tensor cores: each warp owns 16 rows of every tile and
//   runs S = Q.K^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate): q is
//   the A operand (rows 0-7 = heads 0-7, zeros past G; rows 8-15 zero at
//   R = 8, heads 8-15 at R = 16), K rows the B operand through ldmatrix, 8
//   rows per n tile.
// - Online softmax in f32 registers, per head, over the warp's rows.
// - O = P.V on the tensor cores: the S accumulator is already laid out as
//   P's A operand (the flash-attention-2 register reuse). P is split into
//   bf16 hi = bf16(p) and lo = bf16(p - hi). At R = 8 the padding rows 8-15
//   of A carry lo: one mma gives hi.V in accumulator rows 0-7 and lo.V in
//   rows 8-15, added at the end. At R = 16 rows 8-15 are heads, so hi and
//   lo go through two mmas into one accumulator. (P rounded to bf16 alone
//   misses the f32 rule by far; the split keeps about 16 bits of p.) V
//   comes through ldmatrix.trans.
// - The block folds its 4 warps' (m, l, acc) in shared memory in warp order
//   into its span's partial.
// - Rows of D = 96 (phi3-mini) are 12 chunks of 16 bytes; a tile row is
//   laid out at the next power of two (128 columns), so that the XOR
//   swizzle of a chunk index stays inside its row.
//
// What bounds it on the H100: one pass over the live K/V rows (2 * rows * D
// bf16 per slot and head) for 4 * G * D flops per row: 8 flops per byte at
// G = 8, far below the ridge point, so bound by bytes; the tensor cores keep
// the flops off the SIMT pipes and out of shared-memory staging.
#pragma once

#include "decode_split.cuh"

namespace repro {
namespace decode_mma {

constexpr int NT = 128;     // threads per block: 4 warps
constexpr int TR = 64;      // rows per tile: 16 per warp
constexpr int STAGES = 2;   // tiles in flight per block

using bf16 = __nv_bfloat16;

template <int D>
struct Layout {
  static_assert(D == 64 || D == 96 || D == 128, "head dims of the body");
  static constexpr int kPitch = D > 64 ? 128 : 64;  // elements a tile row
  static constexpr int kTile = TR * kPitch * 2;  // bytes of one K or V tile
  static constexpr int kStage = 2 * kTile;       // K, then V
  static constexpr int kBytes = STAGES * kStage;
  static constexpr int kAccStride = D + 4;       // floats per combine row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 zero-fills, reading
// nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (p0, p1) as bf16x2 hi = bf16(p) and lo = bf16(p - hi), p0 in the low half
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - __low2float(h),
                                                 p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// byte offset of 16-byte chunk c of row r in a tile of rows of D bf16,
// laid out at Layout<D>::kPitch (c ^ (r & 7) < kPitch / 8: a power of two
// of at least 8 chunks)
template <int D>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return r * (Layout<D>::kPitch * 2) + ((c ^ (r & 7)) << 4);
}

// Partial attention of the G <= R heads of q_head over rows [t0, t1) of
// one (slot, KV head); row t's D elements lie at k/v + row_offset(t),
// except row t_new (if any), which is read from k_new / v_new. Writes the
// span's partial: m, l (G each) and, for a span with rows, acc (G x D).
// smem: Layout<D>::kBytes of dynamic shared memory, 16-byte aligned.
template <int D, int R, typename RowOffset>
__device__ __forceinline__ void attend_span_mma(
    const bf16* __restrict__ q_head, const bf16* k, const bf16* v,
    const RowOffset& row_offset, int G, int t0, int t1, float sm_scale,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, unsigned char* smem, int t_new,
    const bf16* k_new, const bf16* v_new) {
  using L = Layout<D>;
  static_assert(R == 8 || R == 16, "one or two heads a fragment row");
  static_assert(2 * 4 * R * 4 + 4 * R * L::kAccStride * 4 <= L::kBytes,
                "the warp combine reuses the ring");
  constexpr int NH = R / 8;    // heads a thread holds: gr (and gr + 8)
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KS = D / 16;   // k steps of S = Q.K^T
  constexpr int ND = D / 8;    // n tiles (8 columns of d) of O = P.V
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;    // fragment row: query head (A), row (B)
  const int qc = lane & 3;     // fragment column pair
  if (t0 >= t1) {
    if (tid < G) {
      part_m[tid] = kNegInf;
      part_l[tid] = 0.f;
    }
    return;
  }
  const uint32_t sbase = smem_u32(smem);
  const int n_tiles = (t1 - t0 + TR - 1) / TR;

  // chunk e of a tile: row e / CH, column e % CH (TR * CH is a multiple
  // of NT at every D)
  auto issue = [&](int it) {
    const uint32_t st = sbase + (it % STAGES) * L::kStage;
    const int base = t0 + it * TR;
#pragma unroll
    for (int e = tid; e < TR * CH; e += NT) {
      const int r = e / CH;
      const int c = e % CH;
      const int t = base + r;
      const bool ok = t < t1;
      const bf16* kr;
      const bf16* vr;
      if (t == t_new) {
        kr = k_new;
        vr = v_new;
      } else {
        const size_t off = row_offset(ok ? t : t0);
        kr = k + off;
        vr = v + off;
      }
      const uint32_t off = chunk_off<D>(r, c);
      cp_async16(st + off, kr + c * 8, ok ? 16 : 0);
      cp_async16(st + L::kTile + off, vr + c * 8, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0);

  // q as the A operand of S: a0 / a2 hold head gr's d pairs of k step kk,
  // a1 / a3 head gr + 8's (zeros at R = 8)
  uint32_t qa[KS][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q_head);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = gr + 8 * h;
        const bool ok = h < NH && g < G;
        qa[kk][h] = ok ? q32[(g * D + kk * 16 + 2 * qc) / 2] : 0u;
        qa[kk][2 + h] = ok ? q32[(g * D + kk * 16 + 8 + 2 * qc) / 2] : 0u;
      }
  }

  // rows 0-7: head gr; rows 8-15: lo.V of head gr (R = 8) or head gr + 8
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[NH];  // head gr (+ 8 h)'s running max over this warp's rows
  float l_run[NH];  // its running sum, this thread's 4 rows of 16
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    m_run[h] = kNegInf;
    l_run[h] = 0.f;
  }

  const int r0 = warp * 16;    // this warp's rows in each tile
  const int mat = lane >> 3;   // ldmatrix: the 8x8 matrix this lane addresses
  const int mr = lane & 7;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles)
      issue(it + 1);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();      // every thread's copies of tile `it` have landed
    const uint32_t kt = sbase + (it % STAGES) * L::kStage;
    const uint32_t vt = kt + L::kTile;

    // S = Q.K^T over the warp's 16 rows: n tile j holds rows 8j .. 8j + 7;
    // s[j][2h + e] is head gr + 8h at row 8j + 2qc + e
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int r = r0 + (mat >> 1) * 8 + mr;
      uint32_t b[4];
      ldsm_x4(b, kt + chunk_off<D>(r, 2 * kk + (mat & 1)));
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
    }

    // online softmax of each head over rows 2qc, 2qc + 1, 8 + 2qc, 9 + 2qc
    const int tb = t0 + it * TR + r0 + 2 * qc;
    const bool live[4] = {tb < t1, tb + 1 < t1, tb + 8 < t1, tb + 9 < t1};
    float p[NH][4];
    float alpha[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float x[4] = {s[0][2 * h] * sm_scale, s[0][2 * h + 1] * sm_scale,
                          s[1][2 * h] * sm_scale, s[1][2 * h + 1] * sm_scale};
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (live[i]) mx = fmaxf(mx, x[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = expf(m_run[h] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[h][i] = live[i] ? expf(x[i] - m_new) : 0.f;
        psum += p[h][i];
      }
      l_run[h] = l_run[h] * alpha[h] + psum;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[NH - 1];
      o[n][3] *= alpha[NH - 1];
    }

    // O += P.V. R = 8: A rows 0-7 = bf16 hi of p, rows 8-15 = bf16 lo, one
    // mma. R = 16: rows 0-7 head gr, rows 8-15 head gr + 8; hi, then lo.
    uint32_t a[4], a_lo[4];
    if constexpr (NH == 1) {
      split_bf16(p[0][0], p[0][1], a[0], a[1]);
      split_bf16(p[0][2], p[0][3], a[2], a[3]);
    } else {
      split_bf16(p[0][0], p[0][1], a[0], a_lo[0]);
      split_bf16(p[1][0], p[1][1], a[1], a_lo[1]);
      split_bf16(p[0][2], p[0][3], a[2], a_lo[2]);
      split_bf16(p[1][2], p[1][3], a[3], a_lo[3]);
    }
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {
      const int r = r0 + (mat & 1) * 8 + mr;
      uint32_t b[4];
      ldsm_x4_trans(b, vt + chunk_off<D>(r, 2 * np + (mat >> 1)));
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      if constexpr (NH == 2) {
        mma_bf16(o[2 * np], a_lo, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a_lo, b[2], b[3]);
      }
    }
    __syncthreads();  // tile `it` is consumed: its stage may be refilled
  }
  cp_async_wait<0>();

  // fold the 4 warps in warp order (the ring is free: every tile consumed)
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  float* cm = reinterpret_cast<float*>(smem);  // [4][R] maxima
  float* cl = cm + 4 * R;                      // [4][R] sums
  float* ca = cl + 4 * R;                      // [4][R][kAccStride] acc
  if (qc == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      cm[warp * R + gr + 8 * h] = m_run[h];
      cl[warp * R + gr + 8 * h] = l_run[h];
    }
  }
  float* cw = ca + (warp * R + gr) * L::kAccStride + 2 * qc;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if constexpr (NH == 1) {
      *reinterpret_cast<float2*>(cw + n * 8) =
          make_float2(o[n][0] + o[n][2], o[n][1] + o[n][3]);
    } else {
      *reinterpret_cast<float2*>(cw + n * 8) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(cw + 8 * L::kAccStride + n * 8) =
          make_float2(o[n][2], o[n][3]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, cm[w * R + g]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float e = expf(cm[w * R + g] - mx);
      lsum += cl[w * R + g] * e;
      acc += ca[(w * R + g) * L::kAccStride + d] * e;
    }
    part_acc[idx] = acc;
    if (d == 0) {
      part_m[g] = mx;
      part_l[g] = lsum;
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel and device;
// asked once per device for each kernel.
template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  static unsigned done = 0;  // devices opted in, one bit each
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 32 && (done >> dev) & 1u)) return e;
  e = cudaFuncSetAttribute(kKernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

}  // namespace decode_mma
}  // namespace repro
