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
// h / G, so K/V are never repeated. Key t is live for query row s iff
// t < valid_len and, when causal, t <= s + q_offset. Ragged S and T are
// masked here, so no shape needs padding.
//
// Two bodies, chosen by dtype and head dim (no fallback between them):
//
// * bf16, D in {64, 128}: flash_fwd_wgmma, on the tensor cores. One block
//   per (64-row query tile, q head, batch): one consumer warpgroup owns the
//   64 rows, one producer warp keeps TMA loads of 64-key K and V tiles in
//   flight through a 2-stage ring of 128-byte-swizzled shared memory (full
//   and empty mbarriers per stage). S = Q.K^T is a wgmma with both operands
//   in shared memory (bf16 in, f32 accumulators); the online softmax runs in
//   f32 registers in the accumulator layout; O += P.V is a wgmma with P from
//   registers (the S accumulator converts in place to the A fragment) and V
//   from shared memory through a transposed (MN-major) descriptor. Tiles
//   wholly past valid_len or above the causal diagonal are never loaded;
//   only edge and diagonal tiles apply the per-element mask.
//
//   Why P is split: chip_smoke.py's check_f32_ulps holds the bf16 result to
//   the plain version run in f32, within one bf16 ulp of each element plus
//   1e-5. Rounding P to bf16 before P.V (the textbook tensor-core flash)
//   misses that by 20-90x where the f32 result nearly cancels. So P is split
//   into hi = bf16(p) and lo = bf16(p - hi), and O += hi.V + lo.V: about 16
//   bits of p reach the product, and the check holds as with f32 P. The row
//   sum l adds the f32 p before the split. Q.K^T needs no split: bf16
//   products are exact in f32.
//
//   What bounds it on the H100: at llama's D = 64, S = T = 256 (B = 8)
//   bytes (each input read once: 0.0063 ms at 3.35 TB/s); at the vision
//   cross prefill (D = 128, G = 8, T = 1601) operations (0.109 ms at 989
//   TFLOP/s bf16, 0.163 ms with the split's third product).
//
// * f32, any D in {16, 32, 64, 128}: flash_fwd_simt, f32 products on the
//   CUDA cores (f32 is what the teacher-forced check and the reduced
//   configs send). Two threads own a
//   query row, each holding half of its D dims in registers with the f32
//   accumulator; the block walks KV tiles staged in shared memory.
//
// bf16 at D in {16, 32} is refused (cudaErrorInvalidValue; the wrapper
// raises first).
#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

using namespace repro;

namespace {

// ---------------------------------------------------------------------------
// f32 body: SIMT

constexpr int SIMT_BQ = 64;   // query rows per block
constexpr int SIMT_NT = 128;  // threads per block: two per query row
constexpr int SIMT_CH = 16;   // keys per online-softmax update

template <int D, int BK>
__global__ void __launch_bounds__(SIMT_NT) flash_fwd_simt(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int T_len,
    int K, int G, int q_offset, int valid_len, int causal, float sm_scale) {
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
  const int s = qt * SIMT_BQ + (tid >> 1);
  const bool row_ok = s < S;
  const int qpos = s + q_offset;

  float qr[HD];
  float acc[HD];
  const float* qrow = q + ((size_t)(b * S + (row_ok ? s : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    qr[i] = row_ok ? qrow[2 * i + half] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // keys this tile can see: [0, kv_end)
  int kv_end = valid_len;
  if (causal) {
    const int last = min(qt * SIMT_BQ + SIMT_BQ, S) - 1 + q_offset;
    kv_end = min(kv_end, last + 1);
  }
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * D; e += SIMT_NT) {
      const int t = e / D;
      const int d = e % D;
      const int tt = k0 + t;
      float kk = 0.f, vv = 0.f;
      if (tt < T_len) {
        const size_t off = ((size_t)(b * T_len + tt) * K + kh) * D + d;
        kk = k[off];
        vv = v[off];
      }
      ks[t][d] = kk;
      vs[t][d] = vv;
    }
    __syncthreads();
    const int nk = min(BK, kv_end - k0);
    for (int c0 = 0; c0 < nk; c0 += SIMT_CH) {
      float sc[SIMT_CH];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < SIMT_CH; ++j) {
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
      for (int j = 0; j < SIMT_CH; ++j) {
        sc[j] = expf(sc[j] - m_new);
        psum += sc[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        float a = acc[i] * alpha;
#pragma unroll
        for (int j = 0; j < SIMT_CH; ++j) a += sc[j] * vs[c0 + j][2 * i + half];
        acc[i] = a;
      }
      m = m_new;
    }
  }
  if (row_ok) {
    const float lsum = fmaxf(l, 1e-30f);
    float* orow = o + ((size_t)(b * S + s) * H + h) * D;
#pragma unroll
    for (int i = 0; i < HD; ++i) orow[2 * i + half] = acc[i] / lsum;
  }
}

template <int D>
void launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int T_len, int K, int G, int q_offset, int valid_len,
                 int causal, cudaStream_t stream) {
  constexpr int BK = D <= 64 ? 64 : 32;  // two f32 tiles stay under 48 KB
  const dim3 grid((S + SIMT_BQ - 1) / SIMT_BQ, K * G, B);
  flash_fwd_simt<D, BK><<<grid, SIMT_NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, K, G,
      q_offset, valid_len, causal, 1.0f / sqrtf(static_cast<float>(D)));
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma + TMA

constexpr int BQ = 64;              // query rows per block: one warpgroup
constexpr int BK = 64;              // keys per K/V tile
constexpr int NSTAGE = 2;           // K/V ring depth
constexpr int NCONS = 128;          // consumer threads (one warpgroup)
constexpr int NTHREADS = NCONS + 32;  // + one producer warp
constexpr int ROW_BYTES = 128;      // one 64-column bf16 TMA box row

// Shared memory of the D-wide body: Q, then the K ring, then the V ring,
// each a row of D/64 boxes of 64 columns (128-byte rows, 128-byte
// swizzle), each box 1024-byte aligned; the mbarriers last.
template <int D>
struct Smem {
  static constexpr int NB = D / 64;                     // boxes per row
  static constexpr int Q_BOX = BQ * ROW_BYTES;          // 8 KB
  static constexpr int KV_BOX = BK * ROW_BYTES;         // 8 KB
  static constexpr int Q = 0;
  static constexpr int K = Q + NB * Q_BOX;
  static constexpr int V = K + NSTAGE * NB * KV_BOX;
  static constexpr int BAR = V + NSTAGE * NB * KV_BOX;  // q, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NSTAGE);
  static constexpr int ALLOC = BYTES + 1024;            // to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n"
               " mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (layout
// type 1, B128) whose rows are 128 bytes apart: start address, then both
// byte offsets (16-byte units) at 1024, the step between 8-row groups. Each
// instruction here reads one 64-column box (K-major: a 16-column slice of
// it; MN-major: 16 of its rows), so the other offset of the two is unused,
// and setting both alike holds whichever one the mode reads.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) |
         (kGroup << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma registers across the
// asynchronous instructions.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

#define ACC32_OPS                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// d (64 x 64, f32) {=, +=} A (64 x 16, smem, K-major) . B (16 x 64, smem,
// K-major), bf16 inputs.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_OPS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major),
// bf16 inputs.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_OPS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    int S, int K, int G, int q_offset, int valid_len, int causal,
    float sm_scale) {
  using L = Smem<D>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q;
  const uint32_t sk = base + L::K;
  const uint32_t sv = base + L::V;
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * NSTAGE;    // + 8 * stage

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = K * G;
  const int kh = h / G;
  const int s0 = qt * BQ;
  // keys this tile can see: [0, kv_end); kv_end >= 1 (valid_len >= 1)
  int kv_end = valid_len;
  if (causal) kv_end = min(kv_end, min(s0 + BQ, S) + q_offset);
  const int n_tiles = (kv_end + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // producer warp: one thread issues every TMA load of the block
    if (tid == NCONS) {
      mbar_expect_tx(bar_q, NB * L::Q_BOX);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load_4d(sq + j * L::Q_BOX, &qmap, bar_q, j * 64, h, s0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTAGE;
        // the consumers released this stage's previous tile (the first
        // round passes at once: parity 1 of a fresh barrier is complete)
        mbar_wait(bar_empty + 8 * st, ((it / NSTAGE) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * NB * L::KV_BOX);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t off = (st * NB + j) * L::KV_BOX;
          tma_load_4d(sk + off, &kmap, full, j * 64, kh, it * BK, b);
          tma_load_4d(sv + off, &vmap, full, j * 64, kh, it * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: warp w owns rows 16w + g and 16w + g + 8 of the
  // tile (g = lane / 4); lane % 4 picks the column pairs of the wgmma
  // accumulator layout.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int row0 = s0 + warp * 16 + (lane >> 2);

  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NSTAGE;
    const int k0 = it * BK;
    mbar_wait(bar_full + 8 * st, (it / NSTAGE) & 1);

    // S = Q . K^T over D in steps of 16 (32 bytes inside a 128-byte row)
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int j = kk / 4;
      const uint32_t col = (kk % 4) * 32;
      const uint64_t da = desc_b128(sq + j * L::Q_BOX + col);
      const uint64_t db = desc_b128(sk + (st * NB + j) * L::KV_BOX + col);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    // scale and mask: sc[4 * j8 + 2 * r + e] is (row0 + 8 r, key
    // k0 + 8 j8 + 2 c + e)
    const bool edge = k0 + BK > valid_len ||
                      (causal && k0 + BK - 1 > s0 + q_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= sm_scale;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = k0 + 8 * (i / 4) + 2 * c + (i & 1);
        const int row = row0 + 8 * ((i / 2) & 1);
        if (t >= valid_len || (causal && t > row + q_offset)) sc[i] = kNegInf;
      }
    }
    // online softmax, f32: row max over the quad that shares a row
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        mx = fmaxf(mx, sc[4 * j8 + 2 * r]);
        mx = fmaxf(mx, sc[4 * j8 + 2 * r + 1]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = expf(m[r] - mx);
      m[r] = mx;
      float psum = 0.f;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        float& p0 = sc[4 * j8 + 2 * r];
        float& p1 = sc[4 * j8 + 2 * r + 1];
        p0 = expf(p0 - mx);
        p1 = expf(p1 - mx);
        psum += p0 + p1;
      }
      l[r] = l[r] * alpha[r] + psum;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i / 2) & 1];

    // P as two bf16 halves in the A-fragment layout: register r of key
    // slice kk holds sc[8 kk + 2 r], sc[8 kk + 2 r + 1]
    uint32_t p_hi[BK / 16][4];
    uint32_t p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[8 * kk + 2 * r];
        const float x1 = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[kk][r] = pack_bf16(hi);
        p_lo[kk][r] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }

    // O += P_hi . V + P_lo . V; V is MN-major: 16 keys = 2048 bytes
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint64_t db = desc_b128(sv + (st * NB + j) * L::KV_BOX +
                                      kk * 16 * ROW_BYTES);
        wgmma_rs(acc[j], p_hi[kk], db);
        wgmma_rs(acc[j], p_lo[kk], db);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
    mbar_arrive(bar_empty + 8 * st);
  }

  // epilogue: o = acc / max(l, 1e-30), rows past S never stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float lsum = fmaxf(lr, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + ((size_t)(b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int d = 64 * j + 8 * j8 + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[j][4 * j8 + 2 * r] / lsum, acc[j][4 * j8 + 2 * r + 1] / lsum);
      }
  }
}

// cuTensorMapEncodeTiled from libcuda.so.1, which PyTorch has already
// loaded into the process, so this library links no libcuda itself.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A bf16 tensor map over a contiguous (n3, n2, n1, n0) array, dims
// innermost first, with boxes of {64, 1, rows, 1}, 128-byte swizzle, and
// zeros for rows past n2 (never the next n3 index).
bool make_map(CUtensorMap* map, const void* ptr, uint64_t n0, uint64_t n1,
              uint64_t n2, uint64_t n3, uint32_t rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {n0, n1, n2, n3};
  const cuuint64_t strides[3] = {n0 * 2, n0 * n1 * 2, n0 * n1 * n2 * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int T_len, int K, int G, int q_offset, int valid_len,
                 int causal, cudaStream_t stream) {
  // TMA takes 16-byte-aligned base addresses (the strides are multiples of
  // D * 2 bytes)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, D, K * G, S, B, BQ) ||
      !make_map(&km, k, D, K, T_len, B, BK) ||
      !make_map(&vm, v, D, K, T_len, B, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, K * G, B);
  flash_fwd_wgmma<D><<<grid, NTHREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, K, G, q_offset,
      valid_len, causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int T_len, int K, int G, int D,
                                   int q_offset, int valid_len, int causal,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    switch (D) {
      case 64: return launch_wgmma<64>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, st);
      case 128: return launch_wgmma<128>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: launch_simt<16>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, st); break;
    case 32: launch_simt<32>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, st); break;
    case 64: launch_simt<64>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, st); break;
    case 128: launch_simt<128>(q, k, v, o, B, S, T_len, K, G, q_offset, valid_len, causal, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory per block of the bf16 wgmma body at head dim D
// (0 where that body does not run), for the build report.
extern "C" int flash_attention_wgmma_smem_bytes(int D) {
  switch (D) {
    case 64: return Smem<64>::ALLOC;
    case 128: return Smem<128>::ALLOC;
    default: return 0;
  }
}
