// Weight-only int8 GEMM (W8A16 / W8A32), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py
// (int8_matmul / _int8_mm_kernel), reached through
// repro.models.quantize.qeinsum on the int8 variant's projections.
//
// out (M, N) f32 = (x (M, Kd) @ w_q (Kd, N) int8) * scales (N,):
// accumulate-then-scale in f32, the scale applied once in the epilogue, as
// the Pallas body does. x is bf16 or f32 and read in its own dtype; w_q is
// row-major (N contiguous), as the JAX package lays it out. Ragged M, N and
// Kd edges are masked in the loads and the store; nothing is padded.
//
// Two bodies, one launch per call, both on the tensor cores; the
// wrapper's int8_body(M, dtype) names the one a call runs. What they share:
// - An int8 value is exact in bf16, so each bf16 x bf16 product is exact in
//   f32. Bytes widen by a byte permute into the mantissa of 2^23 and one
//   subtraction (exact, no int-to-float conversion unit).
// - f32 x is split into three bf16 terms, hi + mid + lo == x exactly (hi
//   and mid are truncations, so nothing overflows; exact for |x| >=
//   2^-110, below which bits under bf16's smallest subnormal, 2^-133, are
//   lost), and each k step runs one product per term. Nothing rounds x to
//   bf16 or TF32.
// - The tensor cores' f32 accumulator truncates: carried over all of Kd it
//   drifts tens of f32 ulps from an f32 sum. So each chain of products
//   covers a short span of k only (64 rows in int8_gemv, 128 in int8_mma)
//   and starts from 0, and its sum joins the running total through an
//   ordinary f32 add. The result then differs from the f32 plain version
//   only in how the f32 sums are taken.
//
// int8_gemv, M <= 16 (decode: the rows are the batch slots), is bound by
// the weight bytes it streams (16.7 MB at 2048 x 8192: 5 us at 3.35
// TB/s). Block (bx, r) of a (ceil(N / BN), cs) grid takes BN columns over
// a 1/cs share of Kd; the cs blocks of a column form a thread-block
// cluster. A producer warp keeps a ring of 16 KB weight tiles in flight
// (one TMA box each, swizzled so that ldmatrix reads hit distinct banks);
// 8 consumer warps read each tile with ldmatrix.trans, as if two
// neighbouring bytes were one 16-bit element: each register then holds two
// k rows of two neighbouring columns, which widen into the B fragments of
// two mma.sync.m16n8k16 tiles, one over the even and one over the odd
// columns (the epilogue puts them back in order). x (M <= 16 rows, zero
// rows up to 16) is staged once per block and is the A operand. The
// consumers never wait for each other inside the stream: full and empty
// mbarriers pace them against the producer. At the end the block adds its
// warps' partial sums in a fixed order, and the cluster's blocks add the
// cs block partials in rank order through distributed shared memory,
// scale and store: deterministic, no workspace, no second launch.
//
// int8_mma, M > 16 (prefill: M = admitted requests x prompt bucket), is
// bound by operations at M = 2048 (2 M N Kd against a few MB): wgmma
// m64n128k16 over 128 x 128 output tiles, two consumer warpgroups of 64
// rows. A producer warp issues the TMA boxes of x (128-byte swizzled: the
// wgmma layout) and w_q into a ring of 64-deep k tiles; the consumers
// widen each int8 tile to bf16 (and split f32 x) into one of two buffers
// while the tensor cores run the last tile, with one tile's wgmmas always
// in flight.
// Shapes whose rows are not 16-byte aligned (TMA cannot describe them) load
// their tiles element by element through the same rings; the main paths
// never take that path.
#include <cooperative_groups.h>
#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // both bodies
constexpr int kMaxGemvM = 16;

// --- int8 -> f32 / bf16 widening (exact) -----------------------------------

// the four int8 of `r`, as floats: the byte, biased to unsigned, becomes the
// low mantissa byte of 2^23, and 2^23 + 128 comes off again
__device__ __forceinline__ void widen4(uint32_t r, float f[4]) {
  const uint32_t u = r ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// two floats whose low 16 bits are zero (bf16 values) packed as bf16x2:
// `lo` in the low half
__device__ __forceinline__ uint32_t pack_hi16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// --- copies, ldmatrix, mma ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of four m16n8k16 tiles from one ldmatrix.x4.trans of int8
// rows read as 16-bit elements: matrices (k 0-7 | 8-15) x (columns 0-15 |
// 16-31) of a 16 x 32 byte block. Each register's bytes are (k, 2j)
// (k, 2j + 1) (k + 1, 2j) (k + 1, 2j + 1): tile 2p takes the even, tile
// 2p + 1 the odd columns of column group p.
__device__ __forceinline__ void widen_b(const uint32_t rb[4],
                                        uint32_t bf[4][2]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float top[4], bot[4];  // k rows 0-7 and 8-15
    widen4(rb[2 * p], top);
    widen4(rb[2 * p + 1], bot);
    bf[2 * p][0] = pack_hi16(top[0], top[2]);
    bf[2 * p][1] = pack_hi16(bot[0], bot[2]);
    bf[2 * p + 1][0] = pack_hi16(top[1], top[3]);
    bf[2 * p + 1][1] = pack_hi16(bot[1], bot[3]);
  }
}

// f32 (x0, x1) as three bf16x2 terms, hi + mid + lo == x exactly
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const float r0 = x0 - trunc_bf16(x0);
  const float r1 = x1 - trunc_bf16(x1);
  hi = pack_hi16(x0, x1);
  mid = pack_hi16(r0, r1);
  lo = pack_hi16(r0 - trunc_bf16(r0), r1 - trunc_bf16(r1));
}

// --- barriers and TMA -------------------------------------------------------

constexpr int kMmaThreads = kThreads + 32;  // + one producer warp

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 2-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// a barrier of the 256 consumer threads only (not the producer warp)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// --- int8_gemv --------------------------------------------------------------

constexpr int kGemvTileBytes = 16 << 10;  // one ring stage of weights
constexpr int kGemvStages = 4;            // three stages in flight
constexpr int kGemvMaxTileK = 256;        // rows of the narrowest tile

// weight rows per stage of a BN-wide tile: 256 or 128, so that every warp
// runs 4 k steps of 16 per stage whatever BN
__host__ __device__ constexpr int gemv_tile_k(int bn) {
  return kGemvTileBytes / bn;
}

// bytes added to each staged x row, so that the 8 rows one fragment load
// reads fall in distinct banks
__host__ __device__ constexpr int gemv_x_pad(int x_bytes) {
  return x_bytes == 2 ? 16 : 32;
}

// Byte offset of 16-byte chunk c of weight row k in a BN-wide ring stage:
// TMA's 64-byte (BN = 64) or 128-byte (BN = 128) swizzle, which puts the 8
// rows that one ldmatrix reads into distinct banks.
template <int BN>
__device__ __forceinline__ int w_off(int k, int c) {
  return k * BN + ((c ^ (BN == 64 ? (k >> 1) & 3 : k & 7)) << 4);
}

// Weight rows [row0, row0 + TK) x columns [n0, n0 + BN) into a ring stage
// element by element (lane of 32), zero past row_end and N: the path for
// shapes that TMA cannot describe (N not a multiple of 16).
template <int BN>
__device__ __forceinline__ void gemv_fill_tile(unsigned char* dst,
                                               const int8_t* __restrict__ w,
                                               int N, int row0, int row_end,
                                               int n0, int lane) {
  constexpr int TK = gemv_tile_k(BN);
  for (int i = lane; i < TK * BN; i += 32) {
    const int kr = i / BN;
    const int n = i % BN;
    const int gk = row0 + kr;
    dst[w_off<BN>(kr, n / 16) + n % 16] =
        (gk < row_end && n0 + n < N)
            ? static_cast<unsigned char>(w[(size_t)gk * N + n0 + n])
            : 0;
  }
}

// grid (ceil(N / BN), cs), cluster (1, cs, 1); 288 threads: 8 consumer
// warps as BN / 32 column warps x KG k groups, and one producer warp that
// fills the weight ring (one thread issuing TMA boxes, or the whole warp
// loading elements when `tma` is 0). Block (bx, r) covers columns
// [bx BN, bx BN + BN) over rows [r k_chunk, (r + 1) k_chunk) of Kd,
// staging x kc rows at a time (kc and k_chunk multiples of 256; rows past
// a chunk's end meet zeros in x). Warp (cw, kg) runs the k steps s = kg,
// kg + KG, ... of each tile on its 32 columns, with no block barrier
// inside a chunk; rows >= M of the 16-row mma tile are zero (M <= 8
// never loads them). Shared memory: the weight ring, x (MT rows of kc,
// padded), reused for the k groups' partials (KG x MT x BN f32), the
// block partial, the mbarriers.
template <typename T, int MT, int BN>
__global__ void __launch_bounds__(kMmaThreads) int8_gemv_kernel(
    const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
    const int8_t* __restrict__ w, const float* __restrict__ scales,
    float* __restrict__ out, int M, int N, int Kd, int k_chunk, int kc,
    int tma) {
  constexpr int CW = BN / 32;
  constexpr int KG = 8 / CW;
  constexpr int TK = gemv_tile_k(BN);
  constexpr int TILE = kGemvTileBytes;
  constexpr int S = kGemvStages;
  extern __shared__ unsigned char gemv_smem[];
  unsigned char* ring =
      gemv_smem + ((1024u - (smem_u32(gemv_smem) & 1023u)) & 1023u);
  unsigned char* xs = ring + S * TILE;
  const int xstride = kc * (int)sizeof(T) + gemv_x_pad(sizeof(T));
  float* red = reinterpret_cast<float*>(xs);
  const int xs_bytes = MT * xstride;
  const int red_bytes = KG * MT * BN * 4;
  float* part = reinterpret_cast<float*>(
      xs + (xs_bytes > red_bytes ? xs_bytes : red_bytes));
  const uint32_t full = smem_u32(part + MT * BN);
  const uint32_t empty = full + 8 * S;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int k_begin = rank * k_chunk;
  const int k_end = min(Kd, k_begin + k_chunk);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, tma ? 1 : 32);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  if (warp == 8) {
    // producer: tile g of the block (over all its chunks) goes to stage
    // g % S once the consumers have released that stage's last tile
    int g = 0;
    for (int c0 = k_begin; c0 < k_end; c0 += kc) {
      const int kn = min(kc, k_end - c0);
      for (int r0 = 0; r0 < kn; r0 += TK, ++g) {
        const int s = g % S;
        mbar_wait(empty + 8 * s, ((g / S) & 1) ^ 1);
        unsigned char* st = ring + s * TILE;
        if (tma) {
          if (lane == 0) {
            mbar_expect_tx(full + 8 * s, TILE);
            tma_load_2d(smem_u32(st), &wmap, full + 8 * s, n0, c0 + r0);
          }
        } else {
          gemv_fill_tile<BN>(st, w, N, c0 + r0, c0 + kn, n0, lane);
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    const int cw = warp % CW;
    const int kg = warp / CW;
    const int g8 = lane / 4;
    const int q = lane % 4;
    const bool x_aligned = (Kd * sizeof(T)) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(x) % 16 == 0;
    int g = 0;
    for (int c0 = k_begin; c0 < k_end; c0 += kc) {
      const int kn = min(kc, k_end - c0);
      // x rows [c0, c0 + kc), zero past kn and M
      consumer_sync();  // the last chunk's readers are done
      constexpr int EPC = 16 / sizeof(T);
      const int cpr = kc / EPC;
      for (int i = tid; i < MT * cpr; i += kThreads) {
        const int m = i / cpr;
        const int kk = (i % cpr) * EPC;
        unsigned char* d = xs + m * xstride + kk * sizeof(T);
        if (x_aligned) {
          const bool ok = m < M && kk < kn;
          cp_async16(d, ok ? x + (size_t)m * Kd + c0 + kk : x, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            reinterpret_cast<T*>(d)[e] =
                (m < M && kk + e < kn) ? x[(size_t)m * Kd + c0 + kk + e]
                                       : from_f32<T>(0.f);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      consumer_sync();
      for (int r0 = 0; r0 < kn; r0 += TK, ++g) {
        const int s = g % S;
        mbar_wait(full + 8 * s, (g / S) & 1);
        const unsigned char* tile = ring + s * TILE;
        // one mma chain per tile (the accumulator truncates), then f32 adds
        float ta[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) ta[i][e] = 0.f;
#pragma unroll
        for (int s16 = kg; s16 < TK / 16; s16 += KG) {
          uint32_t rb[4], bf[4][2];
          const int kr = s16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldsm_x4_trans(rb,
                        smem_u32(tile + w_off<BN>(kr, cw * 2 + (lane >> 4))));
          widen_b(rb, bf);
          // a0..a3: (row g8, k 2q) (g8 + 8, 2q) (g8, 2q + 8) (g8 + 8, 2q + 8)
          const int kx = r0 + s16 * 16 + 2 * q;
          const unsigned char* xr = xs + g8 * xstride + kx * sizeof(T);
          const unsigned char* xr8 = xr + 8 * xstride;
          if constexpr (sizeof(T) == 2) {
            uint32_t a[4];
            a[0] = *reinterpret_cast<const uint32_t*>(xr);
            a[2] = *reinterpret_cast<const uint32_t*>(xr + 16);
            a[1] = MT > 8 ? *reinterpret_cast<const uint32_t*>(xr8) : 0u;
            a[3] = MT > 8 ? *reinterpret_cast<const uint32_t*>(xr8 + 16) : 0u;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(ta[nt], a, bf[nt]);
          } else {
            float2 v[4];
            v[0] = *reinterpret_cast<const float2*>(xr);
            v[2] = *reinterpret_cast<const float2*>(xr + 32);
            v[1] = MT > 8 ? *reinterpret_cast<const float2*>(xr8)
                          : make_float2(0.f, 0.f);
            v[3] = MT > 8 ? *reinterpret_cast<const float2*>(xr8 + 32)
                          : make_float2(0.f, 0.f);
            uint32_t ah[4], am[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split3(v[i].x, v[i].y, ah[i], am[i], al[i]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mma_bf16(ta[nt], ah, bf[nt]);
              mma_bf16(ta[nt], am, bf[nt]);
              mma_bf16(ta[nt], al, bf[nt]);
            }
          }
        }
        mbar_arrive(empty + 8 * s);  // this warp's reads of the stage are done
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += ta[i][e];
      }
    }
  }

  // the k groups' partials, added in k-group order
  __syncthreads();  // x is dead: its space takes the partials
  if (warp < 8) {
    const int cw = warp % CW;
    const int kg = warp / CW;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = lane / 4 + (e >> 1) * 8;
        const int col = cw * 32 + (nt >> 1) * 16 + 4 * (lane % 4) +
                        2 * (e & 1) + (nt & 1);
        if (m < MT) red[(kg * MT + m) * BN + col] = acc[nt][e];
      }
  }
  __syncthreads();
  for (int e = tid; e < MT * BN; e += kMmaThreads) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < KG; ++v) s += red[v * MT * BN + e];
    part[e] = s;
  }
  // the cluster's partials, added in rank order; rank r finishes a 1/cs
  // share of the tile
  cluster.sync();
  const int per = (MT * BN + cs - 1) / cs;
  const int e_end = min(MT * BN, (rank + 1) * per);
  for (int e = rank * per + tid; e < e_end; e += kMmaThreads) {
    const int m = e / BN;
    const int n = n0 + e % BN;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int r = 0; r < cs; ++r) s += cluster.map_shared_rank(part, r)[e];
    out[(size_t)m * N + n] = s * scales[n];
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// --- int8_mma ---------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile, k tile
constexpr int kRow = 128;                      // bytes: one swizzled row
constexpr int kXTile = kBM * kRow;             // a bf16 x tile (or term)
constexpr int kWRaw = kBK * kBN;               // an int8 w_q tile
constexpr int kWBox = kBK * kRow;              // 64 columns of bf16 w
constexpr int kWTile = 2 * kWBox;

// Per ring stage: the x tile as loaded (bf16: 128 swizzled rows, the wgmma
// layout; f32: two 128-row halves of 32 columns) and the int8 tile (64
// rows of 128 bytes). Then two buffers of widened tiles, so that one k
// tile is widened while the tensor cores run the last, then the full and
// empty mbarrier of each stage. bf16: 5 x (16 + 8) + 2 x 16 KB; f32:
// 2 x (32 + 8) + 2 x (48 + 16) KB.
template <typename T>
struct MmaSmem {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int S = F32 ? 2 : 5;
  static constexpr int X_RAW = kBM * kBK * (int)sizeof(T);
  static constexpr int STAGE = X_RAW + kWRaw;
  static constexpr int TERMS = F32 ? 3 : 0;     // widened x tiles
  static constexpr int CONV = TERMS * kXTile + kWTile;
  static constexpr int BAR = S * STAGE + 2 * CONV;
  static constexpr int BYTES = BAR + 16 * S;
  static constexpr int ALLOC = BYTES + 1024;    // to align the base
};

// Byte offset of 8-float chunk c (0..7) of row r in an f32 x stage: two
// 128-row halves of 32 columns, 128-byte rows, as two TMA boxes land.
__device__ __forceinline__ int f32_off(int r, int c) {
  return (c / 4) * (kBM * kRow) + r * kRow + (c % 4) * 32;
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
// (the layout wgmma's 128-byte swizzle mode reads; 1024-byte atoms).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * kRow + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (layout
// type 1, B128) whose rows are 128 bytes apart: start address, the leading
// byte offset `lead`, then the stride byte offset 1024, the step between
// 8-row groups (both in 16-byte units). K-major A (a 16-column slice of one
// 64-column box) reads no leading offset; MN-major B (16 rows of two
// 64-column boxes) reads it as the step from one box to the next.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lead) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (kGroup << 32) |
         (1ull << 62);
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
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// generic-proxy shared-memory writes become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma registers across the
// asynchronous instructions.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), \
      "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), \
      "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
      "+f"(d[62]), "+f"(d[63])

#define ACC64_OPS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
  "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) {=, +=} A (64 x 16, smem, K-major) . B (16 x 128,
// smem, MN-major), bf16 inputs
__device__ __forceinline__ void wgmma_kn(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64_OPS
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// Fill ring stage `st` with k tile `kt` element by element (lane of 32):
// the path for shapes that TMA cannot describe (rows not 16-byte aligned).
// Zeros past M, N and Kd; the layout that the TMA boxes give.
template <typename T>
__device__ __forceinline__ void mma_fill_stage(unsigned char* st,
                                               const T* __restrict__ x,
                                               const int8_t* __restrict__ w,
                                               int M, int N, int Kd, int m0,
                                               int n0, int kt, int lane) {
  using L = MmaSmem<T>;
  const int k0 = kt * kBK;
  for (int i = lane; i < kBM * kBK; i += 32) {
    const int row = i / kBK;
    const int k = i % kBK;
    const int gm = m0 + row;
    const T v = (gm < M && k0 + k < Kd) ? x[(size_t)gm * Kd + k0 + k]
                                        : from_f32<T>(0.f);
    const int off = L::F32 ? f32_off(row, k / 8) + (k % 8) * 4
                           : sw128(row, k / 8) + (k % 8) * 2;
    *reinterpret_cast<T*>(st + off) = v;
  }
  unsigned char* sw = st + L::X_RAW;
  for (int i = lane; i < kBK * kBN; i += 32) {
    const int kr = i / kBN;
    const int n = i % kBN;
    sw[i] = (k0 + kr < Kd && n0 + n < N)
                ? static_cast<unsigned char>(w[(size_t)(k0 + kr) * N + n0 + n])
                : 0;
  }
}

// Widen a ring stage into a conversion buffer (256 consumer threads):
// w_q's int8 to bf16 in two 64-column swizzled boxes (MN-major B), and,
// for f32 x, x into its hi, mid and lo bf16 tiles (K-major A).
template <typename T>
__device__ __forceinline__ void mma_widen(const unsigned char* st,
                                          unsigned char* conv) {
  using L = MmaSmem<T>;
  unsigned char* wt = conv + L::TERMS * kXTile;
  const unsigned char* sw = st + L::X_RAW;
  for (int i = threadIdx.x; i < kBK * 8; i += kThreads) {
    const int kr = i / 8;
    const int c = i % 8;               // 16 columns: c * 16 ...
    const uint4 raw = *reinterpret_cast<const uint4*>(sw + kr * kBN + c * 16);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t packed[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[4];
      widen4(words[j], f);
      packed[2 * j] = pack_hi16(f[0], f[1]);
      packed[2 * j + 1] = pack_hi16(f[2], f[3]);
    }
    unsigned char* box = wt + (c / 4) * kWBox;
    const int cc = (c % 4) * 2;        // bf16 chunk in the box's row
    *reinterpret_cast<uint4*>(box + sw128(kr, cc)) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    *reinterpret_cast<uint4*>(box + sw128(kr, cc + 1)) =
        make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
  if constexpr (L::F32) {
    for (int i = threadIdx.x; i < kBM * 8; i += kThreads) {
      const int row = i / 8;
      const int c = i % 8;             // 8 floats: c * 8 ...
      const float4* src = reinterpret_cast<const float4*>(st + f32_off(row, c));
      const float4 u = src[0], v = src[1];
      const float xs[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      uint32_t h[4], m[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split3(xs[2 * j], xs[2 * j + 1], h[j], m[j], l[j]);
      const int off = sw128(row, c);
      *reinterpret_cast<uint4*>(conv + off) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(conv + kXTile + off) =
          make_uint4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<uint4*>(conv + 2 * kXTile + off) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// grid (ceil(N / 128), ceil(M / 128)); 288 threads: two consumer
// warpgroups, each 64 rows x 128 columns (one m64n128 accumulator), and one
// producer warp that fills the ring (one thread issuing TMA boxes, or the
// whole warp loading elements when `tma` is 0). The consumers keep one k
// tile's wgmmas in flight: they issue tile kt, wait for tile kt - 1's (the
// last to read the buffer that tile kt + 1 is widened into) and widen tile
// kt + 1 while tile kt runs. A ring stage is released when its last reader
// is done: the wgmmas for bf16 x, the widening for f32 x (split into the
// conversion buffer). A chain of products
// covers kChain k tiles; at its end the consumers wait for it and add it
// to the f32 sum.
constexpr int kChain = 2;

template <typename T>
__global__ void __launch_bounds__(kMmaThreads) int8_mma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
    const int8_t* __restrict__ w, const float* __restrict__ scales,
    float* __restrict__ out, int M, int N, int Kd, int tma) {
  using L = MmaSmem<T>;
  constexpr int S = L::S;
  extern __shared__ unsigned char mma_smem[];
  unsigned char* base =
      mma_smem + ((1024u - (smem_u32(mma_smem) & 1023u)) & 1023u);
  unsigned char* ring = base;
  unsigned char* conv = base + S * L::STAGE;
  const uint32_t full = smem_u32(base + L::BAR);
  const uint32_t empty = full + 8 * S;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int nk = (Kd + kBK - 1) / kBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, tma ? 1 : 32);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kThreads) {
    const int lane = tid - kThreads;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      // the consumers released this stage's last tile (a fresh barrier's
      // parity-1 phase counts as complete)
      mbar_wait(empty + 8 * s, ((kt / S) & 1) ^ 1);
      unsigned char* st = ring + s * L::STAGE;
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, L::STAGE);
          if constexpr (L::F32) {
            tma_load_2d(smem_u32(st), &xmap, full + 8 * s, kt * kBK, m0);
            tma_load_2d(smem_u32(st + kBM * kRow), &xmap, full + 8 * s,
                        kt * kBK + 32, m0);
          } else {
            tma_load_2d(smem_u32(st), &xmap, full + 8 * s, kt * kBK, m0);
          }
          tma_load_2d(smem_u32(st + L::X_RAW), &wmap, full + 8 * s, n0,
                      kt * kBK);
        }
      } else {
        mma_fill_stage<T>(st, x, w, M, N, Kd, m0, n0, kt, lane);
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  float acc[64], t[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  mbar_wait(full, 0);
  mma_widen<T>(ring, conv);
  fence_proxy_async();
  if constexpr (L::F32) mbar_arrive(empty);  // only the widening reads it
  consumer_sync();
  const int wg = tid / 128;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    const unsigned char* st = ring + s * L::STAGE;
    const unsigned char* cv = conv + (kt % 2) * L::CONV;
    const uint32_t xa =
        smem_u32(L::F32 ? cv : st) + wg * 64 * kRow;  // this warpgroup's rows
    const uint32_t wb = smem_u32(cv + L::TERMS * kXTile);
    // the tensor cores' accumulator truncates: each chain starts from 0
    // (scale-d off) and its sum joins acc through an f32 add
    const bool first = kt % kChain == 0;
    const bool last = kt % kChain == kChain - 1 || kt + 1 == nk;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int term = 0; term < (L::F32 ? 3 : 1); ++term)
        wgmma_kn(t, desc_b128(xa + term * kXTile + kk * 32, 1024),
                 desc_b128(wb + kk * 16 * kRow, kWBox),
                 !first || kk > 0 || term > 0);
    wg_commit();
    wg_wait1();
    // bf16 x is read from the ring stage: tile kt - 1's wgmmas are done
    if (!L::F32 && kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % S));
    // widen tile kt + 1 into the other buffer while the wgmmas run
    if (kt + 1 < nk) {
      consumer_sync();  // both warpgroups' wgmmas of tile kt - 1 are done
      const int s1 = (kt + 1) % S;
      mbar_wait(full + 8 * s1, ((kt + 1) / S) & 1);
      mma_widen<T>(ring + s1 * L::STAGE, conv + ((kt + 1) % 2) * L::CONV);
      fence_proxy_async();
      if (L::F32) mbar_arrive(empty + 8 * s1);  // only the widening reads it
    }
    if (last) {
      wg_wait0();
      fence_regs(t);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += t[e];
    }
    consumer_sync();  // tile kt + 1 widened everywhere
  }

  // acc[32 j + 4 j8 + 2 r + e] is (row 16 warp + g + 8 r, column 64 j +
  // 8 j8 + 2 q + e) of this warpgroup's 64 x 128 tile
  const int lane = tid % 32;
  const int wrow = m0 + wg * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  const bool vec = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wrow + 8 * r;
        const int col = n0 + 64 * j + 8 * j8 + 2 * (lane % 4);
        if (row >= M || col >= N) continue;
        const int e0 = 32 * j + 4 * j8 + 2 * r;
        const float v0 = acc[e0] * scales[col];
        float* o = out + (size_t)row * N + col;
        if (vec) {
          *reinterpret_cast<float2*>(o) =
              make_float2(v0, acc[e0 + 1] * scales[col + 1]);
        } else {
          o[0] = v0;
          if (col + 1 < N)
            o[1] = acc[e0 + 1] * scales[col + 1];
        }
      }
}

// --- host side --------------------------------------------------------------

constexpr int kGemvXBytes = 64 << 10;  // x staged per pass, at most

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

// A tensor map over a row-major (outer, inner) array with boxes of
// (box_outer, box_inner) and zeros past either edge.
bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                 uint64_t inner, uint64_t outer, uint64_t row_bytes,
                 uint32_t box_inner, uint32_t box_outer,
                 CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct GemvPlan {
  int mt, bn, cs, k_chunk, kc, smem;
};

// The int8_gemv launch for an (M, Kd) x (Kd, N) product on a card of
// `n_sm` SMs. Policy (measured on the H100, 132 SMs, where one block per SM
// ran best): 128 columns per block if 8-block clusters of them then fill
// the card's SMs (to within 1/32), else 64; then as many K-blocks per
// cluster (up to 8, each at least 256 rows deep) as keep the grid within
// one block per SM.
GemvPlan gemv_plan(int M, int N, int Kd, int x_bytes, int n_sm) {
  GemvPlan p{};
  p.mt = M <= 8 ? 8 : 16;
  p.bn = (N + 127) / 128 * 8 >= n_sm * 31 / 32 ? 128 : 64;
  const int by_grid = n_sm / ((N + p.bn - 1) / p.bn);
  const int by_depth = Kd / 256;
  p.cs = by_grid < by_depth ? by_grid : by_depth;
  p.cs = p.cs < 1 ? 1 : p.cs > 8 ? 8 : p.cs;
  const int per = (Kd + p.cs - 1) / p.cs;
  p.k_chunk = (per + kGemvMaxTileK - 1) / kGemvMaxTileK * kGemvMaxTileK;
  const int cap =
      kGemvXBytes / (p.mt * x_bytes) / kGemvMaxTileK * kGemvMaxTileK;
  p.kc = p.k_chunk < cap ? p.k_chunk : cap;
  const int xs = p.mt * (p.kc * x_bytes + gemv_x_pad(x_bytes));
  const int red = (8 / (p.bn / 32)) * p.mt * p.bn * 4;
  p.smem = 1024 + kGemvStages * kGemvTileBytes + (xs > red ? xs : red) +
           p.mt * p.bn * 4 + 16 * kGemvStages;
  return p;
}

constexpr int kMaxDevices = 64;
int g_sm_count[kMaxDevices] = {0};  // per device, read once

// The current device's SM count.
cudaError_t current_sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sm_count[dev] == 0) {
    rc = cudaDeviceGetAttribute(&g_sm_count[dev],
                                cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
  }
  *n_sm = g_sm_count[dev];
  return cudaSuccess;
}

// Let `kernel` take `bytes` of dynamic shared memory on the current
// device; the attribute is set once per kernel, device and size.
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {0};
  if (bytes <= (48 << 10)) return cudaSuccess;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || dev >= kMaxDevices) return rc;
  if (bytes <= allowed[dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (rc == cudaSuccess) allowed[dev] = bytes;
  return rc;
}

template <typename T, int MT, int BN>
cudaError_t gemv_launch(const GemvPlan& p, const void* x, const void* w,
                        const void* s, void* out, int M, int N, int Kd,
                        cudaStream_t stream) {
  auto kernel = int8_gemv_kernel<T, MT, BN>;
  cudaError_t rc = allow_smem<int8_gemv_kernel<T, MT, BN>>(p.smem);
  if (rc != cudaSuccess) return rc;
  CUtensorMap wmap{};
  const bool tma = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0;
  if (tma && !make_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, Kd, N,
                          BN, gemv_tile_k(BN),
                          BN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorNotSupported;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, p.cs, 1);
  cfg.blockDim = dim3(kMmaThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, wmap, static_cast<const T*>(x),
                            static_cast<const int8_t*>(w),
                            static_cast<const float*>(s),
                            static_cast<float*>(out), M, N, Kd, p.k_chunk,
                            p.kc, tma ? 1 : 0);
}

template <typename T, int MT>
cudaError_t gemv_bn(const GemvPlan& p, const void* x, const void* w,
                    const void* s, void* out, int M, int N, int Kd,
                    cudaStream_t st) {
  switch (p.bn) {
    case 64: return gemv_launch<T, MT, 64>(p, x, w, s, out, M, N, Kd, st);
    case 128: return gemv_launch<T, MT, 128>(p, x, w, s, out, M, N, Kd, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t gemv(const GemvPlan& p, const void* x, const void* w,
                 const void* s, void* out, int M, int N, int Kd,
                 cudaStream_t st) {
  return p.mt == 8 ? gemv_bn<T, 8>(p, x, w, s, out, M, N, Kd, st)
                   : gemv_bn<T, 16>(p, x, w, s, out, M, N, Kd, st);
}

// int8_mma: TMA boxes where the rows are 16-byte aligned (every main-path
// shape), element loads by the producer warp else.
template <typename T>
cudaError_t mma(const void* x, const void* w, const void* s, void* out, int M,
                int N, int Kd, cudaStream_t stream) {
  auto kernel = int8_mma_kernel<T>;
  constexpr int smem = MmaSmem<T>::ALLOC;
  cudaError_t rc = allow_smem<int8_mma_kernel<T>>(smem);
  if (rc != cudaSuccess) return rc;
  constexpr bool f32 = sizeof(T) == 4;
  CUtensorMap xmap{}, wmap{};
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   (Kd * sizeof(T)) % 16 == 0 && N % 16 == 0;
  if (tma &&
      !(make_map_2d(&xmap,
                    f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    x, Kd, M, Kd * sizeof(T), f32 ? 32 : 64, kBM,
                    f32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                        : CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, Kd, N, kBN,
                    kBK, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorNotSupported;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      xmap, wmap, static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(out), M, N, Kd,
      tma ? 1 : 0);
  return cudaGetLastError();
}

int x_bytes_of(int dtype) {
  return dtype == kBFloat16 ? 2 : dtype == kFloat32 ? 4 : 0;
}

}  // namespace

// The launch that int8_matmul_fwd makes for this call on the current
// device: plan[0] = 0 for int8_gemv or 1 for int8_mma, then the gemv's
// column tile, cluster size and dynamic shared memory (or 128, 1 and the
// mma body's bytes).
extern "C" int int8_matmul_plan(int M, int N, int Kd, int dtype,
                                int* plan) {
  const int xb = x_bytes_of(dtype);
  if (M < 1 || N < 1 || Kd < 1 || xb == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= kMaxGemvM) {
    int n_sm = 0;
    const cudaError_t rc = current_sm_count(&n_sm);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const GemvPlan p = gemv_plan(M, N, Kd, xb, n_sm);
    plan[0] = 0;
    plan[1] = p.bn;
    plan[2] = p.cs;
    plan[3] = p.smem;
  } else {
    plan[0] = 1;
    plan[1] = kBN;
    plan[2] = 1;
    plan[3] = xb == 4 ? MmaSmem<float>::ALLOC : MmaSmem<__nv_bfloat16>::ALLOC;
  }
  return 0;
}

// out = (x @ w) * s in one launch.
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* s,
                               void* out, int M, int N, int Kd, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int xb = x_bytes_of(dtype);
  if (M < 1 || N < 1 || Kd < 1 || xb == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc;
  if (M <= kMaxGemvM) {
    int n_sm = 0;
    rc = current_sm_count(&n_sm);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const GemvPlan p = gemv_plan(M, N, Kd, xb, n_sm);
    rc = xb == 2 ? gemv<__nv_bfloat16>(p, x, w, s, out, M, N, Kd, st)
                 : gemv<float>(p, x, w, s, out, M, N, Kd, st);
  } else {
    rc = xb == 2 ? mma<__nv_bfloat16>(x, w, s, out, M, N, Kd, st)
                 : mma<float>(x, w, s, out, M, N, Kd, st);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
