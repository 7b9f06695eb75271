// Weight-only int8 GEMM (W8A16 / W8A32), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py
// (int8_matmul / _int8_mm_kernel), reached through
// repro.models.quantize.qeinsum on the int8 variant's projections.
//
// out (M, N) f32 = (x (M, Kd) @ w_q (Kd, N) int8) * scales (N,):
// accumulate-then-scale in f32, the scale applied once in the epilogue, as
// the Pallas body does. x is read in its own dtype (bf16 or f32) and
// widened in shared memory; there is no f32 copy of x in device memory and
// no padding of any operand to the tile: ragged M, N and Kd edges are masked
// in the tile loads and the store.
//
// Tiling: each block computes a BM x BN output tile, walking Kd in BK
// steps. The x tile is staged transposed in shared memory, the int8 weight
// tile is loaded four bytes per thread (one char4 when N % 4 == 0) and
// dequantised to f32 in shared memory; each thread then accumulates a
// TM x TN micro-tile in registers.
//
// What bounds it on the H100: at decode the rows are the batch slots
// (M <= 8), so each weight byte feeds at most 2 * 8 flops and the kernel is
// bound by the weight bytes it streams. Streaming them fast needs many
// blocks in flight, and a 2048-wide output in 32-column tiles gives only 64:
// so for small M int8_matmul_splits picks a split of Kd across blockIdx.z
// (split-K) from the tile count and the device's SM count, the wrapper
// allocates the (splits, M, N) f32 workspace it asks for, each block writes
// its partial sum there, and a second kernel adds
// the partials in a fixed order and applies the scales (deterministic, no
// atomics). At prefill (M = slots x prompt bucket) it is bound by
// operations, which this first version does on the f32 SIMT pipes;
// tensor-core (mma/wgmma) tiles with the dequantisation fused into the
// operand load are later work.
#include "common.cuh"

using namespace repro;

namespace {

// the small-M (decode) output tile; split-K is chosen for this tile only
constexpr int kSmallM = 16;
constexpr int kSmallBN = 32;
constexpr int kMaxDevices = 64;
int g_sm_count[kMaxDevices] = {0};  // per device, read once

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) int8_mm_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scales, float* __restrict__ out,
    float* __restrict__ partial, int M, int N, int Kd, int k_chunk) {
  constexpr int NTX = BN / TN;
  constexpr int NTY = BM / TM;
  constexpr int NT = NTX * NTY;
  static_assert(BN % 4 == 0, "weight tile rows load four bytes at a time");
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool vec = (N % 4) == 0;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(Kd, k_begin + k_chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int mm = e / BK;
      const int kk = e % BK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < k_end) ? to_f32(x[(size_t)gm * Kd + gk]) : 0.f;
    }
    for (int e = tid * 4; e < BK * BN; e += NT * 4) {
      const int kk = e / BN;
      const int nn = e % BN;
      const int gk = k0 + kk;
      const int gn = n0 + nn;
      if (gk < k_end && vec && gn + 3 < N) {
        const char4 c = *reinterpret_cast<const char4*>(w + (size_t)gk * N + gn);
        ws[kk][nn] = static_cast<float>(c.x);
        ws[kk][nn + 1] = static_cast<float>(c.y);
        ws[kk][nn + 2] = static_cast<float>(c.z);
        ws[kk][nn + 3] = static_cast<float>(c.w);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ws[kk][nn + u] = (gk < k_end && gn + u < N)
                               ? static_cast<float>(w[(size_t)gk * N + gn + u])
                               : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * NTY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * NTY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      if (gridDim.z == 1)
        out[(size_t)gm * N + gn] = acc[i][j] * scales[gn];
      else
        partial[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
    }
  }
}

// out = (sum over the split-K partials, in split order) * scales
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += partial[z * mn + i];
    out[i] = acc * scales[i % N];
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, const void* s, void* out,
            void* partial, int M, int N, int Kd, int splits,
            cudaStream_t stream) {
  // each split covers a whole number of BK steps
  const int per = (Kd + splits - 1) / splits;
  const int k_chunk = (per + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_mm_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(s), static_cast<float*>(out),
          static_cast<float*>(partial), M, N, Kd, k_chunk);
  if (splits > 1) {
    const int threads = 256;
    const long long want = ((long long)M * N + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    splitk_reduce_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<const float*>(s),
        static_cast<float*>(out), M, N, splits);
  }
}

template <typename T>
int dispatch_m(const void* x, const void* w, const void* s, void* out,
               void* partial, int M, int N, int Kd, int splits,
               cudaStream_t stream) {
  if (M <= kSmallM)
    launch<T, kSmallM, kSmallBN, 64, 1, 4>(x, w, s, out, partial, M, N, Kd,
                                           splits, stream);
  else
    launch<T, 64, 64, 32, 4, 4>(x, w, s, out, partial, M, N, Kd, splits,
                                stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many ways to split Kd for an (M, Kd) x (Kd, N) product on `device`:
// at small M the output tiles alone put too few blocks on the card to
// stream the weights, so aim for about two blocks per SM, keeping each
// split at least 256 deep. Large M is not split.
extern "C" int int8_matmul_splits(int M, int N, int Kd, int device,
                                  int* splits) {
  if (M < 1 || N < 1 || Kd < 1 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_sm_count[device] == 0) {
    int n_sm = 0;
    const cudaError_t rc = cudaDeviceGetAttribute(
        &n_sm, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    g_sm_count[device] = n_sm;
  }
  *splits = 1;
  if (M <= kSmallM) {
    const int tiles = ((N + kSmallBN - 1) / kSmallBN) *
                      ((M + kSmallM - 1) / kSmallM);
    const int by_sm = 2 * g_sm_count[device] / tiles;
    const int want = by_sm < Kd / 256 ? by_sm : Kd / 256;
    *splits = want > 1 ? want : 1;
  }
  return 0;
}

// partial: (splits, M, N) f32 workspace, read only when splits > 1
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* s,
                               void* out, void* partial, int M, int N, int Kd,
                               int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || Kd < 1 || splits < 1 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16)
    return dispatch_m<__nv_bfloat16>(x, w, s, out, partial, M, N, Kd, splits,
                                     st);
  if (dtype == kFloat32)
    return dispatch_m<float>(x, w, s, out, partial, M, N, Kd, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
