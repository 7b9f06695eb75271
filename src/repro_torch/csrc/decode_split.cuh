// Split-T one-token decode attention (FlashDecoding) on the SIMT pipes: the
// f32 body of the three decode kernels (decode_attention.cu,
// fused_paged_decode.cu, paged_decode.cu), and the fold of the spans that
// every decode kernel ends in, after this body or the bf16 tensor-core body
// of decode_mma.cuh.
//
// The body: one block per (span, KV head, slot). The block serves all G
// query heads of its KV head (G <= R, the body's row count: 8, or 16 for
// qwen3-moe's G = 16, so the G <= 8 paths keep their shared memory) over
// its own span of the slot's logical rows
// [t0, t1): q (G x D) sits in shared memory, and the block stages 32 rows
// of K/V for this head at a time in shared memory as f32 (rows at or past
// t1 are staged as zeros, never read, so stale or garbage rows cannot leak
// into the sum). Each warp scores the 32 staged rows for one query head
// (one row per lane) and folds them into that head's running (max, sum)
// with warp shuffles; every thread then updates its share of the f32
// (G x D) accumulator. The block ends with its span's partial (m, l, acc).
//
// Where a row of the slot lives is the caller's business: a functor maps
// logical row t to the element offset of its (row, head) vector of D
// (PagedRows, below, for the two paged kernels). With kNewRow (the fused
// paged kernel's f32 body), logical row t_new is taken from the k_new /
// v_new vectors instead: the step's own row, which the block writes into
// its page and must not read back through the pool.
//
// The spans of one (slot, KV head) are one thread-block cluster and fold
// their partials in the same launch (fold_cluster, below): no second pass,
// no workspace.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "common.cuh"

namespace repro {
namespace decode_split {

namespace cg = cooperative_groups;

constexpr int NT = 128;   // threads per block (4 warps)
constexpr int TC = 32;    // rows staged per step: one per lane
constexpr int GMAX = 16;  // query heads per KV head, at most

// The row count of the bodies that serve G query heads per KV head: 8, or
// 16 for G of 9 to 16. Every body, partial and fold is templated on it.
inline int rows_for(int G) { return G <= 8 ? 8 : 16; }

// Logical row t of one (slot, KV head) of a page pool (n_phys, ps, K, D):
// page bt_row[t / ps], clamped into [0, n_phys - 1] as the Pallas wrappers
// clamp the block table, row t % ps.
struct PagedRows {
  const int* bt_row;
  int ps, n_phys;
  size_t page_stride, row_stride, head_off;
  // KV head kh of slot b, through row b of the (B, P) block table bt
  static __device__ __forceinline__ PagedRows of(const int* bt, int b,
                                                 int kh, int K, int D,
                                                 int n_phys, int ps, int P) {
    return PagedRows{bt + (size_t)b * P, ps, n_phys, (size_t)ps * K * D,
                     (size_t)K * D, (size_t)kh * D};
  }
  __device__ __forceinline__ size_t operator()(int t) const {
    const int page = min(max(bt_row[t / ps], 0), n_phys - 1);
    return (size_t)page * page_stride + (size_t)(t % ps) * row_stride +
           head_off;
  }
};

// Partial attention of the G <= R heads of q_head over rows [t0, t1) of
// one (slot, KV head); writes m, l (G each) and acc (G x D).
template <typename T, int D, int R, typename RowOffset, bool kNewRow = false>
__device__ __forceinline__ void attend_span(
    const T* __restrict__ q_head, const T* __restrict__ k,
    const T* __restrict__ v, const RowOffset& row_offset, int G, int t0,
    int t1, float sm_scale, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc,
    int t_new = -1,
    const T* __restrict__ k_new = nullptr,
    const T* __restrict__ v_new = nullptr) {
  constexpr int ACC = (R * D + NT - 1) / NT;
  __shared__ float qs[R][D];
  __shared__ float ks[TC][D + 1];  // padded: lanes read distinct banks
  __shared__ float vs[TC][D];
  __shared__ float prob[R][TC];
  __shared__ float alpha_s[R];
  __shared__ float m_s[R];
  __shared__ float l_s[R];

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
        if (kNewRow && c0 + r == t_new) {
          kk = to_f32(k_new[d]);
          vv = to_f32(v_new[d]);
        } else {
          const size_t off = row_offset(c0 + r) + d;
          kk = to_f32(k[off]);
          vv = to_f32(v[off]);
        }
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
    part_m[tid] = m_s[tid];
    part_l[tid] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D) part_acc[idx] = acc[i];
  }
}

// The fold, in the same launch: the blocks of one (slot, KV head) form a
// thread-block cluster along the span axis. Rank j owns the j-th slice of
// the G x D outputs. Each block writes its partial (m, l, acc) into a
// Partial in its own shared memory, then pushes its m and l, and the j-th
// slice of its acc, into rank j's Inbox through distributed shared memory;
// one cluster barrier later every rank holds all spans' pieces of its
// slice and folds them locally in span order (no atomics, no workspace: the
// same bits every call), writing acc / max(l, 1e-30), 0 for a slot with
// nothing to attend. No block reads another's shared memory, so none waits
// at a second barrier before it exits. A span with nothing to attend has
// l = 0 (a live one has l >= 1: its largest score gives p = 1); it pushes
// no acc, and its slice is never read.
constexpr int MAX_SPLIT = 8;  // spans per (slot, head): a portable cluster

template <int D, int R>
struct Partial {
  float m[R];
  float l[R];
  float acc[R * D];
};

template <int D, int R>
struct Inbox {
  float m[MAX_SPLIT][R];
  float l[MAX_SPLIT][R];
  float acc[R * D + MAX_SPLIT];  // span r's slice at r * slice
};

// The SIMT body's static shared memory with the fold's: under the 48 KB a
// kernel may declare statically. It holds at R = 16 up to D = 96; f32 at G
// 9-16 and D = 128 has no body (the wrapper raises first).
template <int D, int R>
constexpr bool simt_fits() {
  return 4 * (R * D + TC * (D + 1) + TC * D + R * TC + 3 * R) +
             sizeof(Partial<D, R>) + sizeof(Inbox<D, R>) +
             4 * (MAX_SPLIT * R + R) <= 48 * 1024;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Call at the start of the kernel: the arrival that fold_cluster's first
// wait completes, so that no block writes into another before it runs.
__device__ __forceinline__ void cluster_started() { cluster_arrive_relaxed(); }

template <typename T, int D, int R>
__device__ __forceinline__ void fold_cluster(const Partial<D, R>& part,
                                             Inbox<D, R>& inbox, int G,
                                             T* __restrict__ out) {
  __shared__ float w_s[MAX_SPLIT][R];  // span r's weight for head g
  __shared__ float l_s[R];             // the folded sum
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int slice = (G * D + n - 1) / n;
  cluster_wait();  // every block of the cluster has started
  __syncthreads();  // this block's partial is complete
  if (tid < n * G) {
    const int j = tid / G;
    const int g = tid % G;
    Inbox<D, R>* to = cluster.map_shared_rank(&inbox, j);
    to->m[rank][g] = part.m[g];
    to->l[rank][g] = part.l[g];
  }
  if (part.l[0] > 0.f) {
    for (int e = tid; e < G * D; e += blockDim.x) {
      const int j = e / slice;
      cluster.map_shared_rank(inbox.acc, j)[rank * slice + e - j * slice] =
          part.acc[e];
    }
  }
  cluster_arrive_release();
  cluster_wait();  // every span's pieces of this block's slice have landed
  if (tid < G) {
    float mx = kNegInf;
    for (int r = 0; r < n; ++r)
      if (inbox.l[r][tid] > 0.f) mx = fmaxf(mx, inbox.m[r][tid]);
    float lsum = 0.f;
    for (int r = 0; r < n; ++r) {
      const float w = inbox.l[r][tid] > 0.f ? expf(inbox.m[r][tid] - mx)
                                            : 0.f;
      w_s[r][tid] = w;
      lsum += inbox.l[r][tid] * w;
    }
    l_s[tid] = lsum;
  }
  __syncthreads();
  const int e0 = rank * slice;
  const int e1 = min(G * D, e0 + slice);
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    const int g = e / D;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < n && w_s[r][g] != 0.f)
        acc += inbox.acc[r * slice + e - e0] * w_s[r][g];
    out[e] = from_f32<T>(acc / fmaxf(l_s[g], 1e-30f));
  }
}

// Launches `kernel` on grid (n_split, K, B) with clusters of n_split blocks
// along the span axis.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int n_split, int K,
                            int B, int threads, int smem,
                            cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, K, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

}  // namespace decode_split
}  // namespace repro
