// Cosine self-consistency vote for Hopper (sm_90a): one thread-block
// cluster per request, its blocks splitting D and trading partial sums
// through distributed shared memory.
//
// Replaces: llm_weighted_consensus_tpu/ops/kernels.py::fused_cosine_vote
// (the Pallas kernel _cosine_vote_kernel): rows L2-normalised by
// rsqrt(sum x^2 + 1e-12), the N x N f32 cosine Gram, each row's mean over
// the valid off-diagonal columns divided by max(n-1, 1) and by the
// temperature, then a softmax over the valid rows.  Like
// csrc/cosine_vote.cu (the "block" route, kept for shapes this one does
// not hold) it takes a leading request axis R and a run-time temperature,
// and replaces the Gram by the column-sum identity: for unit rows x_i,
//     sum_{j != i, j < n} x_i . x_j = x_i . (sum_{j < n} x_j) - x_i . x_i.
//
// What bounds it on the H100: bytes, and below them a floor of latency.
// At the main path's [8, 64, 1024] f32 the input is 2 MiB, 0.63 us at
// 3.35 TB/s; any launch costs about 1 us of device time, and each
// dependent step (the round trip to L2/HBM, every cluster barrier and
// exchange, every reduction) some hundreds of ns more.  The block route
// runs one block per request (8 of 132 SMs at R = 8), reads every row
// three times through that one SM and sums columns in a serial chain of n
// FMAs.  This kernel spreads a request over C SMs, reads it once, and
// keeps the steps few: the sums of squares are taken during the copy, and
// the last exchange goes to block 0 alone, so no third barrier is needed.
//
// Design.  Request r is cluster r of C blocks (grid [C, R], C <= 16; above
// 8 a non-portable cluster size).  Block c owns the columns
// [c * cols, min((c + 1) * cols, D)) of the request's live rows (rows at
// and past n_valid are never read).  Every row pass gives each row
// 256 / n_valid lanes (up to a warp), so a block takes all its rows at
// once, and every cross-block sum goes through distributed shared memory
// (mapa + st.shared::cluster) as stores, so no block waits on a remote
// load.
//   1. Each block reads its columns once, with 16-byte loads where the
//      rows are aligned, into shared memory in the input's dtype (rows
//      padded by 16 bytes), summing x^2 of every row on the way, and
//      stores the partial sums into every block of the cluster.  After a
//      cluster barrier each block adds the C partials in rank order
//      0..C-1, so all blocks hold bit-identical inverse norms.
//   2. Each block sums the normalised live rows over its own columns: the
//      column sum s is per column and needs no exchange.
//   3. Each block forms every live row's partial dot - self over its
//      columns as nx_i . (s - nx_i) (nx_i = x_i * inv_i): the row's own
//      self-dot is taken out column by column, where the terms are small,
//      and not from the whole dot (~n) at the end, which in f32 costs
//      ~2e-6 of confidence at n = 2, T = 0.05.  It stores the partials
//      into block 0, arrives at the cluster barrier and leaves: nothing
//      reads its shared memory any more.
//   4. Block 0 waits, adds the C partials in rank order, forms the
//      reference's logit ((dot - self) / max(n_valid - 1, 1)) / T and
//      runs the softmax over the live rows in one warp.  Rows past
//      n_valid get exactly 0 (no -inf is ever formed); one live row is a
//      softmax of one term, a confidence of exactly 1.
// Per-request counts: with `counts` (int32 [R] on the device) cluster r
// reads its own count counts[r] (clamped to [0, N]) in place of the
// scalar n_valid, so one launch votes over streams of different lengths
// (the streaming consensus); a count of 0 gives a row of zeros and no
// barrier after the first.  With `counts` null the kernel is the scalar
// one, bit for bit.
// One read of the input, two exchanges of N floats per block, no atomics:
// the result is deterministic, bit for bit, from call to call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;
// 16-byte loads a thread keeps in flight while copying its rows
constexpr int kInFlight = 8;
// columns per block are a multiple of this, so every block's first column
// and every row of the shared tile sit on a 16-byte boundary
constexpr int kColAlign = 8;
// the shared memory a Hopper block can have (227 KB)
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_blocks() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, split: every thread of the cluster arrives, then
// waits for every thread that has not exited to have arrived.  The
// release/acquire pair makes the shared-memory stores before an arrival,
// remote ones included, visible after the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store v at `local`'s offset in the shared memory of block `rank`.
__device__ __forceinline__ void st_cluster(float* local, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// Bytes of shared memory for n rows of `cols` columns in a cluster of
// `blocks`, all of it dynamic (so the whole 227 KB can be asked for): the
// tile, rows padded by 16 bytes so that the rows a quarter-warp reads fall
// on different banks; then in f32 the partial sums of squares and of
// dot - self of every block [2][blocks][n], the inverse norms and the
// logits [2][n] and the column sum [cols].
size_t smem_bytes(int n, int cols, int blocks, size_t item) {
  const size_t nn = static_cast<size_t>(n);
  const size_t cc = static_cast<size_t>(cols);
  const size_t bb = static_cast<size_t>(blocks);
  return nn * (cc * item + 16) + sizeof(float) * (2 * bb * nn + 2 * nn + cc);
}

// The 16 bytes at src + k (k a multiple of 16 / sizeof(T)): one 16-byte
// load where the rows are aligned and the columns in range, else element
// by element, zero at and past `width`.
__device__ __forceinline__ uint4 load16(const float* src, int k, int width,
                                        int vec) {
  if (vec && k < width) return __ldg(reinterpret_cast<const uint4*>(src + k));
  uint32_t w[4];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    w[h] = k + h < width ? __float_as_uint(src[k + h]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* src, int k,
                                        int width, int vec) {
  if (vec && k < width) return __ldg(reinterpret_cast<const uint4*>(src + k));
  uint32_t w[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint32_t lo =
        k + 2 * h < width ? __bfloat16_as_ushort(src[k + 2 * h]) : 0u;
    const uint32_t hi =
        k + 2 * h + 1 < width ? __bfloat16_as_ushort(src[k + 2 * h + 1])
                              : 0u;
    w[h] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes as floats: 4 f32 or 8 bf16.
__device__ __forceinline__ void unpack(uint4 q, float (&e)[4]) {
  e[0] = __uint_as_float(q.x);
  e[1] = __uint_as_float(q.y);
  e[2] = __uint_as_float(q.z);
  e[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(uint4 q, float (&e)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[h]));
    e[2 * h] = f.x;
    e[2 * h + 1] = f.y;
  }
}

// Sum of p[c * stride] over the cluster's blocks c, added in rank order
// 0..blocks-1 (the loads issued together first).
__device__ __forceinline__ float rank_sum(const float* p, int stride,
                                          int blocks) {
  float v[kMaxCluster];
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    v[c] = c < blocks ? p[c * stride] : 0.0f;
  float s = v[0];
#pragma unroll
  for (int c = 1; c < kMaxCluster; ++c)
    if (c < blocks) s += v[c];
  return s;
}

// Sum over `lanes` neighbouring lanes (a power of two <= 32, the group
// aligned within its warp), in a fixed order; every lane gets the sum.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = 1; off < lanes; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cosine_vote_cluster_kernel(const T* __restrict__ emb,
                               float* __restrict__ conf, int n, int d,
                               int n_valid, const int* __restrict__ counts,
                               float temperature, int cols, int vec) {
  // elements per 16 bytes; a tile row is cols + kVec elements long
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = cluster_rank();
  const int blocks = cluster_blocks();
  // barrier phase 0: this block has started (its shared memory exists)
  cluster_arrive_relaxed();
  if (counts != nullptr) n_valid = min(max(__ldg(counts + blockIdx.y), 0), n);
  if (n_valid == 0) {
    // every block of the cluster reads the same count and leaves here, so
    // no block waits on another; nothing touches distributed memory
    if (rank == 0)
      for (int i = threadIdx.x; i < n; i += kThreads)
        conf[static_cast<size_t>(blockIdx.y) * n + i] = 0.0f;
    return;
  }

  const int ld = cols + kVec;
  T* tile = reinterpret_cast<T*>(smem);  // [n_valid][ld]
  float* sq_all = reinterpret_cast<float*>(
      smem + static_cast<size_t>(n) * ld * sizeof(T));  // [blocks][n]
  float* off_all = sq_all + blocks * n;  // [blocks][n], block 0's
  float* inv_norm = off_all + blocks * n;  // [n]
  float* logits = inv_norm + n;  // [n], block 0's
  float* colsum = logits + n;  // [cols]

  const int tid = threadIdx.x;
  const int c0 = rank * cols;
  const int width = max(0, min(cols, d - c0));
  const T* x = emb + static_cast<size_t>(blockIdx.y) * n * d + c0;

  // The row passes give each live row `lanes` neighbouring lanes (the
  // most that lets every row in at once, up to a warp), each lane every
  // lanes-th 16 bytes of the row; pass p covers rows p * rows .. +rows.
  int lanes = 32;
  while (lanes > 1 && n_valid * lanes > kThreads) lanes >>= 1;
  const int rows = kThreads / lanes;
  const int sub = tid & (lanes - 1);
  const int vecs = cols / kVec;

  // 1. this block's columns of the live rows, read once into shared
  //    memory (zero past D), kInFlight 16-byte loads per thread issued
  //    together, each row's partial sum of squares taken on the way and
  //    stored into every block of the cluster at [rank][i]
  for (int base = 0; base < n_valid; base += rows) {
    const int i = base + tid / lanes;
    float s = 0.0f;
    if (i < n_valid) {
      const T* src = x + static_cast<size_t>(i) * d;
      T* dst = tile + i * ld;
      for (int v0 = sub; v0 < vecs; v0 += kInFlight * lanes) {
        uint4 q[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int v = v0 + u * lanes;
          q[u] = v < vecs ? load16(src, v * kVec, width, vec)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int v = v0 + u * lanes;
          if (v < vecs) *reinterpret_cast<uint4*>(dst + v * kVec) = q[u];
          float e[kVec];
          unpack(q[u], e);
#pragma unroll
          for (int h = 0; h < kVec; ++h) s = fmaf(e[h], e[h], s);
        }
      }
    }
    s = group_sum(s, lanes);
    if (base == 0) cluster_wait();  // every block has started
    if (i < n_valid)
      for (int c = sub; c < blocks; c += lanes)
        st_cluster(sq_all + rank * n + i, c, s);
  }
  cluster_arrive();
  cluster_wait();  // phase 1: every block's partials are in place

  // 2. inverse norms: the partials added in rank order, the same in every
  //    block
  for (int i = tid; i < n_valid; i += kThreads)
    inv_norm[i] = rsqrtf(rank_sum(sq_all + i, n, blocks) + 1e-12f);
  __syncthreads();

  // 3. column sum of the normalised live rows over this block's columns:
  //    `groups` neighbouring lanes per column, each over every groups-th
  //    row, added by shuffles
  int groups = 1;
  while (groups < 32 && 2 * groups * cols <= kThreads) groups *= 2;
  for (int base = 0; base < groups * cols; base += kThreads) {
    const int idx = base + tid;
    const int k = idx / groups;
    const int g = idx & (groups - 1);
    float s = 0.0f;
    if (k < cols) {
#pragma unroll 4
      for (int j = g; j < n_valid; j += groups)
        s = fmaf(to_f32(tile[j * ld + k]), inv_norm[j], s);
    }
    s = group_sum(s, groups);
    if (k < cols && g == 0) colsum[k] = s;
  }
  __syncthreads();

  // 4. each live row's partial dot - self, nx_i . (s - nx_i), stored into
  //    block 0 at [rank][i]
  for (int base = 0; base < n_valid; base += rows) {
    const int i = base + tid / lanes;
    float s = 0.0f;
    if (i < n_valid) {
      const T* row = tile + i * ld;
      const float inv = inv_norm[i];
#pragma unroll 4
      for (int v = sub; v < vecs; v += lanes) {
        float e[kVec];
        unpack(*reinterpret_cast<const uint4*>(row + v * kVec), e);
#pragma unroll
        for (int h = 0; h < kVec; ++h) {
          const float nx = e[h] * inv;
          s = fmaf(nx, colsum[v * kVec + h] - nx, s);
        }
      }
    }
    s = group_sum(s, lanes);
    if (i < n_valid && sub == 0) st_cluster(off_all + rank * n + i, 0, s);
  }
  // phase 2: the other blocks are done (nothing reads their shared memory
  // after phase 1) and leave; block 0 waits for their partials
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();

  // 5. block 0: the partials added in rank order, the logits
  //    ((dot - self) / max(n_valid - 1, 1)) / T, then in one warp the
  //    softmax over the live rows (max subtracted); rows past n_valid get 0
  const float denom = static_cast<float>(max(n_valid - 1, 1));
  for (int i = tid; i < n_valid; i += kThreads)
    logits[i] = (rank_sum(off_all + i, n, blocks) / denom) / temperature;
  __syncthreads();
  if (tid >= 32) return;
  const int lane = tid;
  float m = -CUDART_INF_F;
  for (int i = lane; i < n_valid; i += 32) m = fmaxf(m, logits[i]);
  m = warp_max(m);
  float s = 0.0f;
  for (int i = lane; i < n_valid; i += 32) {
    const float e = expf(logits[i] - m);
    logits[i] = e;
    s += e;
  }
  s = warp_sum(s);
  float* out = conf + static_cast<size_t>(blockIdx.y) * n;
  for (int i = lane; i < n; i += 32)
    out[i] = i < n_valid ? logits[i] / s : 0.0f;
}

// Once per instantiation and device: the largest dynamic shared memory
// and the non-portable cluster sizes (9-16).
template <typename T>
cudaError_t configure() {
  return sm90::once_per_device([] {
    cudaError_t e = cudaFuncSetAttribute(
        cosine_vote_cluster_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(cosine_vote_cluster_kernel<T>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  });
}

bool plan_ok(int n, int d, int cluster, int cols, size_t smem) {
  return cluster >= 1 && cluster <= kMaxCluster && cols > 0 &&
         cols % kColAlign == 0 &&
         static_cast<long long>(cluster) * cols >= d && n >= 1 &&
         smem <= static_cast<size_t>(kSmemLimit);
}

template <typename T>
int launch(const void* emb, void* conf, int r, int n, int d, int n_valid,
           const int* counts, float temperature, int cluster, int cols,
           cudaStream_t st) {
  const size_t smem = smem_bytes(n, cols, cluster, sizeof(T));
  if (!plan_ok(n, d, cluster, cols, smem) ||
      (counts == nullptr && (n_valid < 1 || n_valid > n)) || r < 1 ||
      r > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = configure<T>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, r, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int vec = d % (16 / sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  rc = cudaLaunchKernelEx(&cfg, cosine_vote_cluster_kernel<T>,
                          static_cast<const T*>(emb),
                          static_cast<float*>(conf), n, d, n_valid, counts,
                          temperature, cols, vec);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it: the return value reports it
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// emb: [r, n, d] contiguous, dtype 0 = f32, 1 = bf16; conf: [r, n] f32;
// counts: int32 [r] on the device, or null for the scalar n_valid.
// `cluster` blocks per request, `cols` columns per block (a multiple of 8,
// cluster * cols >= d): ops/kernels.py::vote_plan.  Returns the launch's
// error, else cudaGetLastError() after it.
extern "C" int lwc_cosine_vote_cluster(const void* emb, void* conf, int r,
                                       int n, int d, int n_valid,
                                       const void* counts, float temperature,
                                       int dtype, int cluster, int cols,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  if (dtype == 0)
    return launch<float>(emb, conf, r, n, d, n_valid, cnt, temperature,
                         cluster, cols, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(emb, conf, r, n, d, n_valid, cnt,
                                 temperature, cluster, cols, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a block takes for n rows of `cols` columns in
// a cluster of `cluster` blocks; vote_plan computes the same.
extern "C" long long lwc_cosine_vote_cluster_smem(int n, int cols,
                                                  int cluster, int dtype) {
  return static_cast<long long>(
      smem_bytes(n, cols, cluster, dtype == 0 ? sizeof(float) : 2));
}
