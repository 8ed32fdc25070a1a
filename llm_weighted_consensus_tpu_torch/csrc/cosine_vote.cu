// Cosine self-consistency vote for Hopper (sm_90a).
//
// Replaces: llm_weighted_consensus_tpu/ops/kernels.py::fused_cosine_vote
// (the Pallas kernel _cosine_vote_kernel): rows L2-normalised by
// rsqrt(sum x^2 + 1e-12), the N x N f32 cosine Gram, each row's mean over
// the valid off-diagonal columns divided by max(n-1, 1) and by the
// temperature, then a softmax over the valid rows.  This kernel adds a
// leading request axis R and takes the temperature at run time, so one
// launch serves every coalesced request at every temperature.
//
// What bounds it on the H100: bytes.  At the serving shape (R=8, N=64,
// D=1024, bf16) the input is 1 MiB, a fraction of a microsecond at
// 3.35 TB/s; the N^2 D Gram would be 0.5 GFLOP of f32 FMA, far more than
// the data needs.  The design removes the Gram: for unit rows x_i,
//     sum_{j != i, j < n} x_i . x_j = x_i . (sum_{j < n} x_j) - x_i . x_i,
// so each row's mean off-diagonal cosine is one dot against the column
// sum of the normalised rows, O(N D) instead of O(N^2 D).  The sum is
// the same as the Gram's row sum up to f32 reassociation (absolute error
// ~1e-7 * n before the division by n-1).
//
// Per-request counts: with `counts` (int32 [r] on the device) request r
// votes over its own first counts[r] rows (clamped to [0, n]; 0 gives a
// request of zeros), so one launch serves streams of different lengths;
// with `counts` null every request takes the scalar `n_valid`, bit for bit
// as before the pointer existed.
//
// Layout: one block per request r.  Shared memory holds 2N + D floats
// (row inverse norms, logits, the column sum), never N x D; the loops over
// N and D run inside the block, so any N and D fit.  The input is read
// three times (norms, column sum, dots); at these sizes it stays in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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

// Block-wide reduction; every thread gets the result.  `scratch` holds
// kWarps floats and is free again when this returns.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = kMax ? -CUDART_INF_F : 0.0f;
  for (int w = 0; w < kWarps; ++w)
    r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cosine_vote_kernel(const T* __restrict__ emb, float* __restrict__ conf,
                       int n, int d, int n_valid,
                       const int* __restrict__ counts, float temperature) {
  if (counts != nullptr) n_valid = min(max(counts[blockIdx.x], 0), n);
  extern __shared__ float smem[];
  float* inv_norm = smem;       // [n]
  float* logits = smem + n;     // [n]
  float* colsum = smem + 2 * n; // [d]
  __shared__ float scratch[kWarps];

  const T* x = emb + static_cast<size_t>(blockIdx.x) * n * d;
  float* out = conf + static_cast<size_t>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. inverse row norms, one warp per row
  for (int i = warp; i < n; i += kWarps) {
    const T* row = x + static_cast<size_t>(i) * d;
    float s = 0.0f;
    for (int k = lane; k < d; k += 32) {
      const float v = to_f32(row[k]);
      s = fmaf(v, v, s);
    }
    s = warp_sum(s);
    if (lane == 0) inv_norm[i] = rsqrtf(s + 1e-12f);
  }
  __syncthreads();

  // 2. column sum of the normalised valid rows, one thread per column
  for (int k = threadIdx.x; k < d; k += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < n_valid; ++j)
      s = fmaf(to_f32(x[static_cast<size_t>(j) * d + k]), inv_norm[j], s);
    colsum[k] = s;
  }
  __syncthreads();

  // 3. mean off-diagonal cosine -> logit, one warp per row
  const float denom = static_cast<float>(max(n_valid - 1, 1));
  for (int i = warp; i < n; i += kWarps) {
    const T* row = x + static_cast<size_t>(i) * d;
    const float inv = inv_norm[i];
    float dot = 0.0f, self = 0.0f;
    for (int k = lane; k < d; k += 32) {
      const float v = to_f32(row[k]) * inv;
      dot = fmaf(v, colsum[k], dot);
      self = fmaf(v, v, self);
    }
    dot = warp_sum(dot);
    self = warp_sum(self);
    if (lane == 0)
      logits[i] = i < n_valid ? ((dot - self) / denom) / temperature
                              : -CUDART_INF_F;
  }
  __syncthreads();

  // 4. softmax over the valid rows (max subtracted); invalid rows get 0
  //    (and every row of a request with no valid row)
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < n_valid; i += kThreads)
    m = fmaxf(m, logits[i]);
  m = block_reduce<true>(m, scratch);
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float e = i < n_valid ? expf(logits[i] - m) : 0.0f;
    logits[i] = e;
    s += e;
  }
  s = block_reduce<false>(s, scratch);
  for (int i = threadIdx.x; i < n; i += kThreads)
    out[i] = i < n_valid ? logits[i] / s : 0.0f;
}

}  // namespace

// emb: [r, n, d] contiguous, dtype 0 = f32, 1 = bf16; conf: [r, n] f32;
// counts: int32 [r] on the device, or null for the scalar n_valid.
// Returns cudaGetLastError() after the launch.
extern "C" int lwc_cosine_vote(const void* emb, void* conf, int r, int n,
                               int d, int n_valid, const void* counts,
                               float temperature, int dtype, void* stream) {
  const int* cnt = static_cast<const int*>(counts);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(n) + d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(cosine_vote_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    cosine_vote_kernel<float><<<r, kThreads, smem, st>>>(
        static_cast<const float*>(emb), static_cast<float*>(conf), n, d,
        n_valid, cnt, temperature);
  } else if (dtype == 1) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(cosine_vote_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    cosine_vote_kernel<__nv_bfloat16><<<r, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(emb), static_cast<float*>(conf), n,
        d, n_valid, cnt, temperature);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
