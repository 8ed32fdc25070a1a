// Residual add + LayerNorm and the GELU for Hopper (sm_90a): the encoder's
// element-wise passes, each one read and one write of every element in the
// activation dtype.
//
// Replaces no TPU kernel.  The JAX package leaves LayerNorm and GELU to
// XLA, which fuses each into one pass over the activations; the port's
// plain versions (ops/norm_act.py) run them as separate f32 torch kernels,
// about 12 for a LayerNorm and 25 for the bf16 GELU, each reading and
// writing 4 bytes an element.  These two kernels take their place on the
// card; the plain versions stay for the CPU and the trainers.
//
// What bounds them on the H100: device memory (3.35 TB/s).  Per token and
// layer at bge-large in bf16, add_layer_norm reads x and the residual and
// writes the output (3 x 2 KB, twice a layer) and gelu reads and writes
// the [tokens, 4096] intermediate (2 x 8 KB).  Both do a few tens of f32
// operations per element, under the card's f32 rate per byte moved.
//
// Design:
//  * lwc_add_layer_norm_kernel: one warp per row, 8 rows per block.  Each
//    lane loads its 16-byte vectors of x and of the residual once (lane l
//    takes vectors l, l + 32, ..., so a warp reads 512 contiguous bytes per
//    step) and keeps the row in registers (VPL vectors a lane, a template
//    constant: up to 2048 bf16 or 1024 f32 columns).  Σs and Σs² are
//    reduced across the warp with __shfl_xor_sync (each butterfly step adds
//    the same two values on both lanes, so every lane holds the same sums),
//    then each lane normalises its vectors and writes each with one 16-byte
//    store.  Nothing touches shared memory.
//  * lwc_gelu_kernel: one grid-stride pass of 16-byte vectors, loaded in
//    the activation dtype, computed in f32 by quant_epilogue.cuh's gelu (the
//    quantized GEMMs' epilogue GELU: A&S 7.1.26 for bf16, exact erf for
//    f32), stored once.  It may run in place (x == out): each element is
//    read and then written by the same thread and never read again, so the
//    MLP's dense output needs no second [rows, 4096] buffer in the graph
//    pool.
//
// Numerics are the plain versions', operation for operation (parity hazards
// 3 and 4): s = x + residual rounded to the activation dtype first; then in
// f32 the one-pass mean = Σs · (1/h), var = max(Σs²·(1/h) - mean², 0),
// rstd = rsqrtf(var + eps), out = ((s - mean) · rstd) · w + b, rounded
// once.  Every step is an __fadd_rn / __fmul_rn, so no FMA contraction
// changes a rounding.  Only the order of the two row sums differs from
// torch's reduction; never Welford.  1/h is the f32 factor torch's mean
// multiplies by.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "quant_epilogue.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxVecsPerLane = 8;
constexpr int kGeluThreads = 256;

// elements of T in one 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pair[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pair[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// an f32 value rounded to T and widened back
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int VPL, bool RES>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    lwc_add_layer_norm_kernel(const T* __restrict__ x,
                              const T* __restrict__ residual,
                              const T* __restrict__ weight,
                              const T* __restrict__ bias, T* __restrict__ out,
                              int rows, int h, float eps, float inv_h) {
  constexpr int V = vec_elems<T>();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = h / V;
  const size_t base = static_cast<size_t>(row) * h;
  float s[VPL][V];
  float sum = 0.0f, sumsq = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = i * 32 + lane;
    if (v < nvec) {
      load_vec(x + base + v * V, s[i]);
      if (RES) {
        float r[V];
        load_vec(residual + base + v * V, r);
#pragma unroll
        for (int j = 0; j < V; ++j)
          s[i][j] = round_to(__fadd_rn(s[i][j], r[j]), T());
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sum = __fadd_rn(sum, s[i][j]);
        sumsq = __fadd_rn(sumsq, __fmul_rn(s[i][j], s[i][j]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    sumsq = __fadd_rn(sumsq, __shfl_xor_sync(0xffffffffu, sumsq, o));
  }
  const float mean = __fmul_rn(sum, inv_h);
  const float var = __fsub_rn(__fmul_rn(sumsq, inv_h), __fmul_rn(mean, mean));
  // torch.clamp(min=0): a NaN stays NaN
  const float rstd = rsqrtf(__fadd_rn(var < 0.0f ? 0.0f : var, eps));
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = i * 32 + lane;
    if (v < nvec) {
      float w[V], b[V], y[V];
      load_vec(weight + v * V, w);
      load_vec(bias + v * V, b);
#pragma unroll
      for (int j = 0; j < V; ++j)
        y[j] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(s[i][j], mean), rstd), w[j]), b[j]);
      store_vec(out + base + v * V, y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGeluThreads)
    lwc_gelu_kernel(const T* x, T* out, long long n) {
  constexpr int V = vec_elems<T>();
  constexpr bool approx = std::is_same<T, __nv_bfloat16>::value;
  const long long nvec = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  for (long long v = first; v < nvec; v += stride) {
    float e[V];
    load_vec(x + v * V, e);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = quant_epilogue::gelu(e[j], approx);
    store_vec(out + v * V, e);
  }
  // the ragged tail, fewer than V elements
  const long long tail = nvec * V + first;
  if (tail < n) {
    narrow(out + tail, quant_epilogue::gelu(widen(x[tail]), approx));
  }
}

template <typename T, int VPL>
cudaError_t launch_layer_norm(const void* x, const void* residual,
                              const void* weight, const void* bias, void* out,
                              int rows, int h, float eps, cudaStream_t st) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
  const float inv_h = 1.0f / static_cast<float>(h);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(residual);
  const T* wt = static_cast<const T*>(weight);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (rt != nullptr)
    lwc_add_layer_norm_kernel<T, VPL, true>
        <<<grid, block, 0, st>>>(xt, rt, wt, bt, ot, rows, h, eps, inv_h);
  else
    lwc_add_layer_norm_kernel<T, VPL, false>
        <<<grid, block, 0, st>>>(xt, rt, wt, bt, ot, rows, h, eps, inv_h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t layer_norm(const void* x, const void* residual, const void* weight,
                       const void* bias, void* out, int rows, int h,
                       float eps, cudaStream_t st) {
  const int vpl = (h / vec_elems<T>() + 31) / 32;
  switch (vpl) {
#define LWC_LN_CASE(N)                                                  \
  case N:                                                               \
    return launch_layer_norm<T, N>(x, residual, weight, bias, out, rows, \
                                   h, eps, st);
    LWC_LN_CASE(1)
    LWC_LN_CASE(2)
    LWC_LN_CASE(3)
    LWC_LN_CASE(4)
    LWC_LN_CASE(5)
    LWC_LN_CASE(6)
    LWC_LN_CASE(7)
    LWC_LN_CASE(8)
#undef LWC_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t gelu(const void* x, void* out, long long n, cudaStream_t st) {
  const long long nvec = n / vec_elems<T>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM several times over; each thread then
  // walks the vectors a grid apart
  const long long want = (nvec + kGeluThreads - 1) / kGeluThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  const int blocks =
      static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  lwc_gelu_kernel<T><<<blocks, kGeluThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// x, residual (null: none), out: [rows, h] contiguous in dtype (0 = f32,
// 1 = bf16); weight, bias: [h] in the same dtype; every base 16-byte
// aligned and h a multiple of 8, at most 2048 (bf16) or 1024 (f32) columns.
// Returns cudaGetLastError() after the launch.
extern "C" int lwc_add_layer_norm(const void* x, const void* residual,
                                  const void* weight, const void* bias,
                                  void* out, int rows, int h, float eps,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || h <= 0 || h % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && h <= 4 * 32 * kMaxVecsPerLane)
    return static_cast<int>(
        layer_norm<float>(x, residual, weight, bias, out, rows, h, eps, st));
  if (dtype == 1 && h <= 8 * 32 * kMaxVecsPerLane)
    return static_cast<int>(layer_norm<__nv_bfloat16>(
        x, residual, weight, bias, out, rows, h, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, out: n contiguous elements in dtype (0 = f32, 1 = bf16), 16-byte
// aligned; out may be x.  Returns cudaGetLastError() after the launch.
extern "C" int lwc_gelu(const void* x, void* out, long long n, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(gelu<float>(x, out, n, st));
  if (dtype == 1) return static_cast<int>(gelu<__nv_bfloat16>(x, out, n, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
