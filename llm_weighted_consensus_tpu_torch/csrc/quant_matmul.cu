// W8A8 and W4A8 quantized dense layers for Hopper (sm_90a).
//
// Replaces: llm_weighted_consensus_tpu/ops/kernels.py::w8a8_matmul (the
// Pallas kernel _w8a8_kernel) and ::w4a8_matmul (_w4a8_kernel):
//   out = act(float(int8(x) @ int8(W)) * sx[row] * sw[col] + bias[col])
// with per-row dynamic activation scales sx = max(max|x|/127, 1e-12),
// per-output-channel weight scales sw, int32 accumulation (exact), an
// optional GELU (erf for f32 activations, A&S 7.1.26 for bf16) on the f32
// pre-activation, and one rounding to x's dtype.
//
// What bounds it on the H100: at the serving shapes (M = 65536 rows,
// (K, N) = (1024, 1024), (1024, 4096), (4096, 1024)) the int8 tensor cores
// (1,979 TOPS) for the two wide shapes and device memory (x read, out
// written) for the square one; PERF.md has the bounds beside the times.
//
// Routes: 16-byte aligned operands (every bge layer), for W8A8 with
// K % 16 == 0 and for W4A8 at any K, multiply in quant_gemm_sm90.cu
// (TMA + wgmma) after this file's row quantisation; quant_gemm_kernel
// below keeps the other K and unaligned operands.  Both share
// quant_epilogue.cuh.
//
// Design (a simple first version: mma.sync, no wgmma or TMA):
//  * Two kernels per call.  quantize_rows_kernel reads each row of x twice
//    (max|x|, then x / sx), one warp per row, and writes int8 rows padded
//    with zeros to Kp (a multiple of the 64-deep K tile) plus sx[M].  The
//    TPU kernel quantises inside the matmul because its row tile holds all
//    of K in VMEM; here a block's x rows over all of K would not fit in
//    shared memory, and re-quantising them once per N tile would repeat
//    the IEEE divisions N/128 times.
//  * quant_gemm_kernel: one block of 8 warps per 128 x 128 output tile, a
//    64-deep K loop over two shared-memory stages (the next tile's global
//    loads are in registers while the current one is multiplied), each
//    warp a 64 x 32 sub-tile of mma.sync.m16n8k32 s8 x s8 -> s32 fed by
//    ldmatrix (the int8 A and B fragments have the byte layout of the
//    16-bit ones).  Shared rows are 80 bytes, so ldmatrix is free of bank
//    conflicts.
//  * W is [N, K] int8 (K contiguous, the transpose of the JAX layout), or
//    for W4A8 [N, Kp/2] uint8 in the split-K biased-nibble layout of
//    pack_int4_weights: K tiles below Kp/2 read the low nibbles, tiles at
//    or above Kp/2 the high nibbles of the same bytes, unbiased by 8 while
//    the tile is written to shared memory.
//  * Ragged edges: rows past M and columns past N are masked; x past K is
//    quantised to 0, and int8 W past K is never read (bytes past K load as
//    0), so any K works (bge_micro has K = 96 and 192).
//  * Parity with the reference: IEEE division (__fdiv_rn) and round half
//    to even (__float2int_rn) in the quantisation; the epilogue is
//    ((acc * sx) * sw) + bias with __fmul_rn/__fadd_rn, so no FMA
//    contraction changes a rounding against the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "quant_epilogue.cuh"

namespace {

using quant_epilogue::dequant;
using quant_epilogue::store2;
using quant_epilogue::unbias_nibbles;

constexpr int kTM = 128;       // output rows per block
constexpr int kTN = 128;       // output columns per block
constexpr int kTK = 64;        // K bytes per stage
constexpr int kLD = kTK + 16;  // padded shared row: 80 bytes
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kQuantRows = 8;  // rows per block of the quantisation pass

// 8 consecutive elements of a row starting at `col`; elements at or past
// `k` read as 0.  `vec`: the row start is 16-byte aligned and k % 8 == 0.
__device__ __forceinline__ void load8(const float* row, int col, int k,
                                      bool vec, float (&v)[8]) {
  if (vec && col + 8 <= k) {
    const float4 a = *reinterpret_cast<const float4*>(row + col);
    const float4 b = *reinterpret_cast<const float4*>(row + col + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = col + i < k ? row[col + i] : 0.0f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int col,
                                      int k, bool vec, float (&v)[8]) {
  if (vec && col + 8 <= k) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + col);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = col + i < k ? __bfloat162float(row[col + i]) : 0.0f;
  }
}

// x[M, K] -> xq[M, Kp] int8 (zero past K), sx[M] f32; one warp per row.
// given: sx already holds each row's scale (a tensor-parallel shard of a
// row-split layer quantises its K/tp slice with the scale of the FULL row,
// max|x| taken across the shards), read instead of computed.
template <typename T>
__global__ void __launch_bounds__(32 * kQuantRows)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int m, int k, int kp,
                         bool vec, bool given) {
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // whole warps leave together
  const T* xr = x + static_cast<size_t>(row) * k;
  float s;
  if (given) {
    s = sx[row];
  } else {
    float amax = 0.0f;
    for (int c = lane * 8; c < k; c += 256) {
      float v[8];
      load8(xr, c, k, vec, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
    if (lane == 0) sx[row] = s;
  }
  int8_t* qr = xq + static_cast<size_t>(row) * kp;
  for (int c = lane * 8; c < kp; c += 256) {
    float v[8];
    load8(xr, c, k, vec, v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int q = __float2int_rn(__fdiv_rn(v[i], s));
      q = min(max(q, -127), 127);
      w[i >> 2] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// xq[M, Kp] int8 (Kp % 64 == 0) times W -> out[M, N] in T.  W4: w is
// [N, half] uint8 biased nibbles with Kp = 2 * half (ldw = half); else w
// is [N, K] int8 with row stride ldw = K; w_vec says w's rows are 16-byte
// aligned.
template <typename T, bool W4>
__global__ void __launch_bounds__(kThreads)
    quant_gemm_kernel(const int8_t* __restrict__ xq,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ sx,
                      const float* __restrict__ sw,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int m, int n, int k, int kp, int ldw, bool w_vec,
                      bool gelu_on, bool approx_gelu) {
  __shared__ __align__(16) uint8_t as[2][kTM * kLD];
  __shared__ __align__(16) uint8_t ws[2][kTN * kLD];

  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * kTM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 0..1: 64-row half of the tile
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const int half = kp / 2;

  // each thread moves two 16-byte chunks of A and two of W per stage
  uint4 ra[2], rw[2];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e >> 2;
      const int ch = (e & 3) * 16;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (m0 + r < m)
        ra[i] = *reinterpret_cast<const uint4*>(
            xq + static_cast<size_t>(m0 + r) * kp + k0 + ch);
      rw[i] = make_uint4(0, 0, 0, 0);
      if (n0 + r < n) {
        const uint8_t* wr = w + static_cast<size_t>(n0 + r) * ldw;
        if (W4) {
          // packed rows are ldw = Kp / 2 bytes, a multiple of 128: whole
          // 16-byte chunks, vector loads where the base is aligned
          const int b0 = (k0 < half ? k0 : k0 - half) + ch;
          if (w_vec) {
            rw[i] = *reinterpret_cast<const uint4*>(wr + b0);
          } else {
            uint32_t v[4] = {0u, 0u, 0u, 0u};
            for (int j = 0; j < 16; ++j)
              v[j >> 2] |= static_cast<uint32_t>(wr[b0 + j]) << (8 * (j & 3));
            rw[i] = make_uint4(v[0], v[1], v[2], v[3]);
          }
        } else if (w_vec && k0 + ch + 16 <= k) {
          rw[i] = *reinterpret_cast<const uint4*>(wr + k0 + ch);
        } else {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          for (int j = 0; j < 16 && k0 + ch + j < k; ++j)
            v[j >> 2] |= static_cast<uint32_t>(wr[k0 + ch + j]) << (8 * (j & 3));
          rw[i] = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  };
  auto store_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e >> 2;
      const int ch = (e & 3) * 16;
      *reinterpret_cast<uint4*>(&as[stage][r * kLD + ch]) = ra[i];
      uint4 v = rw[i];
      if (W4) {
        const bool hi = k0 >= half;
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          u[j] = unbias_nibbles(hi ? (u[j] >> 4) : u[j]);
      }
      *reinterpret_cast<uint4*>(&ws[stage][r * kLD + ch]) = v;
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  const int nk = kp / kTK;
  load_stage(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    store_stage(stage, kt * kTK);
    __syncthreads();
    if (kt + 1 < nk) load_stage((kt + 1) * kTK);
    const uint8_t* a_s = as[stage];
    const uint8_t* w_s = ws[stage];
#pragma unroll
    for (int ks = 0; ks < kTK / 32; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16 + (lane & 15);
        const int col = ks * 32 + (lane >> 4) * 16;
        ldsm_x4(af[mt], smem_addr(a_s + row * kLD + col));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        const int row = wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = ks * 32 + ((lane >> 3) & 1) * 16;
        ldsm_x4(bf, smem_addr(w_s + row * kLD + col));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_s8(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_s8(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // epilogue: ((acc * sx) * sw) + bias, GELU, one rounding to T
  const int g = lane >> 2;
  const int c = lane & 3;
  const bool pair_ok = (n % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm * 64 + mt * 16 + g + r * 8;
      if (row >= m) continue;
      const float s_row = sx[row];
      T* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * c;
        if (col >= n) continue;
        const bool both = col + 1 < n;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = both || e == 0 ? col + e : col;
          v[e] = dequant(acc[mt][nt][2 * r + e], s_row, sw[cc], bias[cc],
                         gelu_on, approx_gelu);
        }
        store2(orow + col, v[0], v[1], both, both && pair_ok);
      }
    }
  }
}

template <typename T>
int quantize(const void* x, void* xq, void* sx, int m, int k, int kp,
             bool given, cudaStream_t stream) {
  const bool vec =
      k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int blocks = (m + kQuantRows - 1) / kQuantRows;
  quantize_rows_kernel<T><<<blocks, 32 * kQuantRows, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), m, k, kp, vec, given);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool W4>
int gemm(const void* xq, const void* w, const void* sx, const void* sw,
         const void* bias, void* out, int m, int n, int k, int kp, int ldw,
         int gelu_on, cudaStream_t stream) {
  const bool w_vec =
      ldw % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  quant_gemm_kernel<T, W4><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<T*>(out), m, n, k, kp,
      ldw, w_vec, gelu_on != 0, sizeof(T) == 2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [m, k] contiguous, dtype 0 = f32, 1 = bf16.  xq: [m, kp] int8 with
// kp a multiple of 64 and >= k (written, zero past k).  sx: [m] f32,
// written, or with given = 1 read: the rows' scales, computed elsewhere.
// Returns cudaGetLastError() after the launch.
extern "C" int lwc_quantize_rows(const void* x, void* xq, void* sx, int m,
                                 int k, int kp, int dtype, int given,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp % kTK != 0 || kp < k) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return quantize<float>(x, xq, sx, m, k, kp, given, st);
  if (dtype == 1)
    return quantize<__nv_bfloat16>(x, xq, sx, m, k, kp, given, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// xq: [m, kp] int8 from lwc_quantize_rows; sx: [m] f32.  int4 = 0: w is
// [n, k] int8 contiguous (ldw = k).  int4 = 1: w is [n, kp / 2] uint8
// biased nibbles (ldw = kp / 2, a multiple of 128).  sw, bias: [n] f32.
// out: [m, n] contiguous in dtype (0 = f32, 1 = bf16).  gelu: 1 applies
// the GELU (erf for f32, A&S 7.1.26 for bf16).  Returns
// cudaGetLastError() after the launch.
extern "C" int lwc_quant_matmul(const void* xq, const void* w, const void* sx,
                                const void* sw, const void* bias, void* out,
                                int m, int n, int k, int kp, int int4,
                                int gelu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp % kTK != 0 || kp < k) return static_cast<int>(cudaErrorInvalidValue);
  if (int4 && (kp / 2) % kTK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldw = int4 ? kp / 2 : k;
#define LWC_QMM_CASE(DT, T, W4)                                              \
  if (dtype == DT && (int4 != 0) == W4)                                      \
    return gemm<T, W4>(xq, w, sx, sw, bias, out, m, n, k, kp, ldw, gelu, st);
  LWC_QMM_CASE(0, float, false)
  LWC_QMM_CASE(0, float, true)
  LWC_QMM_CASE(1, __nv_bfloat16, false)
  LWC_QMM_CASE(1, __nv_bfloat16, true)
#undef LWC_QMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
