// Encoder multi-head attention for Hopper (sm_90a), padded and packed.
//
// Replaces: llm_weighted_consensus_tpu/ops/attention.py::fused_attention_tiled
// (the Pallas kernel _attn_kernel_tiled): softmax(Q K^T * scale + bias) V
// with an additive key bias [b, s] (0 for real tokens, -1e9 for padding),
// logits and softmax in f32, f32 accumulation, output in q's dtype.
// Entry point lwc_attention.
//
// And, as the SEG variant of the same two kernels (entry point
// lwc_attention_seg), ops/attention.py:147-233, fused_attention_tiled_seg
// (the Pallas kernel _attn_kernel_tiled_seg) of the packed serving path:
// many sequences laid end to end in one row, int32 segment_ids [b, s]
// (0 = pad slot).  Query i sees key j iff seg[i] == seg[j] && seg[j] > 0;
// a masked logit is REPLACED by -1e9 (a select, not an add), so a pad
// query row (every logit -1e9) softmaxes to the uniform mean of V, as in
// JAX.  What bounds it at the packed bucket (b=8 rows of s=512 tokens,
// nh=16, hd=64, bf16): bytes, barely.  q/k/v/out are 33.6 MB (0.0100 ms
// at 3.35 TB/s) against at most 4 b nh s^2 hd = 8.6 GFLOP (0.0087 ms at
// 989 TFLOP/s), and the same-segment blocks the data needs are fewer.
// The design keeps the traffic at that minimum: the int32 key-segment
// tile takes the place of the f32 bias tile (the same 4 bytes per key),
// each thread keeps the segment ids of its query rows in registers, and
// the mask is one compare per logit; no [b, s, s] mask or bias exists in
// device memory.  Key tiles whose every key is masked are still computed
// (skipping them would change the pad query rows; later work).
//
// What bounds it on the H100: bytes.  At the main path's [b, s] = [512,
// 128] (nh=16, hd=64, bf16) one call does 4 b nh s^2 hd = 34 GFLOP
// (0.035 ms at 989 TFLOP/s) against 537 MB of q/k/v/out traffic (0.160 ms
// at 3.35 TB/s): 64 FLOP per byte, below the card's bf16 ridge of about
// 295 FLOP per byte.  The ratio grows with s (s/2 FLOP per byte), so
// only past s ~ 600 would the tensor cores bound it.  Every bf16 hd-64
// call in row-major order (every bge-base and bge-large encoder call)
// takes attention_sm90.cu's TMA + wgmma kernel instead, which reads each
// operand once; this file keeps the other cases, two paths chosen from
// the inputs:
//  * bf16 with hd in {16, 32, 64} and 16-byte aligned rows: both products
//    on the tensor cores with mma.sync (namespace mma below);
//  * f32 (no TF32: the reference keeps f32 logits exact), hd 24 and
//    unaligned views: the same algorithm on the f32 FMA pipes
//    (67 TFLOP/s), one query row per thread.
// Both are simple first versions (no wgmma, TMA or warp specialisation);
// their times on the card are in PERF.md beside the bound.
//
// Design (FMA path; the mma path below keeps the same contract):
//  * No head transposes.  q/k/v are read straight from the encoder's
//    [b, s, nh, hd] layout through their strides (the last axis must be
//    contiguous); the output is written in the same layout.  The JAX
//    version pays a [b, s, nh, hd] -> [b*nh, s, hd] transpose per operand
//    around its kernel.
//  * One block per (batch, head, 64-query tile); one thread owns one
//    query row: its q row and its f32 accumulator live in registers, so
//    the online softmax needs no cross-thread reduction.
//  * Keys and values stream through shared memory in 64-key tiles,
//    widened to f32 on load.  Every thread reads the same key element at
//    once (a broadcast, no bank conflicts), 16 bytes at a time.
//  * Online softmax with an f32 running max and sum, rescaled every 16
//    keys.  Masked keys carry the -1e9 bias, never -inf, so a row whose
//    keys are all masked softmaxes to the uniform average, as in JAX.
//  * s is any length: the ragged last tile is zero-filled and its
//    missing keys get probability 0; query rows past s do not write.
//  * hd is a template parameter: 16, 24, 32 or 64 (the presets, the
//    test-size configs and the committed bge_micro fixture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBQ = 64;     // queries (threads) per block
constexpr int kBK = 64;     // keys per shared-memory tile
constexpr int kChunk = 16;  // keys per online-softmax step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// SEG false: `mask` is the f32 key bias [b, s]; SEG true: the int32
// segment ids [b, s] of the packed layout (both kernels below)
template <typename T, int HD, bool SEG>
__global__ void __launch_bounds__(kBQ)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const void* __restrict__ mask,
                     T* __restrict__ out, int s, int nh, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, float scale) {
  __shared__ __align__(16) float ks[kBK][HD];
  __shared__ __align__(16) float vs[kBK][HD];
  __shared__ float bs[kBK];  // key bias tile (SEG false)
  __shared__ int ss[kBK];    // key segment-id tile (SEG true)

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const int qi = blockIdx.y * kBQ + threadIdx.x;
  const bool active = qi < s;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* bias_row = static_cast<const float*>(mask) + static_cast<size_t>(b) * s;
  const int* seg_row = static_cast<const int*>(mask) + static_cast<size_t>(b) * s;
  const int sq = (SEG && active) ? seg_row[qi] : 0;  // this row's segment

  float qr[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? to_f32(qb[qi * q_ss + d]) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -CUDART_INF_F;  // running max of this row's logits
  float l = 0.0f;           // running sum of exp(logit - m)

  for (int k0 = 0; k0 < s; k0 += kBK) {
    const int kn = min(kBK, s - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kBK * HD; e += kBQ) {
      const int j = e / HD;
      const int d = e - j * HD;
      float kv = 0.0f, vv = 0.0f;
      if (j < kn) {
        kv = to_f32(kb[(k0 + j) * k_ss + d]);
        vv = to_f32(vb[(k0 + j) * v_ss + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    for (int j = threadIdx.x; j < kBK; j += kBQ) {
      if constexpr (SEG)
        ss[j] = j < kn ? seg_row[k0 + j] : 0;
      else
        bs[j] = j < kn ? bias_row[k0 + j] : 0.0f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kChunk) {
      float lg[kChunk];
      float cm = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        float x = -CUDART_INF_F;  // keys past s
        if (j < kn) {
          if constexpr (SEG)
            x = (ss[j] == sq && ss[j] > 0) ? dot * scale : -1e9f;
          else
            x = dot * scale + bs[j];
        }
        lg[jj] = x;
        cm = fmaxf(cm, x);
      }
      const float mn = fmaxf(m, cm);
      const float corr = expf(m - mn);  // 0 on the first step (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(lg[jj] - mn);  // 0 for keys past s
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(&vs[j0 + jj][0]);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = mn;
    }
  }

  if (active) {
    const float inv = 1.0f / l;
    T* o = out + ((static_cast<size_t>(b) * s + qi) * nh + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) store(o + d, acc[d] * inv);
  }
}

template <typename T, int HD, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int b, int s, int nh, const long long* st, float scale,
           cudaStream_t stream) {
  const dim3 grid(b * nh, (s + kBQ - 1) / kBQ);
  attention_kernel<T, HD, SEG><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), s, nh, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Tensor-core path: bf16 q/k/v, hd in {16, 32, 64}, 16-byte aligned rows.
//
// The same online softmax, with both products on the tensor cores through
// mma.sync.m16n8k16 (bf16 inputs, f32 accumulation).  One block of four
// warps takes 64 queries; each warp owns 16 query rows, keeps its Q
// fragments in registers, and walks the keys in 64-key shared-memory
// tiles: S = Q K^T into f32 accumulators, scale + bias (or the segment
// select) + ragged-edge mask,
// running max and sum per row (the four lanes of a quad share a row),
// then P (rounded to bf16, as the reference rounds its probabilities to
// v's dtype) times V from the accumulators' registers.  Shared rows are
// padded by 8 elements so ldmatrix reads are free of bank conflicts.
// ---------------------------------------------------------------------------

namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // queries per block
constexpr int kBK = 64;           // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, n) of a [rows, HD] tile from global (row stride `ld` elements)
// into shared memory (row stride LD); rows past `valid` are zero
template <int HD, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int n, int valid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int ch = e - r * kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * ld + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + ch * 8) = val;
  }
}

template <int HD, bool SEG>
__global__ void __launch_bounds__(kThreads)
    attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const void* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out, int s, int nh,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale) {
  constexpr int LD = HD + 8;
  constexpr int kSteps = HD / 16;  // k-steps of Q K^T
  constexpr int kDTiles = HD / 8;  // n-tiles of P V
  constexpr int kNTiles = kBK / 8; // n-tiles of Q K^T
  __shared__ __align__(16) __nv_bfloat16 qs[kBQ * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * LD];
  __shared__ float bs[kBK];  // key bias tile (SEG false)
  __shared__ int ss[kBK];    // key segment-id tile (SEG true)

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int c = lane & 3;   // accumulator column pair
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const float* bias_row = static_cast<const float*>(mask) + static_cast<size_t>(b) * s;
  const int* seg_row = static_cast<const int*>(mask) + static_cast<size_t>(b) * s;
  // the segments of this thread's two query rows (g and g + 8 of the
  // warp's 16); rows past s are pad slots
  int sq[2] = {0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + warp * 16 + g + r * 8;
      sq[r] = qi < s ? seg_row[qi] : 0;
    }
  }

  load_tile<HD, LD>(qs, qb + q0 * q_ss, q_ss, kBQ, s - q0);
  __syncthreads();
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = st * 16 + (lane >> 4) * 8;
    ldsm_x4(qf[st], smem_addr(&qs[row * LD + col]));
  }

  float o[kDTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDTiles; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  for (int k0 = 0; k0 < s; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<HD, LD>(ks, kb + k0 * k_ss, k_ss, kBK, s - k0);
    load_tile<HD, LD>(vs, vb + k0 * v_ss, v_ss, kBK, s - k0);
    for (int j = threadIdx.x; j < kBK; j += kThreads) {
      if constexpr (SEG)
        ss[j] = k0 + j < s ? seg_row[k0 + j] : 0;
      else
        bs[j] = k0 + j < s ? bias_row[k0 + j] : 0.0f;
    }
    __syncthreads();

    float sc[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t b0, b1;
        const int row = nt * 8 + (lane & 7);
        const int col = st * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x2(b0, b1, smem_addr(&ks[row * LD + col]));
        mma_bf16(sc[nt], qf[st], b0, b1);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * c + (e & 1);
        float x = -CUDART_INF_F;  // keys past s
        if (k0 + col < s) {
          if constexpr (SEG) {
            const int sk = ss[col];
            x = (sk == sq[e >> 1] && sk > 0) ? sc[nt][e] * scale : -1e9f;
          } else {
            x = sc[nt][e] * scale + bs[col];
          }
        }
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = expf(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int nd = 0; nd < kDTiles; ++nd) {
        o[nd][2 * r] *= corr;
        o[nd][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m[e >> 1]);  // 0 past s
        sc[nt][e] = p;
        l[e >> 1] += p;
      }
    }

#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {
          pack_bf16(sc[2 * j][0], sc[2 * j][1]),
          pack_bf16(sc[2 * j][2], sc[2 * j][3]),
          pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
          pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < kDTiles; ++nd) {
        uint32_t b0, b1;
        const int row = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x2_trans(b0, b1, smem_addr(&vs[row * LD + nd * 8]));
        mma_bf16(o[nd], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + warp * 16 + g + r * 8;
    if (qi < s) {
      const float inv = 1.0f / l[r];
      __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * s + qi) * nh + h) * HD;
#pragma unroll
      for (int nd = 0; nd < kDTiles; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * c) =
            __floats2bfloat162_rn(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
    }
  }
}

template <int HD, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int b, int s, int nh, const long long* st, float scale,
           cudaStream_t stream) {
  const dim3 grid(b * nh, (s + kBQ - 1) / kBQ);
  attention_mma_kernel<HD, SEG><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(out), s, nh, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads need every row start of q/k/v 16-byte aligned
bool aligned(const void* q, const void* k, const void* v,
             const long long* st) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8) return false;
  return true;
}

}  // namespace mma

// the mma path where it applies, else the FMA path; SEG picks the mask
template <bool SEG>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             void* out, int b, int s, int nh, int hd, const long long* st,
             float scale, int dtype, cudaStream_t stream) {
  if (dtype == 1 && mma::aligned(q, k, v, st)) {
    if (hd == 64)
      return mma::launch<64, SEG>(q, k, v, mask, out, b, s, nh, st, scale, stream);
    if (hd == 32)
      return mma::launch<32, SEG>(q, k, v, mask, out, b, s, nh, st, scale, stream);
    if (hd == 16)
      return mma::launch<16, SEG>(q, k, v, mask, out, b, s, nh, st, scale, stream);
  }
#define LWC_ATTN_CASE(DT, T, HD)                                            \
  if (dtype == DT && hd == HD)                                              \
    return launch<T, HD, SEG>(q, k, v, mask, out, b, s, nh, st, scale, stream);
  LWC_ATTN_CASE(0, float, 16)
  LWC_ATTN_CASE(0, float, 24)
  LWC_ATTN_CASE(0, float, 32)
  LWC_ATTN_CASE(0, float, 64)
  LWC_ATTN_CASE(1, __nv_bfloat16, 16)
  LWC_ATTN_CASE(1, __nv_bfloat16, 24)
  LWC_ATTN_CASE(1, __nv_bfloat16, 32)
  LWC_ATTN_CASE(1, __nv_bfloat16, 64)
#undef LWC_ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/k/v: [b, s, nh, hd] with element strides (batch, seq, head) given in
// `strides` as {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h}; the hd axis
// is contiguous.  bias: [b, s] f32 contiguous.  out: [b, s, nh, hd]
// contiguous in q's dtype.  dtype 0 = f32, 1 = bf16; hd 16, 24, 32, 64.
// Returns cudaGetLastError() after the launch.
extern "C" int lwc_attention(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int b, int s,
                             int nh, int hd, const long long* strides,
                             float scale, int dtype, void* stream) {
  return dispatch<false>(q, k, v, bias, out, b, s, nh, hd, strides, scale,
                         dtype, static_cast<cudaStream_t>(stream));
}

// The packed twin: as lwc_attention, with segment_ids [b, s] int32
// contiguous (0 = pad slot) in place of the bias.
extern "C" int lwc_attention_seg(const void* q, const void* k, const void* v,
                                 const void* segment_ids, void* out, int b,
                                 int s, int nh, int hd,
                                 const long long* strides, float scale,
                                 int dtype, void* stream) {
  return dispatch<true>(q, k, v, segment_ids, out, b, s, nh, hd, strides,
                        scale, dtype, static_cast<cudaStream_t>(stream));
}
