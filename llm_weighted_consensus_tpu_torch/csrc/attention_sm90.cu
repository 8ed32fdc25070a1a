// Padded encoder attention on Hopper's TMA and wgmma (sm_90a), bf16, hd 64.
// Entry point lwc_attention_tma.
//
// Replaces: llm_weighted_consensus_tpu/ops/attention.py::fused_attention_tiled
// (the Pallas kernel _attn_kernel_tiled): softmax(Q K^T * scale + bias) V
// with an additive f32 key bias [b, s] (0 for real tokens, -1e9 for
// padding), f32 logits and softmax, probabilities rounded to bf16 (v's
// dtype) before P V, f32 accumulation, bf16 output.  It takes every
// encoder call of bge-base and bge-large on the card: q/k/v are the
// [b, s, nh, hd] views of the dense outputs (16-byte aligned, strides
// multiples of 16 bytes, in any order), any s.  attention.cu keeps
// hd 16/24/32, f32, unaligned views and the segment-masked variant.
//
// What bounds it on the H100: bytes.  At the main path's [b, s] = [512,
// 128] (nh 16) one call reads q, k, v and writes out, 537 MB (0.160 ms at
// 3.35 TB/s), and does 4 b nh s^2 hd = 34 GFLOP (0.035 ms at 989 TFLOP/s
// bf16): 64 FLOP per byte, below the card's bf16 ridge of about 295.  So
// the design reads each operand once and keeps the copies in flight:
//  * Work item (batch, head, 128-query block); one persistent block per SM
//    walks the items, so at s <= 128 a head's K and V come from device
//    memory once (the mma.sync kernel's 64-query blocks read them twice,
//    at s = 512 eight times).
//  * Warp specialisation: warpgroup 0 is the producer (one thread issues
//    TMA copies, cp.async.bulk.tensor, through one 4-d tensor map per
//    operand over the strided [b, s, nh, hd] layout; rows past s arrive
//    as zeros), warpgroups 1 and 2 consume 64 query rows each.
//  * Q tiles (3 buffers) and K/V tiles of 128 keys x 64 hd (a 3-stage
//    ring) all with 128-byte swizzle (one hd row of bf16 is one 128-byte
//    row) and a full and an empty mbarrier per buffer, so the next two
//    items' Q, K and V load while the current one computes.
//  * S = Q K^T: wgmma.mma_async m64n128k16, both operands in shared
//    memory, K-major.  The key bias is read while it runs.
//  * Online softmax in f32 as attention.cu's, in base 2 (log2(e) folded
//    into the scale and the bias, ex2.approx in place of exp): scale, + bias (a
//    masked key carries -1e9, never -inf, so an all-pad row softmaxes to
//    the uniform mean of V), keys past s get -inf (probability 0).
//  * O += P V: P is rounded to bf16 in registers and repacked from the S
//    accumulator layout into wgmma's A-fragment layout (the same
//    per-warp layout); V stays in shared memory as an MN-major B operand
//    (hd contiguous: the descriptor's transpose bit).
//  * Output: O / l in bf16, stored from registers in column pairs.
//  * setmaxnreg: 40 registers for the producer, 232 for the consumers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int kHD = 64;
constexpr int kBQ = 128;  // queries per work item (2 consumers x 64)
constexpr int kBK = 128;  // keys per K/V tile
constexpr int kQBufs = 3;   // Q tiles in flight (work items ahead)
constexpr int kStages = 3;  // K/V tile pairs in flight
constexpr int kThreads = 384;
constexpr int kTileBytes = kBQ * kHD * 2;  // 16 KB: Q, K and V tiles alike
// Q, K, V and the output staging tile; the key-bias tiles; barriers; room
// to align the base to 1024
constexpr int kSmem = (kQBufs + 2 * kStages + 1) * kTileBytes +
                      kStages * kBK * 4 + 2 * (kQBufs + kStages) * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (one instruction; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap o_map,
                         const float* __restrict__ bias, int b, int s, int nh,
                         float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* q_s = smem;                        // [kQBufs][kTileBytes]
  uint8_t* k_s = q_s + kQBufs * kTileBytes;   // [kStages][kTileBytes]
  uint8_t* v_s = k_s + kStages * kTileBytes;  // [kStages][kTileBytes]
  uint8_t* o_s = v_s + kStages * kTileBytes;  // [kTileBytes]: 2 x 64 rows
  float* b_s = reinterpret_cast<float*>(o_s + kTileBytes);  // [kStages][kBK]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(b_s + kStages * kBK);
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* kv_full = q_empty + kQBufs;
  uint64_t* kv_empty = kv_full + kStages;

  const int q_blocks = (s + kBQ - 1) / kBQ;
  const int n_kt = (s + kBK - 1) / kBK;
  const int items = b * nh * q_blocks;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      sm90::mbar_init(&q_full[i], 1);
      sm90::mbar_init(&q_empty[i], kThreads - 128);
    }
    for (int i = 0; i < kStages; ++i) {
      // the TMA transaction's arrival and one per producer lane (bias)
      sm90::mbar_init(&kv_full[i], 1 + 32);
      sm90::mbar_init(&kv_empty[i], kThreads - 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: warp 0 (lane 0 issues the TMA copies, every lane copies
    // its share of the key bias) ------------------------------------------
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int qbuf = 0, st = 0;
      uint32_t qphase = 0, ph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item / q_blocks;
        const int qb = item - bh * q_blocks;
        const int bb = bh / nh;
        const int h = bh - bb * nh;
        const float* brow = bias + static_cast<size_t>(bb) * s;
        if (lane == 0) {
          sm90::mbar_wait(&q_empty[qbuf], qphase ^ 1);
          sm90::mbar_expect_tx(&q_full[qbuf], kTileBytes);
          sm90::tma_load_4d(q_s + qbuf * kTileBytes, &q_map, &q_full[qbuf], 0,
                            h, qb * kBQ, bb);
        }
        for (int kt = 0; kt < n_kt; ++kt) {
          sm90::mbar_wait(&kv_empty[st], ph ^ 1);
          if (lane == 0) {
            sm90::mbar_expect_tx(&kv_full[st], 2 * kTileBytes);
            sm90::tma_load_4d(k_s + st * kTileBytes, &k_map, &kv_full[st], 0,
                              h, kt * kBK, bb);
            sm90::tma_load_4d(v_s + st * kTileBytes, &v_map, &kv_full[st], 0,
                              h, kt * kBK, bb);
          }
          // the tile's key bias in base 2; keys past s get -inf
#pragma unroll
          for (int j = lane; j < kBK; j += 32) {
            const int key = kt * kBK + j;
            b_s[st * kBK + j] = key < s ? brow[key] * kLog2e : -CUDART_INF_F;
          }
          sm90::mbar_arrive(&kv_full[st]);
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
        }
        if (++qbuf == kQBufs) {
          qbuf = 0;
          qphase ^= 1;
        }
      }
    }
  } else {
    // -- consumers ----------------------------------------------------------
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;        // which 64 query rows of the item
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) >> 2;  // accumulator row (and row + 8)
    const int c = t & 3;          // accumulator column pair
    // logits in base 2: exp(x) = exp2(x log2(e)), log2(e) folded into the
    // scale and the bias
    const float scale2 = scale * kLog2e;
    uint8_t* o_tile = o_s + cw * 64 * kHD * 2;
    int qbuf = 0, st = 0;
    uint32_t qphase = 0, ph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int bh = item / q_blocks;
      const int qb = item - bh * q_blocks;
      const int bb = bh / nh;
      const int h = bh - bb * nh;
      const uint8_t* q_tile = q_s + qbuf * kTileBytes + cw * 64 * kHD * 2;
      sm90::mbar_wait(&q_full[qbuf], qphase);

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.0f;
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

      for (int kt = 0; kt < n_kt; ++kt) {
        sm90::mbar_wait(&kv_full[st], ph);
        const uint8_t* k_tile = k_s + st * kTileBytes;
        const uint8_t* v_tile = v_s + st * kTileBytes;

        // S = Q K^T, 64 rows x 128 keys, accumulator layout: sc[4j + 2i +
        // e] is row g + 8i of the warp's 16, key 8j + 2c + e
        float sc[64];
        sm90::fence_operands(sc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHD / 16; ++kk)
          sm90::wgmma_m64n128k16_bf16_ss(sc, sm90::desc_kmajor(q_tile + kk * 32),
                                         sm90::desc_kmajor(k_tile + kk * 32),
                                         kk > 0 ? 1 : 0);
        sm90::wgmma_commit();
        // the bias of this thread's 32 keys while the product runs
        float2 bk[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          bk[j] = *reinterpret_cast<const float2*>(&b_s[st * kBK + 8 * j + 2 * c]);
        sm90::wgmma_wait<0>();
        sm90::fence_operands(sc);
        if (kt == n_kt - 1) sm90::mbar_arrive(&q_empty[qbuf]);

        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float x0 = sc[4 * j + 2 * i] * scale2 + bk[j].x;
            const float x1 = sc[4 * j + 2 * i + 1] * scale2 + bk[j].y;
            sc[4 * j + 2 * i] = x0;
            sc[4 * j + 2 * i + 1] = x1;
            mx[i] = fmaxf(mx[i], fmaxf(x0, x1));
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float corr = ex2(m[i] - mx[i]);  // 0 on the first tile
          m[i] = mx[i];
          l[i] *= corr;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[4 * j + 2 * i] *= corr;
            o[4 * j + 2 * i + 1] *= corr;
          }
        }
        // P in bf16 as wgmma A fragments: keys 16kk .. 16kk + 15 are the
        // accumulator's column groups 2kk and 2kk + 1
        uint32_t pa[8][4];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float p[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            p[x] = ex2(sc[4 * j + x] - m[x >> 1]);  // 0 past s
            l[x >> 1] += p[x];
          }
          pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
          pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
        }

        // O += P V over the tile's 128 keys
        sm90::fence_operands(o);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          sm90::wgmma_m64n64k16_bf16_rs(
              o, pa[kk], sm90::desc_mnmajor(v_tile + kk * 16 * kHD * 2), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operands(o);
        // the A fragments stay live (in place) until the products read them
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(pa[kk][x])::"memory");
        sm90::mbar_arrive(&kv_empty[st]);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }

      // O / l into this warpgroup's 64 x 64 staging tile (128-byte swizzle:
      // the 16-byte chunk j of row r sits at chunk j ^ (r % 8)), then one
      // TMA store; rows past s are clipped by the map
      if (t == 0) sm90::bulk_wait_read();  // the last item's store has read
      sm90::named_barrier(1 + cw, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = 1.0f / l[i];
        const int r = warp * 16 + g + 8 * i;  // r % 8 == g
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(o_tile + r * 128 + ((j ^ g) << 4) +
                                       4 * c) =
              pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
      sm90::fence_async_shared();
      sm90::named_barrier(1 + cw, 128);
      if (t == 0) {
        sm90::tma_store_4d(&o_map, o_tile, 0, h, qb * kBQ + cw * 64, bb);
        sm90::bulk_commit();
      }
      if (++qbuf == kQBufs) {
        qbuf = 0;
        qphase ^= 1;
      }
    }
    if (t == 0) sm90::bulk_wait_read();  // before the block's memory goes
  }
}

// one [b, s, nh, 64] bf16 operand as a 4-d map (hd, nh, s, b), boxes of
// 64 hd x 1 head x `rows` rows x 1 batch
int operand_map(CUtensorMap* map, const void* base, int b, int s, int nh,
                const long long* st, uint32_t rows) {
  const uint64_t dims[4] = {kHD, static_cast<uint64_t>(nh),
                            static_cast<uint64_t>(s), static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                               static_cast<uint64_t>(st[1]) * 2,
                               static_cast<uint64_t>(st[0]) * 2};
  const uint32_t box[4] = {kHD, 1, rows, 1};
  return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                          dims, strides, box);
}

}  // namespace

// As lwc_attention (attention.cu), for bf16 (dtype 1) and hd 64 only:
// q/k/v [b, s, nh, 64] with element strides {q_b, q_s, q_h, k_b, k_s, k_h,
// v_b, v_s, v_h}, each a multiple of 8 (in any order), base
// pointers 16-byte aligned; bias [b, s] f32 contiguous; out [b, s, nh, 64]
// bf16 contiguous and 16-byte aligned.  Anything else returns
// cudaErrorInvalidValue without a launch.  Returns cudaGetLastError()
// after the launch.
extern "C" int lwc_attention_tma(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int b, int s,
                                 int nh, int hd, const long long* strides,
                                 float scale, int dtype, void* stream) {
  if (hd != kHD || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* ops[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc =
        operand_map(&maps[i], ops[i], b, s, nh, strides + 3 * i, kBQ);
    if (rc) return rc;
  }
  const long long out_strides[3] = {static_cast<long long>(s) * nh * kHD,
                                    static_cast<long long>(nh) * kHD, kHD};
  const int rc = operand_map(&maps[3], out, b, s, nh, out_strides, 64);
  if (rc) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      attention_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  const int items = b * nh * ((s + kBQ - 1) / kBQ);
  const int sms = sm90::sm_count();
  attention_tma_kernel<<<items < sms ? items : sms, kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias), b,
      s, nh, scale);
  return static_cast<int>(cudaGetLastError());
}
