// W8A8 and W4A8 quantized dense layers, the int8 GEMM on Hopper's TMA and
// wgmma (sm_90a).  Entry point lwc_quant_matmul_tma.
//
// Replaces: llm_weighted_consensus_tpu/ops/kernels.py::w8a8_matmul (the
// Pallas kernel _w8a8_kernel) and ::w4a8_matmul (_w4a8_kernel), the
// product and its epilogue:
//   out = act(float(xq @ W^T) * sx[row] * sw[col] + bias[col])
// on the int8 rows xq[M, Kp] and scales sx[M] that lwc_quantize_rows
// (quant_matmul.cu) writes, W[N, K] int8 (W4: [N, Kp/2] packed biased
// nibbles, see below), int32 accumulation, the GELU (erf for f32, A&S
// 7.1.26 for bf16) and one rounding to the output dtype.  The epilogue is
// quant_epilogue.cuh's, shared with the mma.sync route, and int32 sums are
// exact in any order, so both routes give the same bits.  That route
// (quant_matmul.cu) keeps W8A8 with K % 16 != 0 and unaligned operands.
//
// What bounds it on the H100: operations at bge-large's wide layers
// (M = 65536, (K, N) = (1024, 4096) and (4096, 1024): 550 G int8 ops,
// 0.278 ms at 1,979 TOP/s against 0.23 ms of traffic), bytes at the
// square one ((1024, 1024): 0.080 ms of traffic, 0.069 ms of operations).
// The mma.sync route reached 15% of the int8 peak: its warps both load
// (global -> registers -> shared, two stages) and multiply.
//
// Design:
//  * Output tiles of 128 x 128; one persistent block per SM walks them,
//    M-panel-major, so the blocks in flight share a few 128-row panels of
//    xq and all of W stays in the 50 MB L2.
//  * Warp specialisation: warpgroup 0 is the producer (one thread issues
//    the TMA copies, cp.async.bulk.tensor; the warpgroup keeps 40
//    registers), warpgroups 1 and 2 are consumers (232 registers each).
//  * A 4-stage ring in shared memory: per stage a 128 x 128-byte tile of
//    xq and of W, both K-major with 128-byte swizzle, guarded by a full
//    and an empty mbarrier.  TMA fills zeros past M, N and K, so ragged
//    edges need no masking in the main loop.
//  * Ping-pong consumers: each warpgroup owns a whole tile (the block's
//    even or odd tiles), two wgmma.mma_async m64n128k32 s8 x s8 -> s32
//    per 32 bytes of K, one stage's group kept in flight.  Their main
//    loops take turns (a pair of mbarriers), so one warpgroup's epilogue
//    (dequantise, GELU, stores) runs while the other keeps the tensor
//    cores busy: with both in one tile, the tensor cores idled through
//    every epilogue.
//  * Epilogue from the accumulators' registers: dequantise, bias, GELU,
//    one rounding; f32 outputs (and bf16 ones whose rows are not 16-byte
//    aligned) are stored in column pairs, rows past M and columns past N
//    masked.  Its row scales and column scales and biases are loaded
//    before the main loop (the columns staged in shared memory), so no
//    global load latency sits in it.  A bf16 tile is written to shared
//    memory (128-byte swizzled, free of bank conflicts) and leaves by two
//    TMA stores, which clip the ragged edges; storing column pairs from
//    registers (16 bytes per row per quad, eight rows per warp store)
//    made the epilogue outlast the other consumer's main loop.
//
// W4 (W4A8): the weight stays packed in device memory, [N, Kp/2] uint8,
// byte j of a row holding K index j in its low nibble and Kp/2 + j in its
// high nibble (pack_int4_weights; Kp a multiple of 256).  So one TMA box
// of 128 rows x 128 packed bytes at byte 128p holds the int8 W tiles of K
// tiles p (low nibbles) and p + Kp/256 (high).  They take two consecutive
// ring stages, with the xq tiles at K = 128p and Kp/2 + 128p; the
// producer thread copies the packed box into the first stage's own W slot
// (its barrier: a third per stage), as soon as that stage is free.  The
// producer warpgroup's other three warps (idle in W8A8) wait for the box
// and for the second stage to be free, and unpack in place: byte j of
// each packed row becomes byte j of the two int8 rows (low, high nibble,
// unbiased by quant_epilogue.cuh's unbias_nibbles, the mma.sync route's
// code), so the box's 128-byte swizzle is already the swizzle of both
// tiles; each thread reads its own 16-byte chunks before writing them.
// They fence the writes for the async proxy and arrive on both stages'
// full barriers, which count their arrivals beside the TMA's.  The
// consumers and the epilogue are W8A8's, and so is the shared memory: no
// buffer beside the ring, whose copies would have to wait for the last box
// to be unpacked.  W4A8 moves half of W8A8's weight bytes but adds a
// shared-memory read and two writes of each packed byte per output tile,
// which with the unbias is what the GEMM pays over W8A8's (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "quant_epilogue.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBM = 128;       // output rows per tile
constexpr int kBN = 128;       // output columns per tile
constexpr int kBK = 128;       // K bytes per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kABytes = kBM * kBK;
constexpr int kWBytes = kBN * kBK;
constexpr int kStageBytes = kABytes + kWBytes;
// a bf16 output tile staged for its TMA store: two 64-column halves of
// 128 rows x 128 bytes, 128-byte swizzled
constexpr int kOutBytes = kBM * kBN * 2;
// unpack threads of W4: the producer warpgroup's warps 1-3
constexpr int kUnpackThreads = 96;
static_assert(kStages % 2 == 0, "W4's stage pairs stay aligned in the ring");
// tiles, each consumer's output tile (bf16 only), its column scales and
// biases, the ring's 3 x kStages barriers (full, empty, and W4's packed
// box landed) and the 2 turn barriers, and room to align the base to 1024
template <typename T>
constexpr int smem_bytes() {
  return kStages * kStageBytes + (sizeof(T) == 2 ? 2 * kOutBytes : 0) +
         2 * 2 * kBN * 4 + (3 * kStages + 2) * 8 + 1024;
}

// One consumer's 128 x kBN tile from its accumulators: ((acc * sx) * sw)
// + bias, the GELU if GELU, one rounding to T.  TMA: into the swizzled
// staging tile (the 16-byte chunk j % 8 of a row in half j / 8 sits at
// chunk (j % 8) ^ (row % 8), and row % 8 == g), no masking (the TMA store
// clips); else column pairs straight to `out`, masked at the edges.
template <typename T, bool GELU, bool TMA>
__device__ __forceinline__ void epilogue(
    const int (&acc)[2][kBN / 2], const float (&s_row)[2][2],
    const float* col_sw, const float* col_bias, uint8_t* o_tile, T* out,
    int m0, int n0, int m, int n, int row_base, int g, int c) {
  constexpr bool approx = sizeof(T) == 2;
  const bool pair_ok = (n % 2) == 0;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * c;
    if (!TMA && col >= n) continue;
    const float2 sw01 = *reinterpret_cast<const float2*>(&col_sw[8 * j + 2 * c]);
    const float2 b01 = *reinterpret_cast<const float2*>(&col_bias[8 * j + 2 * c]);
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mh * 64 + row_base + 8 * r;  // in the tile
        const float v0 = quant_epilogue::dequant(
            acc[mh][4 * j + 2 * r], s_row[mh][r], sw01.x, b01.x, GELU, approx);
        const float v1 = quant_epilogue::dequant(
            acc[mh][4 * j + 2 * r + 1], s_row[mh][r], sw01.y, b01.y, GELU,
            approx);
        if constexpr (TMA) {
          *reinterpret_cast<__nv_bfloat162*>(
              o_tile + (j >> 3) * (kOutBytes / 2) + row * 128 +
              (((j & 7) ^ g) << 4) + 4 * c) = __floats2bfloat162_rn(v0, v1);
        } else if (m0 + row < m) {
          const bool both = col + 1 < n;
          quant_epilogue::store2(out + static_cast<size_t>(m0 + row) * n + col,
                                 v0, v1, both, both && pair_ok);
        }
      }
  }
}

template <typename T, bool W4>
__global__ void __launch_bounds__(kThreads, 1)
    quant_gemm_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap o_map,
                          const float* __restrict__ sx,
                          const float* __restrict__ sw,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int m, int n, int k_tiles, int half_k, int gelu_on,
                          int tma_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* a_s = smem;
  uint8_t* w_s = smem + kStages * kABytes;
  uint8_t* o_s = smem + kStages * kStageBytes;  // [consumer][kOutBytes]
  // [consumer][sw, bias][kBN]: the epilogue's column parameters
  float* cols = reinterpret_cast<float*>(
      o_s + (sizeof(T) == 2 ? 2 * kOutBytes : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(cols + 2 * 2 * kBN);
  uint64_t* empty = full + kStages;
  uint64_t* packed = empty + kStages;  // W4: a stage's packed box landed
  uint64_t* turn = packed + kStages;   // whose main loop runs next

  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles = ((m + kBM - 1) / kBM) * n_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA transaction's arrival, and under W4 one per unpack thread
      sm90::mbar_init(&full[s], W4 ? 1 + kUnpackThreads : 1);
      sm90::mbar_init(&empty[s], 128);
    }
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&packed[s], 1);
    sm90::mbar_init(&turn[0], 128);
    sm90::mbar_init(&turn[1], 128);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: the block's tiles in order, k_tiles stages each --------
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * kBN;
        if constexpr (W4) {
          // per packed box p two stages (k_tiles is even and so is
          // kStages, so the pairs stay aligned): the box into the first
          // stage's W slot, the xq tiles of its low and high nibbles
          for (int p = 0; p < k_tiles / 2; ++p) {
            for (int hi = 0; hi < 2; ++hi) {
              sm90::mbar_wait(&empty[stage], phase ^ 1);
              if (hi == 0) {
                sm90::mbar_expect_tx(&packed[stage], kWBytes);
                sm90::tma_load_2d(w_s + stage * kWBytes, &w_map,
                                  &packed[stage], p * kBK, n0);
              }
              sm90::mbar_expect_tx(&full[stage], kABytes);
              sm90::tma_load_2d(a_s + stage * kABytes, &a_map, &full[stage],
                                hi * half_k + p * kBK, m0);
              if (++stage == kStages) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        } else {
          for (int kt = 0; kt < k_tiles; ++kt) {
            sm90::mbar_wait(&empty[stage], phase ^ 1);
            sm90::mbar_expect_tx(&full[stage], kStageBytes);
            sm90::tma_load_2d(a_s + stage * kABytes, &a_map, &full[stage],
                              kt * kBK, m0);
            sm90::tma_load_2d(w_s + stage * kWBytes, &w_map, &full[stage],
                              kt * kBK, n0);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (W4 && threadIdx.x >= 32) {
      // W4's unpack warps: each packed box into the W tiles of its two
      // stages, in place, byte positions kept (the swizzle carries over)
      const int ut = threadIdx.x - 32;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int p = 0; p < k_tiles / 2; ++p, stage += 2) {
          if (stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
          // the box has landed in the first stage (whose TMA thread
          // waited for it to be free), and the second stage is free
          sm90::mbar_wait(&packed[stage], phase);
          sm90::mbar_wait(&empty[stage + 1], phase ^ 1);
          uint4* lo = reinterpret_cast<uint4*>(w_s + stage * kWBytes);
          uint4* hi = reinterpret_cast<uint4*>(w_s + (stage + 1) * kWBytes);
          // two chunks per thread and round, both read before any write
          for (int i = ut; i < kWBytes / 16; i += 2 * kUnpackThreads) {
            const int i2 = i + kUnpackThreads;
            const bool two = i2 < kWBytes / 16;
            const uint4 b = lo[i];
            const uint4 b2 = two ? lo[i2] : b;
            lo[i] = make_uint4(quant_epilogue::unbias_nibbles(b.x),
                               quant_epilogue::unbias_nibbles(b.y),
                               quant_epilogue::unbias_nibbles(b.z),
                               quant_epilogue::unbias_nibbles(b.w));
            hi[i] = make_uint4(quant_epilogue::unbias_nibbles(b.x >> 4),
                               quant_epilogue::unbias_nibbles(b.y >> 4),
                               quant_epilogue::unbias_nibbles(b.z >> 4),
                               quant_epilogue::unbias_nibbles(b.w >> 4));
            if (two) {
              lo[i2] = make_uint4(quant_epilogue::unbias_nibbles(b2.x),
                                  quant_epilogue::unbias_nibbles(b2.y),
                                  quant_epilogue::unbias_nibbles(b2.z),
                                  quant_epilogue::unbias_nibbles(b2.w));
              hi[i2] = make_uint4(quant_epilogue::unbias_nibbles(b2.x >> 4),
                                  quant_epilogue::unbias_nibbles(b2.y >> 4),
                                  quant_epilogue::unbias_nibbles(b2.z >> 4),
                                  quant_epilogue::unbias_nibbles(b2.w >> 4));
            }
          }
          // the tiles are read by wgmma (the async proxy)
          sm90::fence_async_shared();
          sm90::mbar_arrive(&full[stage]);
          sm90::mbar_arrive(&full[stage + 1]);
        }
      }
    }
  } else {
    // -- consumers: warpgroup cw takes the block's tiles cw, cw + 2, ... --
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int g = (t % 32) >> 2;  // accumulator row (and + 8)
    const int c = t & 3;          // accumulator column pair
    const int row_base = (t / 32) * 16 + g;
    int acc[2][kBN / 2] = {};  // each tile's first wgmma overwrites
    float* col_sw = cols + cw * 2 * kBN;
    float* col_bias = col_sw + kBN;
    int i = 0;                 // this warpgroup's tile count
    for (int tile = blockIdx.x + cw * gridDim.x; tile < tiles;
         tile += 2 * gridDim.x, ++i) {
      const int m0 = (tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * kBN;
      // the ring position of this tile: the block's local tile index
      // times k_tiles
      int seq = (2 * i + cw) * k_tiles;
      // the epilogue's scales and biases, loaded under the main loop: one
      // column per thread, and this thread's four row scales
      const int my_col = n0 + t;
      const float my_sw = my_col < n ? sw[my_col] : 0.0f;
      const float my_bias = my_col < n ? bias[my_col] : 0.0f;
      float s_row[2][2];
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + mh * 64 + row_base + 8 * r;
          s_row[mh][r] = row < m ? sx[row] : 0.0f;
        }
      // main loops alternate between the warpgroups, so one's epilogue
      // runs under the other's main loop
      sm90::mbar_wait(&turn[cw], (i & 1) ^ (cw == 0 ? 1 : 0));
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt, ++seq) {
        const int stage = seq % kStages;
        sm90::mbar_wait(&full[stage], (seq / kStages) & 1);
        const uint8_t* a_tile = a_s + stage * kABytes;
        const uint8_t* w_tile = w_s + stage * kWBytes;
        sm90::fence_operands(acc[0]);
        sm90::fence_operands(acc[1]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          const uint64_t wd = sm90::desc_kmajor(w_tile + kk * 32);
          const int scale_d = (kt > 0 || kk > 0) ? 1 : 0;
#pragma unroll
          for (int mh = 0; mh < 2; ++mh)
            sm90::wgmma_m64n128k32_s8_ss(
                acc[mh], sm90::desc_kmajor(a_tile + mh * 64 * kBK + kk * 32),
                wd, scale_d);
        }
        sm90::wgmma_commit();
        // the group before this one is done: its stage can be refilled
        sm90::wgmma_wait<1>();
        sm90::fence_operands(acc[0]);
        sm90::fence_operands(acc[1]);
        if (prev >= 0) sm90::mbar_arrive(&empty[prev]);
        prev = stage;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc[0]);
      sm90::fence_operands(acc[1]);
      if (prev >= 0) sm90::mbar_arrive(&empty[prev]);
      sm90::mbar_arrive(&turn[cw ^ 1]);

      // epilogue: ((acc * sx) * sw) + bias, GELU, one rounding to T; bf16
      // tiles go through shared memory and one TMA store per 64 columns
      // (rows and columns past the edges are clipped), other outputs are
      // stored from registers
      uint8_t* o_tile = o_s + cw * kOutBytes;
      if (t == 0) sm90::bulk_wait_read();  // the last tile's store has read
      sm90::named_barrier(1 + cw, 128);  // and so have the last epilogue's
      col_sw[t] = my_sw;
      col_bias[t] = my_bias;
      sm90::named_barrier(1 + cw, 128);
      // one uniform branch per tile picks a straight-line epilogue
      if (gelu_on) {
        if (sizeof(T) == 2 && tma_out)
          epilogue<T, true, true>(acc, s_row, col_sw, col_bias, o_tile, out,
                                  m0, n0, m, n, row_base, g, c);
        else
          epilogue<T, true, false>(acc, s_row, col_sw, col_bias, o_tile, out,
                                   m0, n0, m, n, row_base, g, c);
      } else {
        if (sizeof(T) == 2 && tma_out)
          epilogue<T, false, true>(acc, s_row, col_sw, col_bias, o_tile, out,
                                   m0, n0, m, n, row_base, g, c);
        else
          epilogue<T, false, false>(acc, s_row, col_sw, col_bias, o_tile,
                                    out, m0, n0, m, n, row_base, g, c);
      }
      if (sizeof(T) == 2 && tma_out) {
        sm90::fence_async_shared();
        sm90::named_barrier(1 + cw, 128);
        if (t == 0) {
          sm90::tma_store_2d(&o_map, o_tile, n0, m0);
          if (n0 + kBN / 2 < n)
            sm90::tma_store_2d(&o_map, o_tile + kOutBytes / 2, n0 + kBN / 2,
                               m0);
          sm90::bulk_commit();
        }
      }
    }
    if (t == 0) sm90::bulk_wait_read();  // before the block's memory goes
  }
}

template <typename T, bool W4>
int launch(const void* xq, const void* w, const void* sx, const void* sw,
           const void* bias, void* out, int m, int n, int k, int kp,
           int gelu_on, cudaStream_t stream) {
  // xq [m, kp] and W [n, k] (W4: [n, kp / 2] packed), K innermost; boxes
  // of 128 K bytes by 128 rows, zero filled past the edges
  CUtensorMap a_map, w_map;
  const int w_cols = W4 ? kp / 2 : k;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(kp), static_cast<uint64_t>(m)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(kp)};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(w_cols), static_cast<uint64_t>(n)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(w_cols)};
  const uint32_t box[2] = {kBK, kBM};
  int rc = sm90::encode_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq,
                            a_dims, a_strides, box);
  if (rc) return rc;
  rc = sm90::encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, w_dims,
                        w_strides, box);
  if (rc) return rc;
  // bf16 out [m, n] in boxes of 64 columns by 128 rows, where its rows
  // are 16-byte aligned; else the kernel stores from registers
  CUtensorMap o_map = a_map;
  const int tma_out = sizeof(T) == 2 && n % 8 == 0;
  if (tma_out) {
    const uint64_t o_dims[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(m)};
    const uint64_t o_strides[1] = {static_cast<uint64_t>(n) * 2};
    const uint32_t o_box[2] = {kBN / 2, kBM};
    rc = sm90::encode_map(&o_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out,
                          o_dims, o_strides, o_box);
    if (rc) return rc;
  }
  constexpr int kSmem = smem_bytes<T>();
  const cudaError_t smem_set = sm90::once_per_device([] {
    return cudaFuncSetAttribute(quant_gemm_tma_kernel<T, W4>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  });
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  const int tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int sms = sm90::sm_count();
  // two tiles per block at a time, one per consumer warpgroup
  const int grid = (tiles + 1) / 2 < sms ? (tiles + 1) / 2 : sms;
  // W4 walks Kp (xq is zero past K, the pad nibbles unbias to 0)
  const int k_tiles = W4 ? kp / kBK : (k + kBK - 1) / kBK;
  quant_gemm_tma_kernel<T, W4><<<grid, kThreads, kSmem, stream>>>(
      a_map, w_map, o_map, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<T*>(out), m, n, k_tiles, kp / 2, gelu_on, tma_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The W8A8 / W4A8 GEMM on TMA + wgmma.  Arguments as lwc_quant_matmul's:
// xq [m, kp] int8 from lwc_quantize_rows, sx [m] f32, w [n, k] int8
// contiguous (int4 = 1: [n, kp / 2] uint8 biased nibbles, kp a multiple
// of 256), sw and bias [n] f32, out [m, n] contiguous in dtype (0 = f32,
// 1 = bf16), gelu 1 applies the GELU.  Takes xq, w, out 16-byte aligned
// and, for int4 = 0, k % 16 == 0; anything else returns
// cudaErrorInvalidValue without a launch.  Returns cudaGetLastError()
// after the launch.
extern "C" int lwc_quant_matmul_tma(const void* xq, const void* w,
                                    const void* sx, const void* sw,
                                    const void* bias, void* out, int m, int n,
                                    int k, int kp, int int4, int gelu,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (kp % 64 || kp < k || !aligned || (int4 ? kp % 256 != 0 : k % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
#define LWC_QMM_TMA_CASE(DT, T, W4)                                          \
  if (dtype == DT && (int4 != 0) == W4)                                      \
    return launch<T, W4>(xq, w, sx, sw, bias, out, m, n, k, kp, gelu, st);
  LWC_QMM_TMA_CASE(0, float, false)
  LWC_QMM_TMA_CASE(0, float, true)
  LWC_QMM_TMA_CASE(1, __nv_bfloat16, false)
  LWC_QMM_TMA_CASE(1, __nv_bfloat16, true)
#undef LWC_QMM_TMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
