// Encoder attention on Hopper's TMA and wgmma (sm_90a), bf16, hd 64: the
// padded kernel (entry point lwc_attention_tma) and its segment-masked
// twin for the packed layout (lwc_attention_seg_tma), one template.
//
// Replaces: llm_weighted_consensus_tpu/ops/attention.py::fused_attention_tiled
// (the Pallas kernel _attn_kernel_tiled): softmax(Q K^T * scale + bias) V
// with an additive f32 key bias [b, s] (0 for real tokens, -1e9 for
// padding), f32 logits and softmax, probabilities rounded to bf16 (v's
// dtype) before P V, f32 accumulation, bf16 output.  And, as SEG,
// ::fused_attention_tiled_seg (_attn_kernel_tiled_seg): int32 segment_ids
// [b, s] (0 = pad slot) in place of the bias; query i sees key j iff
// seg[i] == seg[j] && seg[j] > 0, and a masked logit is REPLACED by -1e9
// (a select, not an add), so a pad query row is the uniform mean of V.
// Both take every encoder call of bge-base and bge-large on the card:
// q/k/v are the [b, s, nh, hd] views of the dense outputs (16-byte
// aligned, strides multiples of 16 bytes, in any order), any s.
// attention.cu keeps hd 16/24/32, f32 and unaligned views.
//
// What bounds it on the H100: bytes.  At the main path's [b, s] = [512,
// 128] (nh 16) one call reads q, k, v and writes out, 537 MB (0.160 ms at
// 3.35 TB/s), and does 4 b nh s^2 hd = 34 GFLOP (0.035 ms at 989 TFLOP/s
// bf16): 64 FLOP per byte, below the card's bf16 ridge of about 295.  At
// the packed bucket [8, 512] q/k/v/out are 33.6 MB (0.0100 ms) against
// at most 8.6 GFLOP, of which the same-segment blocks need a seventh.
// So the design reads each operand once, keeps the copies in flight and,
// for SEG, computes only the tiles the segments need:
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
//    memory, K-major.  The key bias (or the key ids) is read while it runs.
//  * Online softmax in f32 as attention.cu's, in base 2 (log2(e) folded
//    into the scale and the bias, ex2.approx in place of exp): scale, + bias
//    (a masked key carries -1e9, never -inf, so an all-pad row softmaxes
//    to the uniform mean of V), keys past s get -inf (probability 0).
//  * O += P V: P is rounded to bf16 in registers and repacked from the S
//    accumulator layout into wgmma's A-fragment layout (the same
//    per-warp layout); V stays in shared memory as an MN-major B operand
//    (hd contiguous: the descriptor's transpose bit).
//  * Output: O / l in bf16 through a swizzled staging tile and a TMA store.
//  * setmaxnreg: 40 registers for the producer (56 for SEG), 232 for the
//    consumers (224 for SEG).
//
// SEG, the tile schedule (ops/attention.py::segment_tile_schedule is its
// plain twin).  The producer reads each item's 128 query ids (publishing
// them to the consumers with the Q tile, under its barrier) and, per
// consumer's 64 rows, the range [min, max] of their positive ids and
// whether a pad row is among them; then per key tile the range of its
// positive ids.  Per consumer a tile is
//  * full where the ranges overlap: Q K^T, the select, P V;
//  * masked where they do not and the consumer holds a pad row: every
//    logit of its rows is -1e9 (or -inf past s), so Q K^T and the
//    exponents per key are skipped and P V runs on one probability per
//    row (a pad row needs the mean of every key);
//  * skipped otherwise.
// A tile skipped or masked for a row with a segment holds no key of that
// segment, so each of its probabilities would be exp(-1e9 - m) with m
// the row's final max, one of its real logits: exactly 0 in f32.  The
// producer copies a tile if either consumer needs it (K only where one
// computes Q K^T) and tells both what to do in a word per stage, with a
// flag on the item's last tile, so producer and consumers walk one list.
// At the packed bucket the mixed traffic's layouts need about half of
// the dense tile work, against three quarters at 128-row blocks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
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
// one word per stage for the SEG schedule, padded to keep the barriers
// 8-byte aligned
constexpr int kMetaWords = 4;
static_assert(kStages <= kMetaWords, "one schedule word per stage");
// Q, K, V and the output staging tile; the key-bias (or key-id) tiles, the
// query-id tiles and the schedule words; barriers; room to align the base
// to 1024
constexpr int kSmem = (kQBufs + 2 * kStages + 1) * kTileBytes +
                      (kStages * kBK + kQBufs * kBQ + kMetaWords) * 4 +
                      2 * (kQBufs + kStages) * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;
// the reference's fill for a masked logit, in base 2
constexpr float kMasked2 = -1e9f * kLog2e;
// SEG: key tiles whose ids the producer loads at once (512 keys)
constexpr int kScanTiles = 4;

// what a consumer does with a K/V tile (SEG; the padded kernel computes
// every tile), two bits per consumer, and the item's last tile
constexpr int kSkip = 0, kMasked = 1, kFull = 2;
constexpr int kLast = 16;

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

template <bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
    attention_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap o_map,
                         const void* __restrict__ mask, int b, int s, int nh,
                         float scale, int* __restrict__ schedule) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* q_s = smem;                        // [kQBufs][kTileBytes]
  uint8_t* k_s = q_s + kQBufs * kTileBytes;   // [kStages][kTileBytes]
  uint8_t* v_s = k_s + kStages * kTileBytes;  // [kStages][kTileBytes]
  uint8_t* o_s = v_s + kStages * kTileBytes;  // [kTileBytes]: 2 x 64 rows
  // [kStages][kBK]: the key bias in base 2, or (SEG) the key ids, a
  // non-positive id as 0 (a pad key) and -1 past s
  float* b_s = reinterpret_cast<float*>(o_s + kTileBytes);
  int* kid_s = reinterpret_cast<int*>(b_s);
  int* qid_s = kid_s + kStages * kBK;     // [kQBufs][kBQ] (SEG)
  int* meta_s = qid_s + kQBufs * kBQ;     // [kStages] (SEG)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(meta_s + kMetaWords);
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* kv_full = q_empty + kQBufs;
  uint64_t* kv_empty = kv_full + kStages;

  const int q_blocks = (s + kBQ - 1) / kBQ;
  const int n_kt = (s + kBK - 1) / kBK;
  const int items = b * nh * q_blocks;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      // the TMA transaction's arrival, and for SEG one per producer lane
      // (query ids)
      sm90::mbar_init(&q_full[i], SEG ? 1 + 32 : 1);
      sm90::mbar_init(&q_empty[i], kThreads - 128);
    }
    for (int i = 0; i < kStages; ++i) {
      // the TMA transaction's arrival and one per producer lane (bias or
      // key ids)
      sm90::mbar_init(&kv_full[i], 1 + 32);
      sm90::mbar_init(&kv_empty[i], kThreads - 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: warp 0 (lane 0 issues the TMA copies, every lane copies
    // its share of the key bias or ids; for SEG the lanes also build the
    // schedule) -------------------------------------------------------------
    sm90::setmaxnreg_dec<SEG ? 56 : 40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int qbuf = 0, st = 0;
      uint32_t qphase = 0, ph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item / q_blocks;
        const int qb = item - bh * q_blocks;
        const int bb = bh / nh;
        const int h = bh - bb * nh;
        const float* brow = static_cast<const float*>(mask) +
                            static_cast<size_t>(bb) * s;
        const int* srow = static_cast<const int*>(mask) +
                          static_cast<size_t>(bb) * s;
        // SEG: lane's ids of the item's rows 4 lane .. 4 lane + 3 and of
        // its keys 4 lane .. 4 lane + 3 in the first kScanTiles key
        // tiles, all loads in flight at once.  A non-positive id is read
        // as 0, a pad slot (the reference masks every key of it and every
        // key for it), and a position past s as -1
        int qid[4], kid[kScanTiles][4];
        if constexpr (SEG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = qb * kBQ + 4 * lane + r;
            qid[r] = row < s ? max(srow[row], 0) : -1;
          }
#pragma unroll
          for (int g = 0; g < kScanTiles; ++g)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int key = g * kBK + 4 * lane + r;
              kid[g][r] = key < s ? max(srow[key], 0) : -1;
            }
        }
        if (SEG || lane == 0) sm90::mbar_wait(&q_empty[qbuf], qphase ^ 1);
        if (lane == 0) {
          sm90::mbar_expect_tx(&q_full[qbuf], kTileBytes);
          sm90::tma_load_4d(q_s + qbuf * kTileBytes, &q_map, &q_full[qbuf], 0,
                            h, qb * kBQ, bb);
        }
        // SEG: the query ids to the consumers, and per consumer (lanes
        // 0-15 hold rows 0-63, lanes 16-31 rows 64-127) the range of its
        // positive ids and whether it holds a pad row
        int lo0 = INT_MAX, hi0 = 0, pad0 = 0, lo1 = INT_MAX, hi1 = 0, pad1 = 0;
        if constexpr (SEG) {
          *reinterpret_cast<int4*>(&qid_s[qbuf * kBQ + 4 * lane]) =
              make_int4(qid[0], qid[1], qid[2], qid[3]);
          int lo = INT_MAX, hi = 0;
          unsigned pad = 0;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (qid[r] > 0) {
              lo = min(lo, qid[r]);
              hi = max(hi, qid[r]);
            }
            pad |= qid[r] == 0;
          }
          const bool c0 = lane < 16;
          lo0 = __reduce_min_sync(0xffffffffu, c0 ? lo : INT_MAX);
          hi0 = __reduce_max_sync(0xffffffffu, c0 ? hi : 0);
          pad0 = __reduce_or_sync(0xffffffffu, c0 ? pad : 0u);
          lo1 = __reduce_min_sync(0xffffffffu, c0 ? INT_MAX : lo);
          hi1 = __reduce_max_sync(0xffffffffu, c0 ? 0 : hi);
          pad1 = __reduce_or_sync(0xffffffffu, c0 ? 0u : pad);
          sm90::mbar_arrive(&q_full[qbuf]);
        }

        // one K/V stage: tile kt with what each consumer does with it
        auto publish = [&](int kt, int kinds, const int (&ids)[4],
                           bool last) {
          sm90::mbar_wait(&kv_empty[st], ph ^ 1);
          if (lane == 0) {
            const bool qk = (kinds & 3) == kFull || (kinds >> 2) == kFull;
            sm90::mbar_expect_tx(&kv_full[st], (qk ? 2 : 1) * kTileBytes);
            if (qk)
              sm90::tma_load_4d(k_s + st * kTileBytes, &k_map, &kv_full[st],
                                0, h, kt * kBK, bb);
            sm90::tma_load_4d(v_s + st * kTileBytes, &v_map, &kv_full[st], 0,
                              h, kt * kBK, bb);
            if (SEG) meta_s[st] = kinds | (last ? kLast : 0);
            // the check entry's copy of the schedule (head 0's; every
            // head runs the same): [b][2 q_blocks][n_kt], one int per
            // consumer's 64 rows and key tile, 0 = skipped
            if (SEG && schedule != nullptr && h == 0) {
              int* at = schedule +
                        (static_cast<size_t>(bb) * 2 * q_blocks + 2 * qb) *
                            n_kt + kt;
              at[0] = kinds & 3;
              at[n_kt] = kinds >> 2;
            }
          }
          if constexpr (SEG) {
            *reinterpret_cast<int4*>(&kid_s[st * kBK + 4 * lane]) =
                make_int4(ids[0], ids[1], ids[2], ids[3]);
          } else {
            // the tile's key bias in base 2; keys past s get -inf
#pragma unroll
            for (int j = lane; j < kBK; j += 32) {
              const int key = kt * kBK + j;
              b_s[st * kBK + j] =
                  key < s ? brow[key] * kLog2e : -CUDART_INF_F;
            }
          }
          sm90::mbar_arrive(&kv_full[st]);
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
        };

        if constexpr (SEG) {
          // the item's tiles in order; a tile is published once the next
          // one to visit is known, so the last carries its flag
          int pend = -1, pend_kinds = 0, pend_ids[4] = {0, 0, 0, 0};
          for (int kt0 = 0; kt0 < n_kt; kt0 += kScanTiles) {
            if (kt0 > 0) {
#pragma unroll
              for (int g = 0; g < kScanTiles; ++g)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const int key = (kt0 + g) * kBK + 4 * lane + r;
                  kid[g][r] = key < s ? max(srow[key], 0) : -1;
                }
            }
#pragma unroll
            for (int g = 0; g < kScanTiles; ++g) {
              if (kt0 + g >= n_kt) break;
              int k_lo = INT_MAX, k_hi = 0;
#pragma unroll
              for (int r = 0; r < 4; ++r)
                if (kid[g][r] > 0) {
                  k_lo = min(k_lo, kid[g][r]);
                  k_hi = max(k_hi, kid[g][r]);
                }
              k_lo = __reduce_min_sync(0xffffffffu, k_lo);
              k_hi = __reduce_max_sync(0xffffffffu, k_hi);
              const int kind0 = lo0 <= k_hi && k_lo <= hi0 ? kFull
                                : pad0                    ? kMasked
                                                          : kSkip;
              const int kind1 = lo1 <= k_hi && k_lo <= hi1 ? kFull
                                : pad1                    ? kMasked
                                                          : kSkip;
              const int kinds = kind0 | (kind1 << 2);
              if (kinds == 0) continue;
              if (pend >= 0) publish(pend, pend_kinds, pend_ids, false);
              pend = kt0 + g;
              pend_kinds = kinds;
#pragma unroll
              for (int r = 0; r < 4; ++r) pend_ids[r] = kid[g][r];
            }
          }
          // every item has a tile: a consumer's row with a segment
          // overlaps its own key's tile, a pad row makes every tile masked
          publish(pend, pend_kinds, pend_ids, true);
        } else {
          const int none[4] = {0, 0, 0, 0};
          for (int kt = 0; kt < n_kt; ++kt)
            publish(kt, kFull | (kFull << 2), none, kt == n_kt - 1);
        }
        if (++qbuf == kQBufs) {
          qbuf = 0;
          qphase ^= 1;
        }
      }
    }
  } else {
    // -- consumers ----------------------------------------------------------
    sm90::setmaxnreg_inc<SEG ? 224 : 232>();
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
      // SEG: the ids of this thread's two query rows; a pad row and a row
      // past s take INT_MIN, which no key id (-1 past s) equals
      int sq[2] = {0, 0};
      if constexpr (SEG) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int id = qid_s[qbuf * kBQ + cw * 64 + warp * 16 + g + 8 * i];
          sq[i] = id > 0 ? id : INT_MIN;
        }
      }

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.0f;
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

      for (int kt = 0;; ++kt) {
        sm90::mbar_wait(&kv_full[st], ph);
        int kind = kFull;
        bool last = kt == n_kt - 1;
        if constexpr (SEG) {
          const int meta = meta_s[st];
          kind = (meta >> (2 * cw)) & 3;
          last = (meta & kLast) != 0;
        }
        const uint8_t* k_tile = k_s + st * kTileBytes;
        const uint8_t* v_tile = v_s + st * kTileBytes;

        if (kind != kSkip) {
          // P in bf16 as wgmma A fragments: keys 16kk .. 16kk + 15 are the
          // accumulator's column groups 2kk and 2kk + 1
          uint32_t pa[8][4];
          if (SEG && kind == kMasked) {
            // every logit of this consumer's rows is -1e9 in this tile
            // (-inf past s): no product, one exponent per row, and each
            // key's probability is the row's (0 past s), as the general
            // path below would compute them
            int2 sk[16];
#pragma unroll
            for (int j = 0; j < 16; ++j)
              sk[j] = *reinterpret_cast<const int2*>(
                  &kid_s[st * kBK + 8 * j + 2 * c]);
            if (last) sm90::mbar_arrive(&q_empty[qbuf]);
            float pr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float mx = fmaxf(m[i], kMasked2);  // key 0 is before s
              const float corr = ex2(m[i] - mx);
              m[i] = mx;
              l[i] *= corr;
              pr[i] = ex2(kMasked2 - mx);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                o[4 * j + 2 * i] *= corr;
                o[4 * j + 2 * i + 1] *= corr;
              }
            }
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              float p[4];
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                p[x] = ((x & 1) ? sk[j].y : sk[j].x) < 0 ? 0.0f : pr[x >> 1];
                l[x >> 1] += p[x];
              }
              pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
              pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
            }
          } else {
            // S = Q K^T, 64 rows x 128 keys, accumulator layout: sc[4j +
            // 2i + e] is row g + 8i of the warp's 16, key 8j + 2c + e
            float sc[64];
            sm90::fence_operands(sc);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kHD / 16; ++kk)
              sm90::wgmma_m64n128k16_bf16_ss(
                  sc, sm90::desc_kmajor(q_tile + kk * 32),
                  sm90::desc_kmajor(k_tile + kk * 32), kk > 0 ? 1 : 0);
            sm90::wgmma_commit();
            // the bias (or the ids) of this thread's 32 keys while the
            // product runs
            float2 bk[16];
            int2 sk[16];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              if constexpr (SEG)
                sk[j] = *reinterpret_cast<const int2*>(
                    &kid_s[st * kBK + 8 * j + 2 * c]);
              else
                bk[j] = *reinterpret_cast<const float2*>(
                    &b_s[st * kBK + 8 * j + 2 * c]);
            }
            sm90::wgmma_wait<0>();
            sm90::fence_operands(sc);
            if (last) sm90::mbar_arrive(&q_empty[qbuf]);

            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                float x0, x1;
                if constexpr (SEG) {
                  // the select: the logit where the key is in the row's
                  // segment, -1e9 where not (a pad key too), -inf past s
                  x0 = sk[j].x == sq[i]
                           ? sc[4 * j + 2 * i] * scale2
                           : (sk[j].x < 0 ? -CUDART_INF_F : kMasked2);
                  x1 = sk[j].y == sq[i]
                           ? sc[4 * j + 2 * i + 1] * scale2
                           : (sk[j].y < 0 ? -CUDART_INF_F : kMasked2);
                } else {
                  x0 = sc[4 * j + 2 * i] * scale2 + bk[j].x;
                  x1 = sc[4 * j + 2 * i + 1] * scale2 + bk[j].y;
                }
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
          // the A fragments stay live (in place) until the products read
          // them
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              asm volatile("" : "+r"(pa[kk][x])::"memory");
        } else if (last) {
          sm90::mbar_arrive(&q_empty[qbuf]);
        }
        sm90::mbar_arrive(&kv_empty[st]);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
        if (last) break;
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

template <bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int b, int s, int nh, int hd, const long long* strides,
           float scale, int dtype, cudaStream_t stream,
           int* schedule = nullptr) {
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
  const cudaError_t smem_set = sm90::once_per_device([] {
    return cudaFuncSetAttribute(attention_tma_kernel<SEG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  });
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  const int items = b * nh * ((s + kBQ - 1) / kBQ);
  const int sms = sm90::sm_count();
  attention_tma_kernel<SEG><<<items < sms ? items : sms, kThreads, kSmem,
                              stream>>>(maps[0], maps[1], maps[2], maps[3],
                                        mask, b, s, nh, scale, schedule);
  return static_cast<int>(cudaGetLastError());
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
  return launch<false>(q, k, v, bias, out, b, s, nh, hd, strides, scale,
                       dtype, static_cast<cudaStream_t>(stream));
}

// The packed twin: as lwc_attention_tma, with segment_ids [b, s] int32
// contiguous in place of the bias.  An id <= 0 is a pad slot: the
// reference masks every key for it and it for every query.
extern "C" int lwc_attention_seg_tma(const void* q, const void* k,
                                     const void* v, const void* segment_ids,
                                     void* out, int b, int s, int nh, int hd,
                                     const long long* strides, float scale,
                                     int dtype, void* stream) {
  return launch<true>(q, k, v, segment_ids, out, b, s, nh, hd, strides,
                      scale, dtype, static_cast<cudaStream_t>(stream));
}

// For checking the schedule: the layout of what
// lwc_attention_seg_tma_schedule writes at this s, dims = {query blocks,
// key tiles, rows per query block, keys per tile}.
extern "C" void lwc_attention_seg_tma_tiles(int s, int* dims) {
  dims[0] = 2 * ((s + kBQ - 1) / kBQ);
  dims[1] = (s + kBK - 1) / kBK;
  dims[2] = kBQ / 2;
  dims[3] = kBK;
}

// As lwc_attention_seg_tma, and the kernel's producer also writes what
// each consumer did with each key tile into schedule, int32 [b][dims[0]]
// [dims[1]] zero-filled by the caller (lwc_attention_seg_tma_tiles):
// 0 skipped, 1 masked, 2 full.
extern "C" int lwc_attention_seg_tma_schedule(
    const void* q, const void* k, const void* v, const void* segment_ids,
    void* out, int b, int s, int nh, int hd, const long long* strides,
    float scale, int dtype, void* stream, int* schedule) {
  return launch<true>(q, k, v, segment_ids, out, b, s, nh, hd, strides,
                      scale, dtype, static_cast<cudaStream_t>(stream),
                      schedule);
}
