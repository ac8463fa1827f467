// The attention weights of the bf16 kernels, shared by attention_fwd_bf16.cu
// and attention_bwd_bf16.cu so that the backward recomputes the forward's
// bits, and the product loop both run after the weights.
//
// Two warps per 16 query rows (a group): part 0 takes keys 0 .. 63, part 1
// keys 64 .. 127.  Each warp computes S = Q K^T for its rows and keys (bf16
// mma.sync, the k steps added exactly as mma_bf16.cuh's Acc and rounded to
// f32 once) * scale, masks keys at positions >= valid_len, and draws the
// dropout keep bits of those positions (philox.cuh's stream kAttention at
// flat index ((b * H + h) * L + i) * L + j).  The two warps then combine
// through shared memory, in a fixed order: the row max (order-free), and the
// row sum of exp(S - max), each warp's half summed in f64 (exact: the same
// f32 whatever the order), part 0's half first, rounded to f32 once.  P is
// one correctly rounded division (div_rn), normalised before anything
// rounds it to bf16 (as the JAX kernel rounds the softmax's output).  The
// forward kernel's notes say why each sum is exact.
//
// Layout: Q and K staged in shared memory as [row][Dp + 8] bf16 (Dh
// zero-padded to Dp), Lp = L rounded up to 16 rows.  A warp's S is kTiles
// accumulator tiles of 16 x 8 (mma_bf16.cuh's C layout: element e of tile n
// is row r0 + g + 8 (e >> 1), key 64 part + 8n + 2t + (e & 1)).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"

namespace attn_bf16 {

using bf16::bf16_t;

constexpr int kMaxLen = 128;                 // keys (and query rows) per block
constexpr int kParts = 2;                    // warps per 16-row group
constexpr int kMaxGroups = kMaxLen / 16;     // 16-row groups per block
constexpr int kTiles = kMaxLen / 8 / kParts;  // key tiles of 8 of one warp (S accumulators)
constexpr int kKeySteps = kTiles / 2;        // its 16-key steps
constexpr int kWidths[3] = {16, 32, 64};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int width_index(int Dh) { return Dh <= 16 ? 0 : Dh <= 32 ? 1 : 2; }

// Threads of a block: two warps for each 16 rows.
__host__ __device__ constexpr int block_threads(int L) {
  return round_up(L, 16) / 16 * 32 * kParts;
}

// What the two warps of a group pass each other, per row of the group: the
// halves of the row max, of the row sum and (backward) of D.  Each slot is
// written once per launch, so one barrier before each read is enough.
struct PairScratch {
  float max[kParts][16];
  double sum[kParts][16];
  double d[kParts][16];
};
constexpr int kScratchBytes = kMaxGroups * (int)sizeof(PairScratch);  // a multiple of 16

// Waits for the other warp of group `group` (named barrier 1 + group).
__device__ __forceinline__ void pair_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "n"(32 * kParts) : "memory");
}

// Rows g and g + 8 of the group: this warp's halves v0, v1 (the same in the
// four lanes of a row) into the slot, then both halves added, part 0's first.
__device__ __forceinline__ void pair_sum(double (&slot)[kParts][16], int part, int group, int g,
                                         int t, double v0, double v1, double& s0, double& s1) {
  if (t == 0) {
    slot[part][g] = v0;
    slot[part][g + 8] = v1;
  }
  pair_sync(group);
  s0 = slot[0][g] + slot[1][g];
  s1 = slot[0][g + 8] + slot[1][g + 8];
}

// Sum over the four lanes that share a row.
__device__ __forceinline__ double quad_sum(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// x / d rounded to nearest, the bits of __fdiv_rn(x, d), for 2^-64 <= x <=
// 1 (or x = 0) and 1 <= d <= 128 (a softmax weight and its row sum), from y
// = 1 / d rounded to nearest, one reciprocal a row.  q0 = x y may be two
// ulps off; q1 = q0 + (x - q0 d) y is within one; then x - q1 d is exact
// (FMA), and q1 + (x - q1 d) y rounded once is the quotient rounded to
// nearest (Markstein's theorem), as nothing underflows.  Five FMA-pipe
// operations where __fdiv_rn spends a reciprocal and a range check per
// element on the special-function units and a branch around its slow path
// (tests/test_torch_attention_bf16_sums.py emulates it).
__device__ __forceinline__ float div_rn(float x, float d, float y) {
  float q = __fmul_rn(x, y);
  q = __fmaf_rn(__fmaf_rn(-q, d, x), y, q);
  return __fmaf_rn(__fmaf_rn(-q, d, x), y, q);
}

// The bits of x less one, as an unsigned: below kTinyBits exactly where 0 <
// x < 2^-64, the weights that div_rn does not take (a 0 wraps to the top).
__device__ __forceinline__ uint32_t tiny_key(float x) { return __float_as_uint(x) - 1u; }
constexpr uint32_t kTinyBits = 0x1f800000u - 1u;  // the bits of 2^-64, less one

// The 16 keys from key j0 (a multiple of 16); past the staged rows the last
// staged 16 instead, whose scores are then masked (weight 0): the tile
// loops carry no per-step branch.
__device__ __forceinline__ int key_row(int j0, int Lp) { return min(j0, Lp - 16); }

// What one warp knows of its (batch, head) and rows before the weights.
struct Rows {
  int keys;      // keys that carry weight: min(valid_len, L), or L where uniform
  bool uniform;  // valid_len <= 0: every row a uniform softmax over the L keys
  bool active;   // this warp's keys carry weight (part 1: keys > 64), warp-uniform
  unsigned long long row_g, row_g8;  // flat dropout indices of rows r0 + g and r0 + g + 8
  bool aligned;  // L % 4 == 0 (the keep bits' Philox groups)
};

__device__ __forceinline__ Rows rows_of(int valid_len, int L, int r0, int part, int g) {
  Rows r;
  r.uniform = valid_len <= 0;
  r.keys = r.uniform ? L : min(valid_len, L);
  r.active = part == 0 || r.keys > kMaxLen / 2;
  r.row_g = ((unsigned long long)blockIdx.x * L + r0 + g) * L;
  r.row_g8 = r.row_g + 8ull * L;
  r.aligned = (L & 3) == 0;
  return r;
}

// s = P, the softmax of the group's rows r0 .. r0 + 15 at this warp's keys
// (f32, before dropout; 0 at masked keys), and keep: bit 4n + e for element
// e of tile n (kDrop).  sq, sk: the staged Q and K (row stride ld); kQOnce:
// keep Q's fragments in registers across the key steps.  All 64 threads of
// the group call it.
template <int Dp, bool kDrop, bool kQOnce>
__device__ __forceinline__ void weights(float (&s)[kTiles][4], uint32_t& keep, const bf16_t* sq,
                                        const bf16_t* sk, int ld, int Lp, int r0, int part,
                                        int group, int lane, float scale, const Rows& rows,
                                        const philox::Dropout& drop, PairScratch& pair) {
  constexpr int kSteps = Dp / 16;  // k steps of S
  const int g = lane >> 2, t = lane & 3;
  const int key0 = part * kTiles * 8;  // this warp's first key
  keep = 0u;
  if (rows.active) {
    uint32_t qa[kSteps][4];  // Q's A fragments, loaded once (kQOnce) or at each use
    if (kQOnce && !rows.uniform) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) bf16::load_a(qa[kk], sq, ld, r0, 16 * kk, lane);
    }
#pragma unroll
    for (int pp = 0; pp < kKeySteps; ++pp) {
      const int kr = key_row(key0 + 16 * pp, Lp);
      if (!rows.uniform && kQOnce) {  // both tiles of the 16 keys at once
        bf16::Acc acc[2];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t b[4];
          bf16::load_b_nk(b, sk, ld, kr, 16 * kk, lane);
          bf16::mma_add(acc[0], kk == 0, qa[kk], b[0], b[1]);
          bf16::mma_add(acc[1], kk == 0, qa[kk], b[2], b[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * pp][e] = bf16::value(acc[0], e);
          s[2 * pp + 1][e] = bf16::value(acc[1], e);
        }
      } else if (!rows.uniform) {  // one tile of 8 keys at a time: fewer live registers
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          bf16::Acc acc;
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            uint32_t b[2];
            bf16::load_a(qa[kk], sq, ld, r0, 16 * kk, lane);
            bf16::load_b_nk8(b, sk, ld, kr + 8 * x, 16 * kk, lane);
            bf16::mma_add(acc, kk == 0, qa[kk], b[0], b[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * pp + x][e] = bf16::value(acc, e);
        }
      }
      if (kDrop) {  // the integer work beside the pair's mma
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int n = 2 * pp + x;
          keep |= tf32::tile_keep(drop, rows.row_g, rows.row_g8, key0 + 8 * n, t, rows.aligned)
                  << (4 * n);
        }
      }
    }
  }
  // every score equal or masked: zeroed here, after the loop, so that no S
  // register is live before the loop computes it
  if (!rows.active || rows.uniform) {
#pragma unroll
    for (int n = 0; n < kTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  }
  GAN_PROBE(2);  // S and the keep bits

  // scale and mask (uniform: every kept score equal, so use 0); max per row
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = key0 + 8 * n + 2 * t + (e & 1);
      s[n][e] = j < rows.keys ? s[n][e] * scale : -INFINITY;
    }
    m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
    m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
  }
  m0 = tf32::quad_max(m0);
  m1 = tf32::quad_max(m1);
  if (t == 0) {
    pair.max[part][g] = m0;
    pair.max[part][g + 8] = m1;
  }
  pair_sync(group);
  m0 = fmaxf(pair.max[0][g], pair.max[1][g]);  // finite: key 0 is never masked
  m1 = fmaxf(pair.max[0][g + 8], pair.max[1][g + 8]);
  double l0 = 0.0, l1 = 0.0;  // the row sums, exact: the same f32 whatever the order
  uint32_t least = ~0u;  // the least tiny_key of the thread's weights
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {  // masked scores give exp(-inf) = 0
    s[n][0] = expf(s[n][0] - m0);
    s[n][1] = expf(s[n][1] - m0);
    s[n][2] = expf(s[n][2] - m1);
    s[n][3] = expf(s[n][3] - m1);
    l0 += (double)s[n][0] + (double)s[n][1];
    l1 += (double)s[n][2] + (double)s[n][3];
#pragma unroll
    for (int e = 0; e < 4; ++e) least = min(least, tiny_key(s[n][e]));
  }
  pair_sum(pair.sum, part, group, g, t, quad_sum(l0), quad_sum(l1), l0, l1);
  const float sum0 = (float)l0, sum1 = (float)l1;
  if (__any_sync(0xffffffffu, least < kTinyBits)) {  // rare: a weight below 2^-64
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fdiv_rn(s[n][e], e < 2 ? sum0 : sum1);
    }
  } else {
    const float y0 = __frcp_rn(sum0), y1 = __frcp_rn(sum1);
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = div_rn(s[n][e], e < 2 ? sum0 : sum1, e < 2 ? y0 : y1);
    }
  }
  GAN_PROBE(3);  // softmax, the pair's max and sum combined
}

// Element e of tile n is kept by the dropout mask.
__device__ __forceinline__ bool kept(uint32_t keep, int n, int e) {
  return keep >> (4 * n + e) & 1;
}

// The products of one 16-row step p for n tiles j0 .. j0 + kNt - 1 of 8
// columns from c0: A(m0 .., 16p ..) B(16p .., c0 + 8j ..), one bf16 mma.sync
// each from a zeroed accumulator, into c.
template <int kNt, bool kTrans>
__device__ __forceinline__ void step_products(float (&c)[kNt][4], const bf16_t* a, int lda,
                                              const bf16_t* sb, int ldb, int m0, int c0, int p,
                                              int lane) {
  uint32_t fa[4];
  if (kTrans)
    bf16::load_a_t(fa, a, lda, m0, 16 * p, lane);
  else
    bf16::load_a(fa, a, lda, m0, 16 * p, lane);
#pragma unroll
  for (int j = 0; j < kNt; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  if (kNt == 1) {
    uint32_t b[2];
    bf16::load_b_kn8(b, sb, ldb, 16 * p, c0, lane);
    bf16::mma(c[0], fa, b[0], b[1]);
  } else {
#pragma unroll
    for (int j = 0; j < kNt / 2; ++j) {
      uint32_t b[4];
      bf16::load_b_kn(b, sb, ldb, 16 * p, c0 + 16 * j, lane);
      bf16::mma(c[2 * j], fa, b[0], b[1]);
      bf16::mma(c[2 * j + 1], fa, b[2], b[3]);
    }
  }
}

// o += c exactly (bf16::two_sum), element by element.
template <int kNt>
__device__ __forceinline__ void add_products(bf16::Acc (&o)[kNt], const float (&c)[kNt][4]) {
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) bf16::two_sum(o[j].hi[e], o[j].lo[e], c[j][e]);
  }
}

// o = rows m0 .. m0 + 15, n tiles of 8 columns from c0, of the sum over
// 16-row steps p < steps (>= 1) of A(m, 16p ..) B(16p .., :), with A from
// `a` ([m][k], or [k][m] when kTrans) and B = sb[k][n]; each step's products
// added exactly, in step order.  Software-pipelined: the mma.sync of step p
// + 1 are issued before the adds of step p, in two register sets, so the
// adds hide the mma latency.
template <int kNt, bool kTrans>
__device__ __forceinline__ void product_tiles(bf16::Acc (&o)[kNt], const bf16_t* a, int lda,
                                              const bf16_t* sb, int ldb, int m0, int c0,
                                              int steps, int lane) {
  float ca[kNt][4], cb[kNt][4];
  step_products<kNt, kTrans>(ca, a, lda, sb, ldb, m0, c0, 0, lane);
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[j].hi[e] = ca[j][e];
      o[j].lo[e] = 0.f;
    }
  }
  if (steps == 1) return;
  step_products<kNt, kTrans>(ca, a, lda, sb, ldb, m0, c0, 1, lane);
  int p = 2;  // ca holds step p - 1
#pragma unroll 1
  for (; p + 1 < steps; p += 2) {
    step_products<kNt, kTrans>(cb, a, lda, sb, ldb, m0, c0, p, lane);
    add_products<kNt>(o, ca);
    step_products<kNt, kTrans>(ca, a, lda, sb, ldb, m0, c0, p + 1, lane);
    add_products<kNt>(o, cb);
  }
  if (p < steps) {
    step_products<kNt, kTrans>(cb, a, lda, sb, ldb, m0, c0, p, lane);
    add_products<kNt>(o, ca);
    add_products<kNt>(o, cb);
  } else {
    add_products<kNt>(o, ca);
  }
}

// This warp's half of a 16 x Dp product block (columns part * Dp / 2 ..),
// kChunk n tiles of 8 columns at a time (fewer live registers), each by
// product_tiles.  The two warps of a group split the columns, so no sum
// crosses warps.
template <int Dp, int kChunk, bool kTrans>
__device__ __forceinline__ void half_product(bf16::Acc (&o)[Dp / 16], const bf16_t* a, int lda,
                                             const bf16_t* sb, int ldb, int m0, int part,
                                             int steps, int lane) {
  constexpr int kNt = Dp / 16;  // n tiles of 8 columns: half of Dp
  constexpr int kC = kChunk < kNt ? kChunk : kNt;
#pragma unroll
  for (int j = 0; j < kNt; j += kC) {
    bf16::Acc part_o[kC];
    product_tiles<kC, kTrans>(part_o, a, lda, sb, ldb, m0, part * (Dp / 2) + 8 * j, steps, lane);
#pragma unroll
    for (int i = 0; i < kC; ++i) o[j + i] = part_o[i];
  }
}

// An o of half_product, rounded to bf16, to rows < L of dst (row stride Dh).
template <int Dp>
__device__ __forceinline__ void store_half(bf16_t* __restrict__ dst, const bf16::Acc (&o)[Dp / 16],
                                           int m0, int part, int L, int Dh, bool pairs, int lane) {
  const int g = lane >> 2, t = lane & 3, ra = m0 + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < Dp / 16; ++j) {
    const int c = part * (Dp / 2) + 8 * j + 2 * t;
    if (ra < L)
      bf16::store_pair(dst + (size_t)ra * Dh, c, Dh, pairs, bf16::value(o[j], 0),
                       bf16::value(o[j], 1));
    if (rb < L)
      bf16::store_pair(dst + (size_t)rb * Dh, c, Dh, pairs, bf16::value(o[j], 2),
                       bf16::value(o[j], 3));
  }
}

}  // namespace attn_bf16
