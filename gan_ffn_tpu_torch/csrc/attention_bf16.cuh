// The attention weights of the bf16 kernels, shared by attention_fwd_bf16.cu
// and attention_bwd_bf16.cu so that the backward recomputes the forward's
// bits: one warp's 16 query rows against every key, S = Q K^T (bf16
// mma.sync, each k step's product added in f64, rounded to f32 once) *
// scale, keys at positions >= valid_len masked, P = softmax(S) with the row
// sums taken in f64 and one rounded division, and the dropout keep bits of
// those positions (philox.cuh's stream kAttention at flat index
// ((b * H + h) * L + i) * L + j).  The forward kernel's notes say why each
// sum is exact; this header holds the code both kernels run.
//
// Layout: Q and K staged in shared memory as [row][Dp + 8] bf16 (Dh
// zero-padded to Dp), Lp = L rounded up to 16 rows.  The warp's S is
// kMaxTiles accumulator tiles of 16 x 8 (mma_bf16.cuh's C layout: element e
// of tile n is row r0 + g + 8 (e >> 1), key 8n + 2t + (e & 1)).

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

constexpr int kMaxLen = 128;            // keys (and query rows) per block
constexpr int kMaxTiles = kMaxLen / 8;  // key tiles of 8 (S accumulators)
constexpr int kPairs = kMaxTiles / 2;   // 16-key steps
constexpr int kWidths[3] = {16, 32, 64};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int width_index(int Dh) { return Dh <= 16 ? 0 : Dh <= 32 ? 1 : 2; }

// Sum over the four lanes that share a row.
__device__ __forceinline__ double quad_sum(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// What one block knows of its (batch, head) before the weights.
struct Rows {
  int keys;     // keys that carry weight: min(valid_len, L), or L where uniform
  bool uniform;  // valid_len <= 0: every row a uniform softmax over the L keys
  bool upper;    // keys 64 .. 127 carry weight
  unsigned long long row_g, row_g8;  // flat dropout indices of rows r0 + g and r0 + g + 8
  bool aligned;  // L % 4 == 0 (the keep bits' Philox groups)
};

__device__ __forceinline__ Rows rows_of(int valid_len, int L, int r0, int g) {
  Rows r;
  r.uniform = valid_len <= 0;
  r.keys = r.uniform ? L : min(valid_len, L);
  r.upper = r.keys > kMaxLen / 2;
  r.row_g = ((unsigned long long)blockIdx.x * L + r0 + g) * L;
  r.row_g8 = r.row_g + 8ull * L;
  r.aligned = (L & 3) == 0;
  return r;
}

// 16-key step p reads keys 16p .. 16p + 15; past the staged rows it reads
// the last staged 16 instead, whose scores are then masked (weight 0).
__device__ __forceinline__ int key_row(int p, int Lp) { return min(16 * p, Lp - 16); }

// s = P, the softmax of the warp's rows r0 .. r0 + 15 over every key (f32,
// before dropout; 0 at masked keys), and keep: bit 4n + e of word n / 8 for
// element e of tile n (kDrop).  sq, sk: the staged Q and K (row stride ld).
template <int Dp, bool kDrop>
__device__ __forceinline__ void weights(float (&s)[kMaxTiles][4], uint32_t (&keep)[2],
                                        const bf16_t* sq, const bf16_t* sk, int ld, int Lp,
                                        int r0, int lane, float scale, const Rows& rows,
                                        const philox::Dropout& drop) {
  constexpr int kSteps = Dp / 16;  // k steps of S
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  keep[0] = keep[1] = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !rows.upper) break;  // block-uniform
#pragma unroll
    for (int pp = 0; pp < kPairs / 2; ++pp) {
      const int p = h * kPairs / 2 + pp;
      if (!rows.uniform) {
        double acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t a[4], b[4];
          bf16::load_a(a, sq, ld, r0, 16 * kk, lane);
          bf16::load_b_nk(b, sk, ld, key_row(p, Lp), 16 * kk, lane);
          bf16::mma_add(acc[0], a, b[0], b[1]);
          bf16::mma_add(acc[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * p][e] = (float)acc[0][e];
          s[2 * p + 1][e] = (float)acc[1][e];
        }
      }
      if (kDrop) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int n = 2 * p + x;
          keep[n / 8] |= tf32::tile_keep(drop, rows.row_g, rows.row_g8, 8 * n, t, rows.aligned)
                         << (4 * (n % 8));
        }
      }
    }
  }

  // scale and mask (uniform: every kept score equal, so use 0); max per row
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * n + 2 * t + (e & 1);
      s[n][e] = j < rows.keys ? s[n][e] * scale : -INFINITY;
    }
    m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
    m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
  }
  m0 = tf32::quad_max(m0);  // finite: key 0 is never masked
  m1 = tf32::quad_max(m1);
  double l0 = 0.0, l1 = 0.0;  // the row sums, exact: the same f32 whatever the order
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {  // masked scores give exp(-inf) = 0
    s[n][0] = expf(s[n][0] - m0);
    s[n][1] = expf(s[n][1] - m0);
    s[n][2] = expf(s[n][2] - m1);
    s[n][3] = expf(s[n][3] - m1);
    l0 += (double)s[n][0] + (double)s[n][1];
    l1 += (double)s[n][2] + (double)s[n][3];
  }
  const float sum0 = (float)quad_sum(l0), sum1 = (float)quad_sum(l1);
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fdiv_rn(s[n][e], e < 2 ? sum0 : sum1);
  }
}

// Element e of tile n is kept by the dropout mask.
__device__ __forceinline__ bool kept(const uint32_t (&keep)[2], int n, int e) {
  return keep[n / 8] >> (4 * (n % 8) + e) & 1;
}

}  // namespace attn_bf16
