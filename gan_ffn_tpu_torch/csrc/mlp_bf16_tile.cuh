// The tile code of the bf16 MLP kernels (mlp_fwd_bf16.cu, mlp_bwd_bf16.cu):
// products on the f64 tensor cores (mma.m8n8k4.f64) of operands converted
// from bf16, so each product is exact (16 significant bits) and each output
// the exact sum rounded to f32 once, as the plain versions take it
// (ops.attention.exact_matmul); and the z1 of both kernels: t1 = bf16(pre(x)
// M_pre) staged in shared memory by stage_t1, times W1 by product, + b1 by
// z1_value.  Both kernels compute z1 through these same functions on the
// same tiles, in the same k order, so the backward's recompute is the
// forward's bits and relu' takes the branch that relu took.  mlp_fwd_bf16.cu
// says why the f64 tensor cores (the bf16 ones truncate their k-step sums).
//
// A block of 4 warps computes 64 x 64 output tiles, each warp 32 x 32 as
// 4 x 4 mma tiles of 8 x 8: element e of tile (x, y) of the accumulator is
// output (wm + 8x + g, wn + 8y + 2t + e).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp_tile.cuh"
#include "mma_bf16.cuh"

namespace mlp_bf16 {

using bf16::bf16_t;
using mlp::Chain;

constexpr int kBM = 64, kBN = 64;  // output tile
constexpr int kSlice = 32;         // the rings' k-slice
constexpr int kThreads = 128;      // 4 warps of 32 x 32 outputs, 2 x 2
constexpr int kStages = 2;         // product's ring
constexpr int kLdB = kBN + 8;      // 72 bf16: 16 bytes mod 128
constexpr int kSliceElems = kSlice * kLdB;
constexpr int kMaxChunkTiles = 4;  // d_ff columns a z1 block holds: 4 x 64
constexpr int kWaveBlocks = 4 * 132;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride of the resident t1 tile, 8 mod 64 bf16 (ldmatrix rows in 8
// bank groups): K padded to kSlice.
__host__ __device__ constexpr int ld_t1(int K) { return round_up(K, kSlice) + 8; }

// An accumulator tile: a warp's 32 x 32 outputs as 4 x 4 tiles of 8 x 8.
using Acc = double[4][4][2];

// d += a b on the f64 tensor cores (mma.m8n8k4: a = A[g][t], b = B[t][g],
// d = D[g][2t], D[g][2t + 1]).
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

__device__ __forceinline__ double as_f64(bf16_t x) { return (double)__bfloat162float(x); }

// acc += A[0 .. 63][k - kbeg] B[k][n0 .. n0 + 63] over k in [kbeg, kend)
// (kend - kbeg a multiple of kSlice): the exact products of the bf16
// operands, summed in f64.  A is resident in shared memory (row stride
// lda); B lies in device memory (row stride ldb), zero at rows >= k_lim and
// columns >= n_lim, and streams through the ring in slices of kSlice rows,
// copies of vec bf16.  Every thread of the block must call; on return the
// ring is free.
__device__ __forceinline__ void product(Acc& acc, bf16_t* ring, const bf16_t* a, int lda,
                                        const bf16_t* __restrict__ b, int ldb, int k_lim, int n0,
                                        int n_lim, int vec, int kbeg, int kend) {
  const int nk = (kend - kbeg) / kSlice;
  const auto load = [&](int i) {
    bf16::load_tile(ring + (i % kStages) * kSliceElems, kLdB, b, ldb, kbeg + i * kSlice, k_lim,
                    n0, n_lim, kSlice, kBN, vec);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load(i);
    bf16::commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int i = 0; i < nk; ++i) {
    bf16::wait<kStages - 2>();  // slice i is in; every warp is done with slice i - 1
    if (i + kStages - 1 < nk) load(i + kStages - 1);  // into slice i - 1's buffer
    bf16::commit();
    const bf16_t* as = a + (wm + g) * lda + i * kSlice + t;
    const bf16_t* bs = ring + (i % kStages) * kSliceElems + t * kLdB + wn + g;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 4) {
      double fa[4], fb[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) fa[x] = as_f64(as[8 * x * lda + kk]);
#pragma unroll
      for (int y = 0; y < 4; ++y) fb[y] = as_f64(bs[kk * kLdB + 8 * y]);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) dmma(acc[x][y], fa[x], fb[y]);
      }
    }
  }
  __syncthreads();  // the ring is free again
}

// The mask values of elements idx and idx + 1 of dropout site s (0 pre, 1
// mid, 2 post), 1 where the site draws none.
__device__ __forceinline__ void site_pair(const Chain& chain, int s, uint32_t stream,
                                          unsigned long long seed, unsigned long long idx,
                                          float& k0, float& k1) {
  k0 = k1 = 1.f;
  if (chain.on[s]) bf16::keep_pair(mlp::site(chain, s, seed), stream, idx, k0, k1);
}

// t1 = bf16(pre(x) M_pre) of rows m0 .. m0 + 63 into the shared tile t1
// (row stride ld_t1(K); zero past M and K).  Without pre, x's rows are
// copied (vec: their copy width), and the first product waits for them.
__device__ __forceinline__ void stage_t1(bf16_t* t1, const bf16_t* __restrict__ x, int vec_x,
                                         int m0, int M, int K, const Chain& chain,
                                         unsigned long long seed) {
  const int Kp = round_up(K, kSlice), ldt = ld_t1(K);
  if (chain.pre == mlp::kNone) {
    bf16::load_tile(t1, ldt, x, K, m0, M, 0, K, kBM, Kp, vec_x);
    bf16::commit();  // waited for by the first product
    return;
  }
  for (int idx = threadIdx.x; idx < kBM * Kp / 2; idx += kThreads) {
    const int rl = idx / (Kp / 2), c = 2 * (idx % (Kp / 2)), r = m0 + rl;
    float v0 = 0.f, v1 = 0.f;
    if (r < M && c < K) {
      const size_t o = (size_t)r * K + c;
      float k0, k1;
      site_pair(chain, 0, philox::kPre, seed, o, k0, k1);
      v0 = mlp::act(chain.pre, __bfloat162float(x[o])) * k0;
      if (c + 1 < K) v1 = mlp::act(chain.pre, __bfloat162float(x[o + 1])) * k1;
    }
    *reinterpret_cast<__nv_bfloat162*>(t1 + rl * ldt + c) = __floats2bfloat162_rn(v0, v1);
  }
}

// acc = t1 W1[:, c0 .. c0 + 63] for the staged t1 of the block's rows.
__device__ __forceinline__ void z1_product(Acc& acc, bf16_t* ring, const bf16_t* t1,
                                           const bf16_t* __restrict__ w1, int K, int H, int c0,
                                           int vec_w1) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y][0] = acc[x][y][1] = 0.0;
  }
  product(acc, ring, t1, ld_t1(K), w1, H, K, c0, H, vec_w1, 0, round_up(K, kSlice));
}

// z1 of column c from its exact sum: rounded to f32 once, + b1[c] in f32.
__device__ __forceinline__ float z1_value(double sum, const bf16_t* __restrict__ b1, int c) {
  return (float)sum + __bfloat162float(b1[c]);
}

struct Split {
  int chunk, S;  // d_ff columns of a chunk, and chunks
};

// mlp_fwd.cu's split of d_ff (ops/mlp.py fwd_split mirrors it): at least the
// chunks the a1 tile allows (kMaxChunkTiles 64-column tiles each); where
// that leaves at most half a wave of blocks, s = min(kWaveBlocks / row
// tiles, tiles of d_ff) chunks instead.  A chunk takes ceil(tiles / s)
// 64-column tiles (the last may be shorter; rounding may leave fewer than s).
inline Split fwd_split(int M, int H) {
  const long long rows = (M + kBM - 1) / kBM;
  const int tiles = (H + kBN - 1) / kBN;
  long long s = (tiles + kMaxChunkTiles - 1) / kMaxChunkTiles;
  if (2 * rows * s <= kWaveBlocks) {
    const long long fill = kWaveBlocks / rows < tiles ? kWaveBlocks / rows : tiles;
    if (fill > s) s = fill;
  }
  const int per = (int)((tiles + s - 1) / s);
  return {per * kBN, (tiles + per - 1) / per};
}

}  // namespace mlp_bf16
