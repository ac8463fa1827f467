// The tile code of the bf16 MLP kernels (mlp_fwd_bf16.cu, mlp_bwd_bf16.cu):
// products on the f64 tensor cores of operands converted from bf16, so each
// product is exact (16 significant bits) and each output the exact sum
// rounded to f32 once, as the plain versions take it
// (ops.attention.exact_matmul); and the z1 of both kernels: t1 = bf16(pre(x)
// M_pre) staged in shared memory by stage_t1, times W1 by z1_product, + b1
// by z1_value.  Both kernels compute z1 through these same functions on the
// same 64 x 64 tiles, in the same k order, so the backward's recompute is the
// forward's bits and relu' takes the branch that relu took.  mlp_fwd_bf16.cu
// says why the f64 tensor cores (the bf16 ones truncate their k-step sums).
//
// A block of 4 warps computes 64 x 64 output tiles, each warp 32 x 32 as
// 2 x 4 tiles of 16 x 8, with Hopper's mma.sync.m16n8k4.f64.  Measured on
// the H100 (cli/dmma_probe.py, "rate"; NVIDIA H100 80GB HBM3, 700 W), the
// m8n8k4 shape peaks at 33 TFLOP/s even with its operands in registers,
// m16n8k4 at 61 of the 67, and with each operand
// widened by F2F just before its mma, as here, m16n8k4 keeps 57 at two
// blocks an SM where m16n8k16 falls to 32.  Operands stay bf16 in shared
// memory and reach registers by ldmatrix (four 8 x 8 bf16 matrices an
// instruction), which hands lane (g, t) = (lane / 4, lane % 4) the pairs of
// k = 2t, 2t + 1 and 2t + 8, 2t + 9 of a 16-deep step; mma j of the step
// takes k = 2t + (j & 1) + 8 (j >> 1) in lane t, in A and in B alike.  Each
// warp widens each element it loads once (f64_of: F2F, exact for every bf16;
// an integer widening that handles zeros, subnormals and inf measured
// slower) and reuses A across its 4 column tiles and B across its 2 row
// tiles.  Element (x, y, e) of the accumulator (at()) is output (wm + 8x +
// g, wn + 8y + 2t + e).
//
// A product's B operand streams through a 3-stage cp.async ring of 32-deep
// slices (Stream); product_start issues its first slices before the previous
// tile's epilogue, so a block moving from tile to tile never waits for a
// cold ring.  chunk_split sizes the blocks' d_ff chunks to whole waves of
// the blocks an SM holds.

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
constexpr int kSlice = 32;         // the rings' k-slice: two k steps of 16
constexpr int kThreads = 128;      // 4 warps of 32 x 32 outputs, 2 x 2
constexpr int kStages = 3;         // product's ring
constexpr int kLdB = kBN + 8;      // 72 bf16: 16 bytes mod 128
constexpr int kSliceElems = kSlice * kLdB;
constexpr int kWaveBlocks = 4 * 132;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride of the resident t1 tile, 8 mod 64 bf16 (ldmatrix rows in 8
// bank groups): K padded to kSlice.
__host__ __device__ constexpr int ld_t1(int K) { return round_up(K, kSlice) + 8; }

// An accumulator tile: a warp's 32 x 32 outputs as 2 x 4 tiles of 16 x 8,
// element i of tile (mt, nt) at row 16 mt + g + 8 (i / 2), column 8 nt + 2t
// + i % 2 (the mma C layout).
using Acc = double[2][4][4];

// Element e of the pair at rows 8x + g, columns 8y + 2t of the warp's tile.
__device__ __forceinline__ double& at(Acc& acc, int x, int y, int e) {
  return acc[x >> 1][y][2 * (x & 1) + e];
}

// d += a b on the f64 tensor cores, one mma.sync.m16n8k4: a0 = A[g][t], a1 =
// A[g + 8][t], b = B[t][g], d_i = D[g + 8 (i / 2)][2t + i % 2] (PTX ISA,
// the .f64 mma fragments).  Each output adds its four products one by one
// in the order of t, from the accumulator (cli/dmma_probe.py, "order").
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The lower (hi false) or upper bf16 of an ldmatrix register as f64: its f32
// bits widened by the conversion unit (F2F), exact for every bf16.
__device__ __forceinline__ double f64_of(uint32_t pair, bool hi) {
  return (double)__uint_as_float(hi ? pair & 0xffff0000u : pair << 16);
}

// acc += one k step of 16 of the warp's 32 x 32 tile, from ldmatrix
// registers: ra[mt] the A fragment (bf16::load_a) of rows 16 mt .. 16 mt +
// 15, rb[p] the B fragments (bf16::load_b_kn) of columns 16 p .. 16 p + 15.
// The step is four mmas j = 0..3, lane t's k of mma j being 2t + (j & 1) + 8
// (j >> 1): half j & 1 of A's register 2 (j >> 1) (rows g) and 2 (j >> 1) +
// 1 (rows g + 8), and of B's register j >> 1 of the column tile.  Each mma's
// operands are converted just before it, so conversions and products
// overlap.
__device__ __forceinline__ void mma_k16(Acc& acc, const uint32_t (&ra)[2][4],
                                        const uint32_t (&rb)[2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    double b[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) b[nt] = f64_of(rb[nt >> 1][2 * (nt & 1) + (j >> 1)], j & 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const double a0 = f64_of(ra[mt][2 * (j >> 1)], j & 1);
      const double a1 = f64_of(ra[mt][2 * (j >> 1) + 1], j & 1);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dmma(acc[mt][nt], a0, a1, b[nt]);
    }
  }
}

// One product's B operand: B[k][n0 .. n0 + 63] for k in [kbeg, kend) (a
// multiple of kSlice long), in device memory with row stride ldb, zero at
// rows >= k_lim and columns >= n_lim, copied vec bf16 at a time.
struct Stream {
  const bf16_t* b;
  int ldb, k_lim, n0, n_lim, vec, kbeg, kend;
};

__device__ __forceinline__ void load_slice(bf16_t* ring, const Stream& s, int i) {
  bf16::load_tile(ring + (i % kStages) * kSliceElems, kLdB, s.b, s.ldb, s.kbeg + i * kSlice,
                  s.k_lim, s.n0, s.n_lim, kSlice, kBN, s.vec);
}

// The first kStages - 1 slices of a product's stream into the ring, which
// must be free: a block issues them before the previous tile's epilogue, so
// that they load while it runs.  Every thread of the block must call.
__device__ __forceinline__ void product_start(bf16_t* ring, const Stream& s) {
  const int nk = (s.kend - s.kbeg) / kSlice;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load_slice(ring, s, i);
    bf16::commit();
  }
}

// acc += A[0 .. 63][k - kbeg] B[k][n0 .. n0 + 63] over the stream's k: the
// exact products of the bf16 operands, summed in f64.  A is resident in
// shared memory (row stride lda, a multiple of 8); B streams through the
// ring in slices of kSlice rows, the first kStages - 1 of them issued by
// product_start(ring, s).  Every thread of the block must call; on return
// the ring is free.
__device__ __forceinline__ void product(Acc& acc, bf16_t* ring, const bf16_t* a, int lda,
                                        const Stream& s) {
  const int nk = (s.kend - s.kbeg) / kSlice;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int i = 0; i < nk; ++i) {
    bf16::wait<kStages - 2>();  // slice i is in; every warp is done with slice i - 1
    if (i + kStages - 1 < nk) load_slice(ring, s, i + kStages - 1);  // into slice i - 1's buffer
    bf16::commit();
    const bf16_t* bs = ring + (i % kStages) * kSliceElems;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16) {
      uint32_t ra[2][4], rb[2][4];
      bf16::load_a(ra[0], a, lda, wm, i * kSlice + kk, lane);
      bf16::load_a(ra[1], a, lda, wm + 16, i * kSlice + kk, lane);
      bf16::load_b_kn(rb[0], bs, kLdB, kk, wn, lane);
      bf16::load_b_kn(rb[1], bs, kLdB, kk, wn + 16, lane);
      mma_k16(acc, ra, rb);
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

// The mask values of a warp tile's row r at columns c0 + 8y, c0 + 8y + 1 (y
// = 0..3; c0 = its first column, even) of dropout site s over a tensor of
// width W: k[y][0], k[y][1] (1 where the site draws none).  A Philox call
// gives four consecutive columns, the pairs of lanes t and t ^ 1 where W % 4
// == 0, so each lane of such a pair draws for two of the four y and hands
// the other lane its half by a shuffle: one call for two pairs, not one each.
// Every lane of the warp must call.
__device__ __forceinline__ void site_row(const Chain& chain, int s, uint32_t stream,
                                         unsigned long long seed, int r, int c0, int W,
                                         float (&k)[4][2]) {
  if (!chain.on[s]) {
#pragma unroll
    for (int y = 0; y < 4; ++y) k[y][0] = k[y][1] = 1.f;
    return;
  }
  const philox::Dropout d = mlp::site(chain, s, seed);
  const unsigned long long row = (unsigned long long)r * W;
  if (W % 4 != 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y) bf16::keep_pair(d, stream, row + c0 + 8 * y, k[y][0], k[y][1]);
    return;
  }
  const int odd = threadIdx.x & 1;  // t & 1: columns 4i + 2 and 4i + 3 of the group
#pragma unroll
  for (int yy = 0; yy < 4; yy += 2) {
    const uint4 w = philox::bits4(d.seed, stream, (row + c0 + 8 * (yy + odd)) >> 2);
    const uint32_t give0 = odd ? w.x : w.z, give1 = odd ? w.y : w.w;
    const uint32_t got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
    const uint32_t got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
    // even lane: its own words 0, 1 for yy, the odd lane's words 0, 1 for yy + 1;
    // odd lane: the even lane's words 2, 3 for yy, its own words 2, 3 for yy + 1
    k[yy][0] = philox::keep(d, odd ? got0 : w.x);
    k[yy][1] = philox::keep(d, odd ? got1 : w.y);
    k[yy + 1][0] = philox::keep(d, odd ? w.z : got0);
    k[yy + 1][1] = philox::keep(d, odd ? w.w : got1);
  }
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

// z1's stream: W1[:, c0 .. c0 + 63] over the whole of K (padded to kSlice).
__device__ __forceinline__ Stream z1_stream(const bf16_t* __restrict__ w1, int K, int H, int c0,
                                           int vec_w1) {
  return Stream{w1, H, K, c0, H, vec_w1, 0, round_up(K, kSlice)};
}

// acc = t1 W1[:, c0 .. c0 + 63] for the staged t1 of the block's rows, the
// stream z1_stream(.., c0, ..) started by product_start.
__device__ __forceinline__ void z1_product(Acc& acc, bf16_t* ring, const bf16_t* t1, int K,
                                           const Stream& s) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;
    }
  }
  product(acc, ring, t1, ld_t1(K), s);
}

// z1 of column c from its exact sum: rounded to f32 once, + b1[c] in f32.
__device__ __forceinline__ float z1_value(double sum, const bf16_t* __restrict__ b1, int c) {
  return (float)sum + __bfloat162float(b1[c]);
}

struct Split {
  int chunk, S;  // d_ff columns of a chunk, and chunks
};

// The blocks of kThreads a kernel of at most 168 registers a thread
// (__launch_bounds__(kThreads, kResident)) keeps resident on an SM.
constexpr int kResident = 3;

// What chunk_split reads of the current device: its SMs, the shared memory
// an SM gives its blocks and the part of it reserved for each block (H100:
// 132, 228 KB and 1 KB).
struct Device {
  int sms, smem_per_sm, smem_per_block;
};

inline cudaError_t current_device(Device* d) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d->smem_per_block, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return err;
}

// How a kernel whose block holds `fixed` bytes of shared memory, and
// `per_tile` more for each 64-column tile of its d_ff chunk, splits d_ff
// over blocks of 64 rows on device `d`: into chunks of `per` tiles (the last
// may be shorter), the per that minimises waves x (per + 1), a block's time
// taken as its tiles and about one tile's worth of staging and epilogue, and
// the resident blocks an SM as its shared memory allows (at most kResident);
// the larger per on a tie.  d_ff split into whole waves of blocks, where
// 64-column chunks of 448 blocks at two or three an SM would take two waves
// for 1.1 or 1.7 waves' work.
inline Split chunk_split(const Device& d, int M, int H, int fixed, int per_tile) {
  const long long rows = (M + kBM - 1) / kBM;
  const int tiles = (H + kBN - 1) / kBN;
  Split best{kBN, tiles};
  long long best_cost = -1;
  for (int per = 1; per <= tiles; ++per) {
    const int resident = d.smem_per_sm / (fixed + per * per_tile + d.smem_per_block);
    if (resident < 1) break;
    const int S = (tiles + per - 1) / per;
    const long long slots = (long long)d.sms * (resident < kResident ? resident : kResident);
    const long long cost = (rows * S + slots - 1) / slots * (per + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = Split{per * kBN, S};
    }
  }
  return best;
}

// The forward's split: its block holds t1, the ring and the a1 tile of its
// chunk (row stride chunk + 8).
inline Split fwd_split(const Device& d, int M, int K, int H) {
  const int fixed = (kBM * ld_t1(K) + kStages * kSliceElems + kBM * 8) * (int)sizeof(bf16_t);
  return chunk_split(d, M, H, fixed, kBM * kBN * (int)sizeof(bf16_t));
}

// The backward's z1 recompute: its block holds t1 and the ring.
inline int z1_smem(int K) { return (kBM * ld_t1(K) + kStages * kSliceElems) * (int)sizeof(bf16_t); }
inline Split z1_split(const Device& d, int M, int K, int H) {
  return chunk_split(d, M, H, z1_smem(K), 0);
}

}  // namespace mlp_bf16
