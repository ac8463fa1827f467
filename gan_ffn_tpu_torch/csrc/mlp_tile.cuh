// The tiled product that the MLP kernels (mlp_fwd.cu, mlp_bwd.cu) run on
// Hopper's tensor cores, with the chain's activations and dropout sites.
//
// Products: TF32 mma.sync.m16n8k8 in the 3xTF32 split (mma_tf32.cuh),
// f32-accurate to ~2^-21 a product, where one TF32 pass would miss the 1e-4
// limit (tests/test_torch_mlp_tf32.py).  A block of 4 warps computes a
// 64 x 64 output tile, each warp 32 x 32 (2 x 4 mma tiles), over k-slices
// of 32 that cp.async stages in a ring (of 3 in mlp_bwd.cu: two slices load
// while one multiplies; of 2 in mlp_fwd.cu, for shared memory).  Operands
// are staged as they lie in device memory: the plain A and the transposed B
// as [m][k] and [n][k] tiles (row stride 36 = 4 mod 32 floats), the
// transposed A and the plain B as [k][m] and [k][n] tiles (row stride 72 =
// 8 mod 32), so every fragment load hits 32 banks.
// Copies are 16, 8 or 4 bytes, as the row strides and the pointers allow.
// The reduction's tail is zero-filled; the tail of the output axis is not
// copied, since its products land only in outputs that are never stored.
// An A operand that a block made itself can stay resident in shared memory
// (row stride 4 mod 32), and then only B is staged.
//
// Each output is one accumulator that takes the mma3 sequence of the
// k-slices in ascending order from the start of its reduction, in groups of
// 8.  So z1 = pre(x) W1 + b1, which both kernels compute through
// tile_product on the same tiles from the same pre(x) (pre_kernel), is the
// same bits in the forward and in the backward's recompute: relu' takes in
// the backward the branch that relu took in the forward.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "philox.cuh"

namespace mlp {

constexpr int kBM = 64, kBN = 64, kBK = 32;  // output tile and k-slice
constexpr int kThreads = 128;                // 4 warps of 32 x 32 outputs, 2 x 2
constexpr int kStages = 3;                   // cp.async ring
constexpr int kLdK = kBK + 4;                // [m][k] and [n][k] tiles: 36 = 4 mod 32
constexpr int kLdMN = kBM + 8;               // [k][m] and [k][n] tiles: 72 = 8 mod 32
constexpr int kTile = kBM * kLdK;            // floats of one staged operand tile
static_assert(kBM == kBN && kBK * kLdMN == kTile, "both layouts of a tile take kTile floats");
// One wave of blocks: 4 resident on each of the H100's 132 SMs (registers
// bound them at 128 threads of 128 registers).  Split launches aim for it.
constexpr int kWaveBlocks = 4 * 132;
enum Act { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float act(int a, float x) {
  if (a == kRelu) return fmaxf(x, 0.f);
  if (a == kGelu) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  return x;
}

// d act(z) / dz.
__device__ __forceinline__ float act_grad(int a, float z) {
  if (a == kRelu) return z > 0.f ? 1.f : 0.f;
  if (a == kGelu)
    return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
           z * expf(-0.5f * z * z) * 0.39894228040143268f;
  return 1.f;
}

struct Chain {
  int pre, mid, post;       // Act codes (pre / post kNone: absent)
  int mid_act_first;        // 0 drop_first, 1 act_first
  philox::Dropout site[3];  // pre, mid, post: threshold and scale (the seed: call_seed)
  int on[3];                // rate > 0
  philox::SeedRef seed;     // the call's one seed, in device memory
};

// The call's seed, read from device memory where a site draws (else 0).  A
// kernel reads it where its masks are drawn, so that the chain stays in the
// parameter bank and the seed holds two registers only from there on.
__device__ __forceinline__ unsigned long long call_seed(const Chain& chain) {
  return chain.on[0] | chain.on[1] | chain.on[2] ? philox::resolve(chain.seed) : 0ull;
}

// Dropout site s (0 pre, 1 mid, 2 post) of the chain, drawn from `seed`.
__device__ __forceinline__ philox::Dropout site(const Chain& chain, int s,
                                                unsigned long long seed) {
  return philox::Dropout{seed, chain.site[s].threshold, chain.site[s].scale};
}

// The chain a C entry hands its kernels.
inline Chain make_chain(int pre, int mid, int post, int mid_act_first,
                        const unsigned long long* seed_base, int seed_index,
                        const unsigned int* thresholds, const float* scales, const int* drop_on) {
  Chain chain;
  chain.pre = pre;
  chain.mid = mid;
  chain.post = post;
  chain.mid_act_first = mid_act_first;
  for (int s = 0; s < 3; ++s) {
    chain.site[s] = philox::Dropout{0ull, thresholds[s], scales[s]};
    chain.on[s] = drop_on[s] != 0;
  }
  chain.seed = philox::SeedRef{seed_base, seed_index};
  return chain;
}

// a1 and d1 of z1 with the mid mask value ks.
__device__ __forceinline__ void mid_act(const Chain& chain, float z, float ks, float& a, float& d) {
  if (chain.on[1]) {
    if (chain.mid_act_first) {
      a = act(chain.mid, z) * ks;
      d = ks * act_grad(chain.mid, z);
    } else {
      a = act(chain.mid, z * ks);
      d = act_grad(chain.mid, z * ks) * ks;
    }
  } else {
    a = act(chain.mid, z);
    d = act_grad(chain.mid, z);
  }
}

// p[o .. o + n - 1] (n = 1..4; the rest 0): one 16-byte access when vec4
// (o a multiple of 4, p 16-byte aligned) and n == 4.
__device__ __forceinline__ void load4(const float* p, size_t o, int n, bool vec4, float (&v)[4]) {
  if (vec4 && n == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + o);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? p[o + j] : 0.f;
}

__device__ __forceinline__ void store4(float* p, size_t o, int n, bool vec4, const float (&v)[4]) {
  if (vec4 && n == 4) {
    *reinterpret_cast<float4*>(p + o) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[o + j] = v[j];
}

// Starts copying the kRows x kCols tile whose element (r, c) is
// src[(r0 + r) * ld + c0 + c] into dst (row stride kLd), in copies of W
// floats.  The reduction runs along the rows (kRedRows) or along the
// columns: past its end (r_lim or c_lim) the tile is zero-filled.  Past the
// end of the output axis nothing is copied.
template <int kRows, int kCols, int kLd, bool kRedRows, int W>
__device__ __forceinline__ void load_tile_by(float* dst, const float* __restrict__ src, int ld,
                                             int r0, int r_lim, int c0, int c_lim) {
  constexpr int C = kCols / W;
  static_assert(kRows * C % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int u = 0; u < kRows * C / kThreads; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / C, c = W * (idx % C);
    const bool in_r = r0 + r < r_lim, in_c = c0 + c < c_lim;
    if (kRedRows ? !in_c : !in_r) continue;
    const bool valid = kRedRows ? in_r : in_c;
    tf32::cp_async<W>(dst + r * kLd + c, valid ? src + (size_t)(r0 + r) * ld + c0 + c : src, valid);
  }
}

template <int kRows, int kCols, int kLd, bool kRedRows>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int ld, int r0,
                                          int r_lim, int c0, int c_lim, int vec) {
  if (vec == 4)
    load_tile_by<kRows, kCols, kLd, kRedRows, 4>(dst, src, ld, r0, r_lim, c0, c_lim);
  else if (vec == 2)
    load_tile_by<kRows, kCols, kLd, kRedRows, 2>(dst, src, ld, r0, r_lim, c0, c_lim);
  else
    load_tile_by<kRows, kCols, kLd, kRedRows, 1>(dst, src, ld, r0, r_lim, c0, c_lim);
}

// One operand of a product in device memory: row stride, copy width
// (floats) and the extent of its output axis (rows of A, columns of B).
// With a resident A (tile_product's kResA), p is the shared tile, ld its
// row stride, and vec and lim are unused.
struct Operand {
  const float* p;
  int ld, vec, lim;
};

// Floats of a ring of kS stages of A and B tiles.
__host__ __device__ constexpr int ring_floats(int kS) { return kS * 2 * kTile; }

// acc += sum_k A(r, k) B(k, c) over the 64 x 64 output tile at (m0, n0),
// k in [kbeg, kend).  A(r, k) = kTA ? A[k * lda + r] : A[r * lda + k]; B(k,
// c) = kTB ? B[c * ldb + k] : B[k * ldb + c].  kResA: A is resident in
// shared memory as a [m][k - kbeg] tile (row stride a.ld, 4 mod 32) and only
// B is staged.  The ring (ring_floats(kS)) holds kS stages of tiles; the
// caller owns acc.  Every thread of the block must call, and the ring must
// be free on entry.  An output's sum does not depend on kS: the same mma3
// sequence over the same k-slices.
template <bool kTA, bool kTB, bool kResA, int kS = kStages>
__device__ __forceinline__ void tile_product(float (&acc)[2][4][4], float* ring, const Operand& a,
                                             const Operand& b, int m0, int n0, int kbeg,
                                             int kend) {
  static_assert(!(kResA && kTA), "a resident A is an [m][k] tile");
  static_assert(kS >= 2, "a ring of at least two stages");
  float* sa = ring;               // kS tiles of A
  float* sb = ring + kS * kTile;  // and of B
  const int nk = (kend - kbeg + kBK - 1) / kBK;
  const auto load = [&](int i) {
    const int k0 = kbeg + i * kBK, s = i % kS;
    if constexpr (kTA)
      load_tile<kBK, kBM, kLdMN, true>(sa + s * kTile, a.p, a.ld, k0, kend, m0, a.lim, a.vec);
    else if constexpr (!kResA)
      load_tile<kBM, kBK, kLdK, false>(sa + s * kTile, a.p, a.ld, m0, a.lim, k0, kend, a.vec);
    if constexpr (kTB)
      load_tile<kBN, kBK, kLdK, false>(sb + s * kTile, b.p, b.ld, n0, b.lim, k0, kend, b.vec);
    else
      load_tile<kBK, kBN, kLdMN, true>(sb + s * kTile, b.p, b.ld, k0, kend, n0, b.lim, b.vec);
  };
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (i < nk) load(i);
    tf32::stage_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int i = 0; i < nk; ++i) {
    tf32::stage_wait<kS - 2>();  // slice i is in; every warp is done with slice i - 1
    if (i + kS - 1 < nk) load(i + kS - 1);  // into slice i - 1's buffer
    tf32::stage_commit();
    const float* as = kResA ? a.p + i * kBK : sa + (i % kS) * kTile;
    const int ld_a = kResA ? a.ld : kTA ? kLdMN : kLdK;
    const float* bs = sb + (i % kS) * kTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      tf32::FragA fa[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) fa[x] = tf32::load_a_fast<kTA>(as, ld_a, wm + 16 * x, kk, g, t);
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const tf32::FragB fb =
            tf32::load_b_fast<!kTB>(bs, kTB ? kLdK : kLdMN, kk, wn + 8 * y, g, t);
#pragma unroll
        for (int x = 0; x < 2; ++x) tf32::mma3(acc[x][y], fa[x], fb);
      }
    }
  }
}

// The epilogue's view of an output tile: stage_acc writes the accumulators
// into the ring as a [m][n] tile (row stride kLdMN), once every warp is done
// with the ring, so that each thread then takes 4 consecutive columns of
// kGroups rows, kRowsPer apart (staged_row): 16-byte accesses and one
// Philox call per 4 mask values.
constexpr int kRowsPer = kThreads / (kBN / 4);
constexpr int kGroups = kBM / kRowsPer;

__device__ __forceinline__ void stage_acc(float* ring, const float (&acc)[2][4][4]) {
  tf32::stage_wait<0>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int y = 0; y < 4; ++y)
        *reinterpret_cast<float2*>(ring + (wm + 16 * x + 8 * h + g) * kLdMN + wn + 8 * y + 2 * t) =
            make_float2(acc[x][y][2 * h], acc[x][y][2 * h + 1]);
    }
  }
  __syncthreads();
}

// The thread's first row of the staged tile, and its first column.
__device__ __forceinline__ int staged_row0() { return threadIdx.x / (kBN / 4); }
__device__ __forceinline__ int staged_col() { return 4 * (threadIdx.x % (kBN / 4)); }

// The 4 staged values of the thread's group i (row staged_row0() + kRowsPer i).
__device__ __forceinline__ void staged_row(const float* ring, int i, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(ring + (staged_row0() + kRowsPer * i) * kLdMN +
                                                    staged_col());
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// t1 = act(pre, x) * M_pre over the n elements of an (M, K) input, the mask
// at each element's flat index: the A operand of z1 in both kernels.
__global__ void pre_kernel(const float* __restrict__ x, float* __restrict__ t1, long long n,
                           Chain chain) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = act(chain.pre, x[i]);
  if (chain.on[0])
    t *= philox::keep_scale(site(chain, 0, call_seed(chain)), philox::kPre, (unsigned long long)i);
  t1[i] = t;
}

// Launches pre_kernel on `stream`.
inline cudaError_t launch_pre(const float* x, float* t1, long long n, const Chain& chain,
                              cudaStream_t stream) {
  pre_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, t1, n, chain);
  return cudaGetLastError();
}

}  // namespace mlp
