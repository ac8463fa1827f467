// Fused two-layer MLP backward for Hopper (sm_90a), f32.
//
// Replaces: gan_ffn_tpu/ops/mlp.py::_bwd_kernel (pallas_call at :292),
// reached through _mlp_bwd.  Forward (mlp_fwd.cu), with the dropout masks of
// philox.cuh's streams kPre, kMid, kPost at flat (row, col) indices:
//   t1 = pre ? act(x) * M_pre : x
//   z1 = t1 W1 + b1;   a1 = act(z1 * M_mid) (drop_first) | act(z1) * M_mid
//   z2 = a1 W2 + b2;   out = post ? act(z2 * M_post) : z2
// Backward, given dout:
//   g   = post ? dout * act'(z2 M_post) M_post : dout        (M, N)
//   dW2 = a1^T g,  db2 = sum_rows g
//   dz1 = (g W2^T) * d1,  d1 = act'(z1 M_mid) M_mid | M_mid act'(z1)   (M, H)
//   dW1 = t1^T dz1,  db1 = sum_rows dz1
//   dx  = pre ? (dz1 W1^T) * M_pre * act'(x) : dz1 W1^T       (M, K)
// act' of the exact-erf gelu is Phi(z) + z phi(z), with erff, as _act_grad.
//
// The TPU kernel sums dW1 / dW2 over row tiles in one resident accumulator,
// which only a sequential grid allows (mlp.py:223-233).  Hopper blocks run in
// no order, so this file splits the work into launches that each own their
// outputs.  One tiled product C = A B (A and B each read plain or
// transposed) with a per-launch epilogue does it:
//   1. t1 (only with pre): elementwise, to a scratch (M, K);
//   2. z1 = t1 W1 + b1 -> a1 and d1, to scratch (M, H) each;
//   3. z2 = a1 W2 + b2 -> g, to a scratch (M, N)   (only with post);
//   4. g W2^T -> dz1 = (g W2^T) * d1, over d1 in place;
//   5. dz1 W1^T -> dx                           (reduces over H);
//   6. [t1 | 1]^T dz1 -> dW1 and, from the ones column, db1   (over M);
//   7. [a1 | 1]^T g   -> dW2 and db2                          (over M).
// The wrapper (ops/mlp.py) allocates the scratch and the workspace of step
// 5-7's split reductions.  Nothing is stored between the forward and the
// backward: the backward recomputes z1, z2 and the masks.
//
// Products: every one runs on the tensor cores as TF32 mma.sync.m16n8k8 in
// the 3xTF32 split (mma_tf32.cuh), f32-accurate to ~2^-21 a product, where
// one TF32 pass would miss the 1e-4 limit (tests/test_torch_mlp_tf32.py).  A
// block computes a 64 x 64 output tile with 4 warps of 32 x 32 (2 x 4 mma
// tiles each), over k-slices of 32 that cp.async stages in a ring of 3, so
// two slices load while one multiplies.  Operands are staged as they lie in
// device memory: the plain A and the transposed B as [m][k] and [n][k] tiles
// (row stride 36 = 4 mod 32 floats), the transposed A and the plain B as
// [k][m] and [k][n] tiles (row stride 72 = 8 mod 32), so every fragment load
// hits 32 banks.  Copies are 16, 8 or 4 bytes, as the row strides and the
// pointers allow.  The reduction's tail is zero-filled; the tail of the
// output axis is not copied, since its products land only in outputs that
// are never stored.  The ones column of steps 6 and 7 is written into the
// staged tiles once and never copied over.
//
// Filling the card: steps 5-7 reduce over a long axis (H or M) into few
// output tiles (16-112 at K or N = 100, on 132 SMs).  Where a launch has at
// most half a wave of blocks (kWaveBlocks / 2 = 264), the reduction is split
// into S contiguous chunks of whole k-slices (the last may be shorter), S
// about as many as fill one wave (split_reduction; ops/mlp.py mirrors it):
// 448-528 blocks at the path's geometries.  A target of 256 blocks (2 an
// SM) left those launches 3-30% slower on the H100 (PERF.md, "Filling the
// card").  Each (tile, chunk) block writes its partial tile to the
// workspace, and a second kernel sums the S partials in ascending chunk
// order, then applies the epilogue.  Every sum runs in a fixed order, with no float atomics, so two
// calls give the same bits.  Epilogues: each warp writes its accumulator
// fragments (elements (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of
// each mma tile) into a shared tile, and each thread then takes 4
// consecutive columns of 8 rows: 16-byte loads and stores, one Philox call
// for 4 mask values (the same draws at the same flat indices).  The short
// epilogues (dz1, dW) issue every load before their first store; the long
// ones (Philox, activations) run as one rolled loop over the 8 groups,
// since 8 unrolled copies made z1 twice as slow (PERF.md, "Code size").
//
// What bounds it on the H100: operations.  At M = 3584 the products are
// 2 M (K H + H N) flops each for the recompute (z2 only with post) and for
// the four gradient products, e.g. ~37.6 GFLOP for the visual FFN
// 512->2048->512: 0.228 ms at 165 TFLOP/s (495 TFLOP/s TF32 over the three
// products of the split), against ~100 MB of scratch traffic (~30 us at
// 3.35 TB/s).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;  // output tile and k-slice
constexpr int kThreads = 128;                // 4 warps of 32 x 32 outputs, 2 x 2
constexpr int kStages = 3;                   // cp.async ring
constexpr int kLdK = kBK + 4;                // [m][k] and [n][k] tiles: 36 = 4 mod 32
constexpr int kLdMN = kBM + 8;               // [k][m] and [k][n] tiles: 72 = 8 mod 32
constexpr int kTile = kBM * kLdK;            // floats of one staged operand tile
static_assert(kBM == kBN && kBK * kLdMN == kTile, "both layouts of a tile take kTile floats");
constexpr int kSmem = kStages * 2 * kTile * (int)sizeof(float);  // 55,296 bytes
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
  int pre, mid, post;     // Act codes (pre / post kNone: absent)
  int mid_act_first;      // 0 drop_first, 1 act_first
  philox::Dropout site[3];  // pre, mid, post
  int on[3];              // rate > 0
};

enum Epi { kEpiZ1 = 0, kEpiZ2 = 1, kEpiDz1 = 2, kEpiDx = 3, kEpiGrad = 4 };

struct EpiArgs {
  const float* bias;  // z1: b1; z2: b2
  const float* aux;   // z2: dout; dx: x
  float* out0;        // z1: a1; z2: g; dz1: d1 -> dz1 in place; dx: dx; grad: dW
  float* out1;        // z1: d1; grad: db
  int a_cols;         // grad: the real columns of A (the ones column is index a_cols)
};

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

// What the epilogue reads at outputs (r, c .. c + 3) besides the product: z2
// dout, dx x (with pre), dz1 d1.
template <int kEpi>
__device__ __forceinline__ void epi_in(int r, int c, int kM, int kN, bool vec4, const Chain& chain,
                                       const EpiArgs& e, float (&in)[4]) {
  const bool reads = kEpi == kEpiZ2 || kEpi == kEpiDz1 || (kEpi == kEpiDx && chain.pre != kNone);
  if (!reads || r >= kM || c >= kN) return;
  load4(kEpi == kEpiDz1 ? e.out0 : e.aux, (size_t)r * kN + c, min(4, kN - c), vec4, in);
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

// The epilogue of outputs (r, c .. c + 3) of a kM x kN output (c a multiple
// of 4), where they exist: products v, the bias of those columns (z1, z2)
// and `in` from epi_in; vec4: 16-byte accesses (kN % 4 == 0, pointers
// aligned), and then one Philox call draws the four mask values.
template <int kEpi>
__device__ __forceinline__ void epilogue4(int r, int c, const float (&v)[4], const float (&bias)[4],
                                          const float (&in)[4], int kM, int kN, bool vec4,
                                          const Chain& chain, const EpiArgs& e) {
  if (r >= kM || c >= kN) return;
  const size_t o = (size_t)r * kN + c;
  const int n = min(4, kN - c);
  float ks[4] = {1.f, 1.f, 1.f, 1.f}, out0[4], out1[4];
  if (kEpi == kEpiZ1 && chain.on[1]) philox::keep_scale4(chain.site[1], philox::kMid, o, ks);
  if (kEpi == kEpiZ2 && chain.on[2]) philox::keep_scale4(chain.site[2], philox::kPost, o, ks);
  if (kEpi == kEpiDx && chain.on[0]) philox::keep_scale4(chain.site[0], philox::kPre, o, ks);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kEpi == kEpiZ1) {  // kN = H
      mid_act(chain, v[j] + bias[j], ks[j], out0[j], out1[j]);
    } else if (kEpi == kEpiZ2) {  // kN = N
      const float z = v[j] + bias[j];
      out0[j] = in[j] * act_grad(chain.post, chain.on[2] ? z * ks[j] : z) * ks[j];
    } else if (kEpi == kEpiDz1) {  // kN = H
      out0[j] = v[j] * in[j];
    } else if (kEpi == kEpiDx) {  // kN = K
      out0[j] = v[j];
      if (chain.pre != kNone) {
        if (chain.on[0]) out0[j] *= ks[j];
        out0[j] *= act_grad(chain.pre, in[j]);
      }
    } else {  // kEpiGrad: kM = a_cols + 1, row a_cols is the bias
      out0[j] = v[j];
    }
  }
  if (kEpi == kEpiGrad && r == e.a_cols) {
    store4(e.out1, c, n, vec4, out0);
    return;
  }
  store4(e.out0, o, n, vec4, out0);
  if (kEpi == kEpiZ1) store4(e.out1, o, n, vec4, out1);
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

// C[r, c] = sum_k A(r, k) B(k, c) over one 64 x 64 tile of a kM x kN output
// and one chunk of the reduction, k in [z chunk, min((z + 1) chunk, kK)) for
// z = blockIdx.z.  A(r, k) = kTA ? A[k * lda + r] : A[r * lda + k]; B(k, c) =
// kTB ? B[c * ldb + k] : B[k * ldb + c]; vec_a, vec_b: their copy widths.
// For kEpiGrad, A(a_cols, k) = 1 (the ones column that gives the bias).  With
// part == nullptr the block applies the epilogue, else it writes its sums to
// part[z][r][c] for reduce_kernel; vec4: 16-byte epilogue accesses.
template <bool kTA, bool kTB, int kEpi>
__global__ void __launch_bounds__(kThreads, 4)
gemm_kernel(const float* __restrict__ A, int lda, int vec_a, const float* __restrict__ B, int ldb,
            int vec_b, int kM, int kN, int kK, int chunk, float* __restrict__ part, int vec4,
            Chain chain, EpiArgs e) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                    // kStages tiles of A
  float* sb = smem + kStages * kTile;  // and of B
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * chunk, kend = min(kbeg + chunk, kK);
  const int nk = (kend - kbeg + kBK - 1) / kBK;
  const int a_lim = kEpi == kEpiGrad ? e.a_cols : kM;  // rows of A in memory
  const auto load = [&](int i) {
    const int k0 = kbeg + i * kBK, s = i % kStages;
    if constexpr (kTA)
      load_tile<kBK, kBM, kLdMN, true>(sa + s * kTile, A, lda, k0, kend, m0, a_lim, vec_a);
    else
      load_tile<kBM, kBK, kLdK, false>(sa + s * kTile, A, lda, m0, a_lim, k0, kend, vec_a);
    if constexpr (kTB)
      load_tile<kBN, kBK, kLdK, false>(sb + s * kTile, B, ldb, n0, kN, k0, kend, vec_b);
    else
      load_tile<kBK, kBN, kLdMN, true>(sb + s * kTile, B, ldb, k0, kend, n0, kN, vec_b);
  };
  if constexpr (kEpi == kEpiGrad) {  // the ones column, never copied over
    static_assert(kTA, "the ones column lives in a [k][m] tile");
    if (e.a_cols >= m0 && e.a_cols < m0 + kBM) {
      for (int i = threadIdx.x; i < kStages * kBK; i += kThreads)
        sa[(i / kBK) * kTile + (i % kBK) * kLdMN + e.a_cols - m0] = 1.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load(i);
    tf32::stage_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4] = {};
  for (int i = 0; i < nk; ++i) {
    tf32::stage_wait<kStages - 2>();  // slice i is in; every warp is done with slice i - 1
    if (i + kStages - 1 < nk) load(i + kStages - 1);  // into slice i - 1's buffer
    tf32::stage_commit();
    const float* a = sa + (i % kStages) * kTile;
    const float* b = sb + (i % kStages) * kTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      tf32::FragA fa[2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
        fa[x] = tf32::load_a_fast<kTA>(a, kTA ? kLdMN : kLdK, wm + 16 * x, kk, g, t);
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const tf32::FragB fb = tf32::load_b_fast<!kTB>(b, kTB ? kLdK : kLdMN, kk, wn + 8 * y, g, t);
#pragma unroll
        for (int x = 0; x < 2; ++x) tf32::mma3(acc[x][y], fa[x], fb);
      }
    }
  }

  // The tile goes through shared memory (row stride kLdMN), so that each
  // thread takes 4 consecutive columns of 8 rows: 16-byte accesses and one
  // Philox call per 4 mask values.
  tf32::stage_wait<0>();
  float* sc = smem;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int y = 0; y < 4; ++y)
        *reinterpret_cast<float2*>(sc + (wm + 16 * x + 8 * h + g) * kLdMN + wn + 8 * y + 2 * t) =
            make_float2(acc[x][y][2 * h], acc[x][y][2 * h + 1]);
    }
  }
  __syncthreads();
  constexpr int kRowsPer = kThreads / (kBN / 4);  // a thread's rows lie 8 apart
  constexpr int kGroups = kBM / kRowsPer;         // 8 groups of 4 columns a thread
  const int cc = 4 * (threadIdx.x % (kBN / 4)), c = n0 + cc, n = min(4, kN - c);
  const int rt = threadIdx.x / (kBN / 4);  // the thread's first row of the tile
  const auto staged = [&](int i, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(sc + (rt + kRowsPer * i) * kLdMN + cc);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  };
  if ((kEpi == kEpiDx || kEpi == kEpiGrad) && part != nullptr) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int r = m0 + rt + kRowsPer * i;
      float v[4];
      staged(i, v);
      if (r < kM && c < kN) store4(part, ((size_t)blockIdx.z * kM + r) * kN + c, n, vec4, v);
    }
    return;
  }
  float bias[4] = {};
  if ((kEpi == kEpiZ1 || kEpi == kEpiZ2) && c < kN) load4(e.bias, c, n, false, bias);
  if constexpr (kEpi == kEpiDz1 || kEpi == kEpiGrad) {  // short bodies: every load first
    float v[kGroups][4], in[kGroups][4] = {};
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      staged(i, v[i]);
      epi_in<kEpi>(m0 + rt + kRowsPer * i, c, kM, kN, vec4, chain, e, in[i]);
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      epilogue4<kEpi>(m0 + rt + kRowsPer * i, c, v[i], bias, in[i], kM, kN, vec4, chain, e);
  } else {  // Philox and the activations make a long body: one copy of it
#pragma unroll 1
    for (int i = 0; i < kGroups; ++i) {
      float v[4], in[4] = {};
      staged(i, v);
      epi_in<kEpi>(m0 + rt + kRowsPer * i, c, kM, kN, vec4, chain, e, in);
      epilogue4<kEpi>(m0 + rt + kRowsPer * i, c, v, bias, in, kM, kN, vec4, chain, e);
    }
  }
}

// The second pass of a split launch: output (r, c) = part[0][r][c] + ... +
// part[S - 1][r][c], summed in that order, then the epilogue.  One thread per
// 4 consecutive columns.
template <int kEpi>
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, int S, int kM, int kN, int vec4, Chain chain,
              EpiArgs e) {
  const int quads = (kN + 3) / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)kM * quads) return;
  const int r = (int)(i / quads), c = 4 * (int)(i % quads), n = min(4, kN - c);
  const size_t o = (size_t)r * kN + c, stride = (size_t)kM * kN;
  float in[4] = {}, v[4] = {}, p[4];
  epi_in<kEpi>(r, c, kM, kN, vec4, chain, e, in);
  for (int s = 0; s < S; ++s) {
    load4(part, s * stride + o, n, vec4, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += p[j];
  }
  const float bias[4] = {};
  epilogue4<kEpi>(r, c, v, bias, in, kM, kN, vec4, chain, e);
}

// t1 = act(x) * M_pre over (M, K).
__global__ void pre_kernel(const float* __restrict__ x, float* __restrict__ t1, long long n,
                           Chain chain) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = act(chain.pre, x[i]);
  if (chain.on[0]) t *= philox::keep_scale(chain.site[0], philox::kPre, (unsigned long long)i);
  t1[i] = t;
}

struct Split {
  int chunk, S;  // k-extent of a chunk, and chunks
};

// How a launch of `tiles` output tiles splits a reduction of length depth:
// not at all where the tiles make half a wave (kWaveBlocks / 2) alone, else
// into s = min(kWaveBlocks / tiles, slices) chunks of ceil(slices / s)
// k-slices each (the last may be shorter; rounding may leave fewer than s).
Split split_reduction(long long tiles, int depth) {
  const int slices = (depth + kBK - 1) / kBK;
  if (2 * tiles > kWaveBlocks || slices <= 1) return {slices * kBK, 1};
  const int s = (int)(kWaveBlocks / tiles < slices ? kWaveBlocks / tiles : slices);
  const int chunk = (slices + s - 1) / s * kBK;
  return {chunk, (depth + chunk - 1) / chunk};
}

long long tiles_of(int kM, int kN) {
  return (long long)((kM + kBM - 1) / kBM) * ((kN + kBN - 1) / kBN);
}

// Launches C = A B with the epilogue kEpi; where `split`, a grid of at most
// half a wave splits the reduction through the workspace `ws`.
template <bool kTA, bool kTB, int kEpi>
cudaError_t gemm(const float* A, int lda, const float* B, int ldb, int kM, int kN, int kK,
                 bool split, float* ws, const Chain& chain, const EpiArgs& e,
                 cudaStream_t stream) {
  const Split sp = split ? split_reduction(tiles_of(kM, kN), kK) : Split{kK, 1};
  const auto kernel = gemm_kernel<kTA, kTB, kEpi>;
  cudaError_t err = tf32::configure(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const void* const pa[] = {A};
  const void* const pb[] = {B};
  const void* const pout[] = {e.aux, e.out0, e.out1, ws};
  const int vec4 = tf32::stage_width(kN, pout, 4) == 4;
  const dim3 grid((kN + kBN - 1) / kBN, (kM + kBM - 1) / kBM, sp.S);
  kernel<<<grid, kThreads, kSmem, stream>>>(A, lda, tf32::stage_width(lda, pa, 1), B, ldb,
                                            tf32::stage_width(ldb, pb, 1), kM, kN, kK, sp.chunk,
                                            sp.S > 1 ? ws : nullptr, vec4, chain, e);
  err = cudaGetLastError();
  if constexpr (kEpi == kEpiDx || kEpi == kEpiGrad) {
    if (err == cudaSuccess && sp.S > 1) {
      const long long n = (long long)kM * ((kN + 3) / 4);
      reduce_kernel<kEpi><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(ws, sp.S, kM, kN, vec4,
                                                                         chain, e);
      err = cudaGetLastError();
    }
  }
  return err;
}

}  // namespace

extern "C" {

// Floats of workspace gan_mlp_bwd needs for M rows of K -> H -> N: the
// largest S x (outputs) of its split launches (dx; dW1, db1; dW2, db2), 0
// where none splits.
long long gan_mlp_bwd_workspace_floats(int M, int K, int H, int N) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return 0;
  const int out[3][3] = {{M, K, H}, {K + 1, H, M}, {H + 1, N, M}};  // kM, kN, depth
  long long most = 0;
  for (const auto& l : out) {
    const Split sp = split_reduction(tiles_of(l[0], l[1]), l[2]);
    if (sp.S > 1 && (long long)sp.S * l[0] * l[1] > most) most = (long long)sp.S * l[0] * l[1];
  }
  return most;
}

// x (M, K), w1 (K, H), b1 (H), w2 (H, N), b2 (N), dout (M, N) in;
// dx (M, K), dw1 (K, H), db1 (H), dw2 (H, N), db2 (N) out; scratch: t1 (M, K)
// (used only with pre), a1 (M, H), d1 (M, H), g (M, N) (used only with
// post), ws (gan_mlp_bwd_workspace_floats).  All f32, contiguous, on the
// current device.  pre / mid / post: 0 none, 1 relu, 2 gelu; mid_act_first:
// the mid order; thresholds[s], scales[s], drop_on[s]: the dropout of site s
// (pre, mid, post) from `seed`, as gan_mlp_fwd took them.  Launches on
// `stream`; returns the first cudaGetLastError() that is not cudaSuccess,
// else cudaSuccess.
int gan_mlp_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* dout, float* dx, float* dw1, float* db1,
                float* dw2, float* db2, float* t1, float* a1, float* d1, float* g, float* ws,
                int M, int K, int H, int N, int pre, int mid, int post, int mid_act_first,
                unsigned long long seed, const unsigned int* thresholds, const float* scales,
                const int* drop_on, cudaStream_t stream) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  // int flat indices, and the grid's y extent (row tiles of M, K + 1, H + 1)
  if ((long long)M * (K > H ? (K > N ? K : N) : (H > N ? H : N)) >= (1ll << 31) ||
      (long long)(K + 1) * H >= (1ll << 31) || (long long)(H + 1) * N >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)(M > H ? (M > K ? M : K) : (H > K ? H : K)) + 1 > 65535ll * kBM)
    return (int)cudaErrorInvalidValue;
  Chain chain;
  chain.pre = pre;
  chain.mid = mid;
  chain.post = post;
  chain.mid_act_first = mid_act_first;
  for (int s = 0; s < 3; ++s) {
    chain.site[s] = philox::Dropout{seed, thresholds[s], scales[s]};
    chain.on[s] = drop_on[s] != 0;
  }
  cudaError_t err;
#define GAN_MLP_BWD_STEP(call)           \
  err = (call);                          \
  if (err != cudaSuccess) return (int)err;

  const float* t1_in = x;
  if (pre != kNone) {
    const long long n = (long long)M * K;
    pre_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, t1, n, chain);
    GAN_MLP_BWD_STEP(cudaGetLastError());
    t1_in = t1;
  }
  EpiArgs e{};
  e.bias = b1;
  e.out0 = a1;
  e.out1 = d1;
  GAN_MLP_BWD_STEP((gemm<false, false, kEpiZ1>(t1_in, K, w1, H, M, H, K, false, ws, chain, e,
                                               stream)));
  const float* g_in = dout;
  if (post != kNone) {
    e = EpiArgs{};
    e.bias = b2;
    e.aux = dout;
    e.out0 = g;
    GAN_MLP_BWD_STEP((gemm<false, false, kEpiZ2>(a1, H, w2, N, M, N, H, false, ws, chain, e,
                                                 stream)));
    g_in = g;
  }
  e = EpiArgs{};
  e.out0 = d1;  // d1 -> dz1 in place
  GAN_MLP_BWD_STEP((gemm<false, true, kEpiDz1>(g_in, N, w2, N, M, H, N, false, ws, chain, e,
                                               stream)));
  e = EpiArgs{};
  e.aux = x;
  e.out0 = dx;
  GAN_MLP_BWD_STEP((gemm<false, true, kEpiDx>(d1, H, w1, H, M, K, H, true, ws, chain, e, stream)));
  e = EpiArgs{};
  e.out0 = dw1;
  e.out1 = db1;
  e.a_cols = K;
  GAN_MLP_BWD_STEP((gemm<true, false, kEpiGrad>(t1_in, K, d1, H, K + 1, H, M, true, ws, chain, e,
                                                stream)));
  e.out0 = dw2;
  e.out1 = db2;
  e.a_cols = H;
  GAN_MLP_BWD_STEP((gemm<true, false, kEpiGrad>(a1, H, g_in, N, H + 1, N, M, true, ws, chain, e,
                                                stream)));
#undef GAN_MLP_BWD_STEP
  return (int)cudaSuccess;
}

const char* gan_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
