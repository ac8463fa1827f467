// Fused masked multi-head attention backward for Hopper (sm_90a), bf16.
//
// Replaces: gan_ffn_tpu/ops/attention.py::_bwd_kernel (pallas_call at :197)
// at bfloat16 operands, as the JAX trainers run it under --bf16
// (gan_ffn_tpu/cli/train_iemocap.py:155, train_iemocap_dialoguernn.py:137).
//
// Given dO, computes at the JAX kernel's rounding points:
//   P = the forward's weights, recomputed in f32 (:100),
//   dV = bf16(P M)^T dO with f32 sums, M the dropout mask (:107-110),
//   dP = dO V^T with f32 sums, times M (:111-118),
//   D_i = sum_j P_ij dP_ij,  dS = bf16(P (dP - D) * scale) (:120-121),
//   dQ = dS K,  dK = dS^T Q with f32 sums (:123-133),
//   dQ, dK, dV rounded to bf16 (:134-136).
// At valid_len <= 0 (every key masked) the gradient of the mask w.r.t. the
// scores is 0, as in the XLA chain and attention_bwd.cu: dQ = dK = 0.  The
// plain twin is ops/attention.py::_attention_backward_bf16, which rounds at
// the same points.
//
// The weights are the forward kernel's bits: both kernels compute them
// through attention_bf16.cuh (S from bf16 mma.sync with each k step's
// product added in f64, the f64 row sums, one rounded division).  As there,
// every sum that the plain version takes exactly is kept order-free: the k
// steps of dP, dQ, dK and dV are added in f64 and D is summed in f64, each
// rounded to f32 once; the f32 steps between (dP M, dP - D, P (dP - D),
// * scale) are single rounded operations, as torch runs them.
//
// What bounds it on the H100: at the path's shapes (B = 32 or 30, L = 112,
// (H, Dh) in {(10, 10), (8, 64)}) a launch reads 4 and writes 3 (B, H, L,
// Dh) bf16 tensors (1.6-6.4 MB) and does the work of five L x L x Dh
// products (0.4-2.1 GFLOP): 0.5-1.9 us at 3.35 TB/s, 0.4-2.1 us at 989
// TFLOP/s.  As in the f32 kernel, one block's chain of dependent steps sets
// the time.
//
// Design: one block per (batch, head), one warp per 16 rows, Q and K, then
// V and dO, staged with cp.async (Dh zero-padded to Dp, rows to Lp).
//   1. Each warp: its rows' weights P and keep bits (attention_bf16.cuh),
//      dP = dO V^T one 16-key step at a time, D, dS; it writes A = bf16(P M)
//      and bf16(dS) for its 16 rows into two Lp x Lp shared tiles.
//   -- one barrier --
//   2. Each warp: dQ of its 16 query rows (dS K, A from the dS tile by
//      ldmatrix), and dV, dK of its 16 keys (A^T dO, dS^T Q, the transposed
//      A fragments by ldmatrix.trans), over 16-row steps, each step's bf16
//      mma.sync product added in f64.
// Nothing is summed across warps, and every sum runs in a fixed order, so
// two calls give the same bits.  Shared memory: 4 staged tiles and the two
// Lp x Lp tiles, 140 KB at L = 128 and Dh = 64: one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

using bf16::bf16_t;
using namespace attn_bf16;

// The A fragment of A[m][k] = s[k][m] for m in m0 .. m0 + 15, k in k0 ..
// k0 + 15 (s stored [k][m], row stride ld): ldmatrix.trans of the four
// 8 x 8 blocks in the order a0 .. a3 wants them.
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16_t* s, int ld, int m0,
                                         int k0, int lane) {
  const int i = lane >> 3;
  bf16::ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + ((i >> 1) << 3)) * ld + m0 + ((i & 1) << 3));
}

// One 16 x Dp output block: out rows m0 .. m0 + 15 = sum over 16-row steps p
// of A(m, 16p ..) B(16p .., :), with A from `a` ([m][k], or [k][m] when
// kTrans) and B = sb[k][n] (row stride ldb), each step added in f64; rounded
// to bf16 and stored to rows < L of dst (row stride Dh).
template <int Dp, bool kTrans>
__device__ __forceinline__ void block_product(bf16_t* __restrict__ dst, const bf16_t* a, int lda,
                                              const bf16_t* sb, int ldb, int m0, int steps,
                                              int L, int Dh, bool pairs, int lane) {
  const int g = lane >> 2, t = lane & 3, ra = m0 + g, rb = ra + 8;
#pragma unroll
  for (int d = 0; d < Dp / 16; ++d) {
    double o[2][4] = {};
    for (int p = 0; p < steps; ++p) {
      uint32_t fa[4], b[4];
      if (kTrans)
        load_a_t(fa, a, lda, m0, 16 * p, lane);
      else
        bf16::load_a(fa, a, lda, m0, 16 * p, lane);
      bf16::load_b_kn(b, sb, ldb, 16 * p, 16 * d, lane);
      bf16::mma_add(o[0], fa, b[0], b[1]);
      bf16::mma_add(o[1], fa, b[2], b[3]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int c = 16 * d + 8 * x + 2 * t;
      if (ra < L) bf16::store_pair(dst + (size_t)ra * Dh, c, Dh, pairs, (float)o[x][0], (float)o[x][1]);
      if (rb < L) bf16::store_pair(dst + (size_t)rb * Dh, c, Dh, pairs, (float)o[x][2], (float)o[x][3]);
    }
  }
}

// Dp: Dh padded to 16, 32 or 64; kDrop: the forward applied attention-weight dropout.
template <int Dp, bool kDrop>
__global__ void __launch_bounds__(kMaxLen * 2, 1)
attention_bwd_bf16_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                          const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
                          bf16_t* __restrict__ dq, bf16_t* __restrict__ dk,
                          bf16_t* __restrict__ dv, int L, int Dh,
                          const int* __restrict__ valid_len_at, float scale, int vec,
                          philox::DropoutArg drop_at) {
  constexpr int ld = Dp + 8;  // 16 bytes mod 128: ldmatrix rows in 8 bank groups
  constexpr int kSteps = Dp / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = round_up(L, 16), lw = Lp + 8;  // lw: the weight tiles' row stride (odd x 16 B)
  bf16_t* sq = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* sk = sq + Lp * ld;
  bf16_t* sv = sk + Lp * ld;
  bf16_t* sdo = sv + Lp * ld;
  bf16_t* sa = sdo + Lp * ld;  // A = bf16(P M), [query][key]
  bf16_t* sds = sa + Lp * lw;  // bf16(dS), [query][key]
  const size_t base = (size_t)blockIdx.x * L * Dh;
  bf16::load_tile(sq, ld, q + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);
  bf16::load_tile(sk, ld, k + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);
  bf16::commit();
  bf16::load_tile(sv, ld, v + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);  // land while P is computed
  bf16::load_tile(sdo, ld, dout + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);
  bf16::commit();
  bf16::wait<1>();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's first query row (pass 1) and key (pass 2)
  const Rows rows = rows_of(__ldg(valid_len_at), L, r0, g);
  const philox::Dropout drop = kDrop ? philox::resolve(drop_at) : philox::Dropout{0ull, 0u, 1.f};

  // ---- pass 1: the warp's query rows against every key ----
  float s[kMaxTiles][4];
  uint32_t keep[2];
  weights<Dp, kDrop>(s, keep, sq, sk, ld, Lp, r0, lane, scale, rows, drop);
  bf16::wait<0>();  // V and dO are in
  float dp[kMaxTiles][4];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
  double D0 = 0.0, D1 = 0.0;
  if (!rows.uniform) {  // uniform: dS = 0, so neither dP nor D is needed
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !rows.upper) break;  // block-uniform
#pragma unroll
      for (int pp = 0; pp < kPairs / 2; ++pp) {
        const int p = h * kPairs / 2 + pp;
        double acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t a[4], b[4];
          bf16::load_a(a, sdo, ld, r0, 16 * kk, lane);
          bf16::load_b_nk(b, sv, ld, key_row(p, Lp), 16 * kk, lane);
          bf16::mma_add(acc[0], a, b[0], b[1]);
          bf16::mma_add(acc[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[2 * p + x][e] = (float)acc[x][e];
        }
      }
    }
    // dP M, and D_i = sum_j P_ij (dP M)_ij in f64 (P = 0 at masked keys)
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kDrop) dp[n][e] = kept(keep, n, e) ? __fmul_rn(dp[n][e], drop.scale) : 0.f;
        const double pd = (double)__fmul_rn(dp[n][e], s[n][e]);
        if (e < 2) D0 += pd; else D1 += pd;
      }
    }
  }
  const float d0 = (float)quad_sum(D0), d1 = (float)quad_sum(D1);
  // A = bf16(P M) and dS = bf16(P (dP M - D) * scale) of the warp's rows,
  // keys 0 .. Lp - 1, into the shared tiles
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    if (8 * n >= Lp) break;
    float av[4], dv4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      av[e] = kDrop ? (kept(keep, n, e) ? s[n][e] * drop.scale : 0.f) : s[n][e];
      dv4[e] = rows.uniform
                   ? 0.f
                   : __fmul_rn(__fmul_rn(s[n][e], __fsub_rn(dp[n][e], e < 2 ? d0 : d1)), scale);
    }
    const int c = 8 * n + 2 * t, ra = (r0 + g) * lw + c, rb = ra + 8 * lw;
    *reinterpret_cast<uint32_t*>(sa + ra) = bf16::pack(av[0], av[1]);
    *reinterpret_cast<uint32_t*>(sa + rb) = bf16::pack(av[2], av[3]);
    *reinterpret_cast<uint32_t*>(sds + ra) = bf16::pack(dv4[0], dv4[1]);
    *reinterpret_cast<uint32_t*>(sds + rb) = bf16::pack(dv4[2], dv4[3]);
  }
  __syncthreads();  // every row's A and dS are in

  // ---- pass 2: dQ of the warp's query rows, dV and dK of its keys ----
  const bool pairs = vec >= 2;
  const int steps = Lp / 16;
  block_product<Dp, false>(dq + base, sds, lw, sk, ld, r0, steps, L, Dh, pairs, lane);
  block_product<Dp, true>(dv + base, sa, lw, sdo, ld, r0, steps, L, Dh, pairs, lane);
  block_product<Dp, true>(dk + base, sds, lw, sq, ld, r0, steps, L, Dh, pairs, lane);
}

using KernelFn = void (*)(const bf16_t*, const bf16_t*, const bf16_t*, const bf16_t*, bf16_t*,
                          bf16_t*, bf16_t*, int, int, const int*, float, int, philox::DropoutArg);

// [dropout][width_index]
const KernelFn kKernels[2][3] = {
    {attention_bwd_bf16_kernel<16, false>, attention_bwd_bf16_kernel<32, false>,
     attention_bwd_bf16_kernel<64, false>},
    {attention_bwd_bf16_kernel<16, true>, attention_bwd_bf16_kernel<32, true>,
     attention_bwd_bf16_kernel<64, true>},
};

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if the geometry is refused).
int gan_attention_bwd_bf16_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxLen || Dh < 1 || Dh > kWidths[2]) return 0;
  const int Lp = round_up(L, 16);
  return (4 * Lp * (kWidths[width_index(Dh)] + 8) + 2 * Lp * (Lp + 8)) * (int)sizeof(bf16_t);
}

// q, k, v, dout, dq, dk, dv: (B, H, L, Dh) bf16, contiguous, on the current
// device; valid_len: one int on the device.  dropout != 0: the forward
// applied the mask of the seed (seed_base, seed_index) refers to,
// threshold and drop_scale (see gan_attention_fwd_bf16).  Launches on
// `stream`; returns cudaGetLastError().
int gan_attention_bwd_bf16(const bf16_t* q, const bf16_t* k, const bf16_t* v, const bf16_t* dout,
                           bf16_t* dq, bf16_t* dk, bf16_t* dv, int B, int H, int L, int Dh,
                           const int* valid_len, float scale, int dropout,
                           const unsigned long long* seed_base, int seed_index,
                           unsigned int threshold, float drop_scale, cudaStream_t stream) {
  const int smem = gan_attention_bwd_bf16_smem_bytes(L, Dh);
  if (smem == 0 || B < 1 || H < 1 || valid_len == nullptr || (dropout && seed_base == nullptr))
    return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kKernels[dropout != 0][width_index(Dh)];
  const cudaError_t e = tf32::configure(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const void* const ptrs[] = {q, k, v, dout, dq, dk, dv};
  const int vec = bf16::copy_width(Dh, ptrs, 7);
  const philox::DropoutArg drop{{seed_base, seed_index}, threshold, drop_scale};
  kernel<<<B * H, 2 * round_up(L, 16), smem, stream>>>(q, k, v, dout, dq, dk, dv, L, Dh, valid_len,
                                                        scale, vec, drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_bwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
