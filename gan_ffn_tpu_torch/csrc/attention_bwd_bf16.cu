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
// through attention_bf16.cuh (S from bf16 mma.sync with the k steps added
// exactly, the f64 row sums of the warp pair, one rounded division).  As
// there, every sum that the plain version takes exactly is kept order-free:
// the k steps of dP, dQ, dK and dV are added exactly (bf16::Acc) and D is
// summed in f64, each rounded to f32 once; the f32 steps between (dP M, dP -
// D, P (dP - D), * scale) are single rounded operations, as torch runs them.
//
// What bounds it on the H100: at the path's shapes (B = 32 or 30, L = 112,
// (H, Dh) in {(10, 10), (8, 64)}) a launch reads 4 and writes 3 (B, H, L,
// Dh) bf16 tensors (1.6-6.4 MB) and does the work of five L x L x Dh
// products (0.4-2.1 GFLOP): 0.5-1.9 us at 3.35 TB/s, 0.4-2.1 us at 989
// TFLOP/s.  As in the forward, the exact sums and one block's chain of
// dependent steps set the time.
//
// Design: one block per (batch, head), two warps per 16 rows (a group; 14
// warps at L = 112, at most 128 registers a thread, one block an SM), Q and
// K, then V and dO, staged with cp.async (Dh zero-padded to Dp, rows to Lp).
//   1. Each warp, for the group's query rows and its half of the keys: the
//      weights P and keep bits (attention_bf16.cuh), dP = dO V^T one 16-key
//      step at a time, its half of D, combined with the other warp's through
//      shared memory (part 0's half first), dS; it writes A = bf16(P M) and
//      bf16(dS) of its keys into two Lp x Lp shared tiles.
//   -- one barrier --
//   2. Each warp, half of the Dp columns: dQ of the group's 16 query rows
//      (dS K, A from the dS tile by ldmatrix), and dV, dK of its 16 keys
//      (A^T dO, dS^T Q, the transposed A fragments by ldmatrix.trans), over
//      16-row steps, each step's bf16 mma.sync added exactly, the next
//      step's mma.sync issued before the adds (attention_bf16.cuh
//      half_product).
// Nothing is summed across warps but the halves of the row sums and of D,
// in a fixed order, and every sum runs in a fixed order, so two calls give
// the same bits.  Shared memory: the pair scratch, 4 staged tiles and the
// two Lp x Lp tiles, 123,392 B at L = 112 and Dh = 64, 148,480 B at L = 128.

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

// Dp: Dh padded to 16, 32 or 64; kDrop: the forward applied attention-weight dropout.
template <int Dp, bool kDrop>
__global__ void __launch_bounds__(kMaxLen / 16 * 32 * kParts, 1)
attention_bwd_bf16_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                          const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
                          bf16_t* __restrict__ dq, bf16_t* __restrict__ dk,
                          bf16_t* __restrict__ dv, int L, int Dh,
                          const int* __restrict__ valid_len_at, float scale, int vec,
                          philox::DropoutArg drop_at) {
  constexpr int ld = Dp + 8;  // 16 bytes mod 128: ldmatrix rows in 8 bank groups
  constexpr int kSteps = Dp / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GAN_PROBE(0);
  PairScratch* scratch = reinterpret_cast<PairScratch*>(smem_raw);
  const int Lp = round_up(L, 16), lw = Lp + 8;  // lw: the weight tiles' row stride (odd x 16 B)
  bf16_t* sq = reinterpret_cast<bf16_t*>(smem_raw + kScratchBytes);
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
  GAN_PROBE(1);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5, part = warp % kParts, group = warp / kParts;
  const int r0 = group * 16;  // the group's first query row (pass 1) and key (pass 2)
  const int key0 = part * kTiles * 8;  // this warp's first key in pass 1
  const Rows rows = rows_of(__ldg(valid_len_at), L, r0, part, g);
  const philox::Dropout drop = kDrop ? philox::resolve(drop_at) : philox::Dropout{0ull, 0u, 1.f};

  // ---- pass 1: the group's query rows against this warp's keys ----
  float s[kTiles][4];
  uint32_t keep;
  weights<Dp, kDrop, true>(s, keep, sq, sk, ld, Lp, r0, part, group, lane, scale, rows, drop,
                           scratch[group]);
  bf16::wait<0>();  // V and dO are in
  GAN_PROBE(4);
  float dp[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
  double D0 = 0.0, D1 = 0.0;
  if (!rows.uniform && rows.active) {  // uniform: dS = 0, so neither dP nor D is needed
    uint32_t da[kSteps][4];  // dO's A fragments, loaded once
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) bf16::load_a(da[kk], sdo, ld, r0, 16 * kk, lane);
#pragma unroll
    for (int pp = 0; pp < kKeySteps; ++pp) {
      const int kr = key_row(key0 + 16 * pp, Lp);
      bf16::Acc acc[2];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t b[4];
        bf16::load_b_nk(b, sv, ld, kr, 16 * kk, lane);
        bf16::mma_add(acc[0], kk == 0, da[kk], b[0], b[1]);
        bf16::mma_add(acc[1], kk == 0, da[kk], b[2], b[3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[2 * pp + x][e] = bf16::value(acc[x], e);
      }
    }
    // dP M, and this warp's half of D_i = sum_j P_ij (dP M)_ij in f64 (P = 0 at masked keys)
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kDrop) dp[n][e] = kept(keep, n, e) ? __fmul_rn(dp[n][e], drop.scale) : 0.f;
        const double pd = (double)__fmul_rn(dp[n][e], s[n][e]);
        if (e < 2) D0 += pd; else D1 += pd;
      }
    }
  }
  GAN_PROBE(5);  // dP and this warp's half of D
  pair_sum(scratch[group].d, part, group, g, t, quad_sum(D0), quad_sum(D1), D0, D1);
  const float d0 = (float)D0, d1 = (float)D1;
  GAN_PROBE(6);  // D of the pair
  // A = bf16(P M) and dS = bf16(P (dP M - D) * scale) of the group's rows
  // at this warp's keys (< Lp), into the shared tiles
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    const int j0 = key0 + 8 * n;
    if (j0 >= Lp) break;
    float av[4], dv4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      av[e] = kDrop ? (kept(keep, n, e) ? s[n][e] * drop.scale : 0.f) : s[n][e];
      dv4[e] = rows.uniform
                   ? 0.f
                   : __fmul_rn(__fmul_rn(s[n][e], __fsub_rn(dp[n][e], e < 2 ? d0 : d1)), scale);
    }
    const int ra = (r0 + g) * lw + j0 + 2 * t, rb = ra + 8 * lw;
    *reinterpret_cast<uint32_t*>(sa + ra) = bf16::pack(av[0], av[1]);
    *reinterpret_cast<uint32_t*>(sa + rb) = bf16::pack(av[2], av[3]);
    *reinterpret_cast<uint32_t*>(sds + ra) = bf16::pack(dv4[0], dv4[1]);
    *reinterpret_cast<uint32_t*>(sds + rb) = bf16::pack(dv4[2], dv4[3]);
  }
  __syncthreads();  // every row's A and dS are in
  GAN_PROBE(7);

  // ---- pass 2: half of the columns of dQ of the group's query rows, dV
  // and dK of its keys ----
  const bool pairs = vec >= 2;
  const int steps = Lp / 16;
  bf16::Acc o[Dp / 16];
  half_product<Dp, 4, false>(o, sds, lw, sk, ld, r0, part, steps, lane);
  store_half<Dp>(dq + base, o, r0, part, L, Dh, pairs, lane);
  GAN_PROBE(8);
  half_product<Dp, 4, true>(o, sa, lw, sdo, ld, r0, part, steps, lane);
  store_half<Dp>(dv + base, o, r0, part, L, Dh, pairs, lane);
  GAN_PROBE(9);
  half_product<Dp, 4, true>(o, sds, lw, sq, ld, r0, part, steps, lane);
  store_half<Dp>(dk + base, o, r0, part, L, Dh, pairs, lane);
  GAN_PROBE(10);
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
  return kScratchBytes +
         (4 * Lp * (kWidths[width_index(Dh)] + 8) + 2 * Lp * (Lp + 8)) * (int)sizeof(bf16_t);
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
  kernel<<<B * H, block_threads(L), smem, stream>>>(q, k, v, dout, dq, dk, dv, L, Dh, valid_len,
                                                     scale, vec, drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_bwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
