// Fused masked multi-head attention forward for Hopper (sm_90a), bf16.
//
// Replaces: gan_ffn_tpu/ops/attention.py::_fwd_kernel (pallas_call at :172)
// at bfloat16 operands, as the JAX package runs it with dtype=bfloat16 (the
// serving variant serving.bf16_variant, cli/predict.py --bf16).
//
// Computes, per (batch, head), at the JAX kernel's rounding points:
//   S = Q K^T (bf16 operands, sums rounded to f32) * 1/sqrt(Dh) in f32, keys at
//   positions >= valid_len set to -1e30 (here -inf, which gives the same
//   weights: with valid_len <= 0 every row is a uniform softmax over the L
//   keys), P = softmax(S) in f32, optional attention-weight dropout in f32,
//   P rounded to bf16 (gan_ffn_tpu/ops/attention.py:75), O = P V with f32
//   sums, O rounded to bf16 (:83).  Operands (B, H, L, Dh) row-major bf16,
//   L <= 128, Dh <= 64.  The plain twin is ops/attention.py::attention_plain
//   at bf16, which rounds at the same points.
//
// Dropout and the scalars, as in attention_fwd.cu: the mask of philox.cuh's
// stream kAttention at flat index ((b * H + h) * L + i) * L + j, valid_len
// and the seed read from device memory by every block.
//
// What bounds it on the H100: at the serving shapes (B = 32, L = 112, (H,
// Dh) in {(10, 10), (8, 64)}) a launch moves 0.9-3.7 MB and does 0.16-0.8
// GFLOP: 0.3-1.1 us at 3.35 TB/s, 0.2-0.8 us at 989 TFLOP/s (bf16 tensor
// cores, dense).  As in the f32 kernel, a block's chain of dependent steps
// (staging, S, the row reductions, P V) sets the time, not the card's rates.
//
// Design: the f32 kernel's layout (one block per (batch, head), one warp per
// 16 query rows; Q and K, then V, staged with cp.async in two groups, Dh
// zero-padded to Dp in {16, 32, 64}, rows padded to 16), with one bf16
// mma.m16n8k16 per product step (mma_bf16.cuh) and ldmatrix fragment loads.
// Dh = 10 pads k to 16; the padded columns are zeros, so they add nothing to
// S and produce O columns that are never stored.  Unlike the f32 kernel, a
// warp holds its whole 16 x L row block of S (64 registers a thread): P must
// be normalised before it is rounded to bf16, as the JAX kernel rounds the
// softmax's output, so the row's max and sum are complete before P V starts
// (an online rescale would round e^(s - m) instead of P and move ~10% of the
// outputs by one bf16 ulp).  Keys past the staged rows read the last staged
// 16 keys and are masked; the upper 64 keys are skipped where valid_len
// leaves them no weight.  Two neighbouring S tiles, rounded, are the A
// fragment of P V as they lie in the registers, in natural key order.
// Sums that the plain version computes with torch.matmul or a reduction
// are kept order-free: the k steps of S and of P V are added in f64
// (bf16::mma_add) and the row sums are taken in f64, each rounded to f32
// once, as the plain version rounds its exact (f64) sums; so P is the same
// bits on both sides almost everywhere, and so are the rounded outputs.
// The weights (S, mask, softmax, keep bits) come from attention_bf16.cuh,
// which attention_bwd_bf16.cu calls too, so its recomputed P is these bits.

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

// Dp: Dh padded to 16, 32 or 64; kDrop: apply the attention-weight dropout mask.
template <int Dp, bool kDrop>
__global__ void __launch_bounds__(kMaxLen * 2, 2)
attention_fwd_bf16_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                          const bf16_t* __restrict__ v, bf16_t* __restrict__ out, int L, int Dh,
                          const int* __restrict__ valid_len_at, float scale, int vec,
                          philox::DropoutArg drop_at) {
  constexpr int ld = Dp + 8;    // 16 bytes mod 128: ldmatrix rows in 8 bank groups
  constexpr int kDt = Dp / 8;      // n tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* sq = reinterpret_cast<bf16_t*>(smem_raw);
  const int Lp = round_up(L, 16);
  bf16_t* sk = sq + Lp * ld;
  bf16_t* sv = sk + Lp * ld;
  const size_t base = (size_t)blockIdx.x * L * Dh;
  bf16::load_tile(sq, ld, q + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);
  bf16::load_tile(sk, ld, k + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);
  bf16::commit();
  bf16::load_tile(sv, ld, v + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);  // lands while S is computed
  bf16::commit();
  bf16::wait<1>();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's first query row
  const Rows rows = rows_of(__ldg(valid_len_at), L, r0, g);
  const philox::Dropout drop = kDrop ? philox::resolve(drop_at) : philox::Dropout{0ull, 0u, 1.f};

  float s[kMaxTiles][4];
  uint32_t keep[2];
  weights<Dp, kDrop>(s, keep, sq, sk, ld, Lp, r0, lane, scale, rows, drop);
  // the mask in f32; rounded to bf16 pairs, the A fragments of P V
  uint32_t pa[kPairs][4];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    if (kDrop) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = kept(keep, n, e) ? s[n][e] * drop.scale : 0.f;
    }
    if (n % 2 == 1) bf16::acc_pair_as_a(pa[n / 2], s[n - 1], s[n]);
  }

  bf16::wait<0>();  // V is in
  const int ra = r0 + g, rb = ra + 8;
  const bool pairs = vec >= 2;
#pragma unroll
  for (int d = 0; d < kDt / 2; ++d) {  // 16 columns of O at a time, summed in f64
    double o[2][4] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !rows.upper) break;  // block-uniform
#pragma unroll
      for (int pp = 0; pp < kPairs / 2; ++pp) {
        const int p = h * kPairs / 2 + pp;
        uint32_t b[4];
        bf16::load_b_kn(b, sv, ld, key_row(p, Lp), 16 * d, lane);
        bf16::mma_add(o[0], pa[p], b[0], b[1]);
        bf16::mma_add(o[1], pa[p], b[2], b[3]);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int c = 16 * d + 8 * x + 2 * t;
      if (ra < L)
        bf16::store_pair(out + base + (size_t)ra * Dh, c, Dh, pairs, (float)o[x][0], (float)o[x][1]);
      if (rb < L)
        bf16::store_pair(out + base + (size_t)rb * Dh, c, Dh, pairs, (float)o[x][2], (float)o[x][3]);
    }
  }
}

using KernelFn = void (*)(const bf16_t*, const bf16_t*, const bf16_t*, bf16_t*, int, int,
                          const int*, float, int, philox::DropoutArg);

// [dropout][width_index]
const KernelFn kKernels[2][3] = {
    {attention_fwd_bf16_kernel<16, false>, attention_fwd_bf16_kernel<32, false>,
     attention_fwd_bf16_kernel<64, false>},
    {attention_fwd_bf16_kernel<16, true>, attention_fwd_bf16_kernel<32, true>,
     attention_fwd_bf16_kernel<64, true>},
};

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if the geometry is refused).
int gan_attention_fwd_bf16_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxLen || Dh < 1 || Dh > kWidths[2]) return 0;
  return 3 * round_up(L, 16) * (kWidths[width_index(Dh)] + 8) * (int)sizeof(bf16_t);
}

// q, k, v, out: (B, H, L, Dh) bf16, contiguous, on the current device;
// valid_len: one int on the device, read by every block.  dropout != 0
// applies the attention-weight mask of the seed that (seed_base,
// seed_index) refers to (philox.cuh SeedRef), threshold and drop_scale.
// Launches on `stream`; returns cudaGetLastError() after the launch.
int gan_attention_fwd_bf16(const bf16_t* q, const bf16_t* k, const bf16_t* v, bf16_t* out, int B,
                           int H, int L, int Dh, const int* valid_len, float scale, int dropout,
                           const unsigned long long* seed_base, int seed_index,
                           unsigned int threshold, float drop_scale, cudaStream_t stream) {
  const int smem = gan_attention_fwd_bf16_smem_bytes(L, Dh);
  if (smem == 0 || B < 1 || H < 1 || valid_len == nullptr || (dropout && seed_base == nullptr))
    return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kKernels[dropout != 0][width_index(Dh)];
  const cudaError_t e = tf32::configure(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const void* const ptrs[] = {q, k, v, out};
  const int vec = bf16::copy_width(Dh, ptrs, 4);
  const philox::DropoutArg drop{{seed_base, seed_index}, threshold, drop_scale};
  kernel<<<B * H, 2 * round_up(L, 16), smem, stream>>>(q, k, v, out, L, Dh, valid_len, scale, vec,
                                                        drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_fwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
