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
// cores, dense).  The instructions of the exact sums set the time: each k
// step of S and of P V is one mma.sync whose four outputs are added into f32
// pairs (bf16::Acc, seven adds each), about 80k such additions (560k f32
// adds) per block at (112, 64), against a few thousand cycles of mma; with
// the softmax's exp and division and the dropout mask's Philox rounds, two
// blocks keep an SM's schedulers issuing (cli/attention_probes.py).  An f64
// add per output would spend one f32 -> f64 conversion per product element,
// 16 a cycle per SM: about as long as three TF32 products (PERF.md).
//
// Design: one block per (batch, head), two warps per 16 query rows (a
// group; 14 warps at L = 112), two blocks an SM.  Q and K, then V, staged
// with cp.async in two groups, Dh zero-padded to Dp in {16, 32, 64}, rows
// padded to 16.  attention_bf16.cuh computes the weights: each warp of a
// group holds S for its half of the keys (8 tiles, 32 registers a thread)
// and the pair combines its row max and row sum through shared memory, so P
// is normalised before it is rounded to bf16, as the JAX kernel rounds the
// softmax's output (an online rescale would round e^(s - m) instead of P
// and move ~10% of the outputs by one bf16 ulp).  Each warp then writes its
// half of the group's bf16(P M) to an Lp x Lp shared tile, and after one
// barrier computes O for half of the Dp columns over every key that carries
// weight (attention_bf16.cuh half_product), so no sum crosses warps.  Dh =
// 10 pads k to 16; the padded columns are zeros, so they add nothing to S
// and produce O columns that are never stored.  Sums that the plain version
// computes with torch.matmul or a reduction are kept order-free: the k
// steps of S and of P V are added exactly (bf16::Acc) and the row sums are
// taken in f64, each rounded to f32 once, as the plain version rounds its
// exact (f64) sums; so P is the same bits on both sides almost everywhere,
// and so are the rounded outputs.  Every sum runs in a fixed order (no
// atomics), so two calls give the same bits.

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

constexpr int kTwoBlockRows = 112;  // up to these rows a block takes 72 registers a thread, 2 an SM

// Dp: Dh padded to 16, 32 or 64; kDrop: apply the attention-weight dropout
// mask; kLong: L > kTwoBlockRows (one block an SM).
template <int Dp, bool kDrop, bool kLong>
__global__ void __launch_bounds__((kLong ? kMaxLen : kTwoBlockRows) / 16 * 32 * kParts,
                                  kLong ? 1 : 2)
attention_fwd_bf16_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                          const bf16_t* __restrict__ v, bf16_t* __restrict__ out, int L, int Dh,
                          const int* __restrict__ valid_len_at, float scale, int vec,
                          philox::DropoutArg drop_at) {
  constexpr int ld = Dp + 8;  // 16 bytes mod 128: ldmatrix rows in 8 bank groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GAN_PROBE(0);
  PairScratch* scratch = reinterpret_cast<PairScratch*>(smem_raw);
  const int Lp = round_up(L, 16), lw = Lp + 8;  // lw: the weight tile's row stride (odd x 16 B)
  bf16_t* sq = reinterpret_cast<bf16_t*>(smem_raw + kScratchBytes);
  bf16_t* sk = sq + Lp * ld;
  bf16_t* sv = sk + Lp * ld;
  bf16_t* sp = sv + Lp * ld;  // bf16(P M), [query][key]
  const size_t base = (size_t)blockIdx.x * L * Dh;
  bf16::load_tile(sq, ld, q + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);
  bf16::load_tile(sk, ld, k + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);
  bf16::commit();
  bf16::load_tile(sv, ld, v + base, Dh, 0, L, 0, Dh, Lp, Dp, vec);  // lands while S is computed
  bf16::commit();
  bf16::wait<1>();
  GAN_PROBE(1);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5, part = warp % kParts, group = warp / kParts;
  const int r0 = group * 16;  // the group's first query row
  const Rows rows = rows_of(__ldg(valid_len_at), L, r0, part, g);
  const philox::Dropout drop = kDrop ? philox::resolve(drop_at) : philox::Dropout{0ull, 0u, 1.f};

  float s[kTiles][4];
  uint32_t keep;
  // Q's fragments stay in registers but at Dp = 64, where they would spill
  // within the 72 registers of two blocks an SM
  weights<Dp, kDrop, (Dp <= 32)>(s, keep, sq, sk, ld, Lp, r0, part, group, lane, scale, rows,
                                 drop, scratch[group]);
  // the mask in f32, then bf16(P M) of this warp's keys into the weight tile
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    const int j0 = part * kTiles * 8 + 8 * n;
    if (j0 >= Lp) break;
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[e] = kDrop ? (kept(keep, n, e) ? s[n][e] * drop.scale : 0.f) : s[n][e];
    const int ra = (r0 + g) * lw + j0 + 2 * t, rb = ra + 8 * lw;
    *reinterpret_cast<uint32_t*>(sp + ra) = bf16::pack(a[0], a[1]);
    *reinterpret_cast<uint32_t*>(sp + rb) = bf16::pack(a[2], a[3]);
  }
  bf16::wait<0>();  // V is in, and every warp's weights
  GAN_PROBE(4);

  // O = bf16(P M) V over the keys that carry weight (the rest are 0)
  bf16::Acc o[Dp / 16];
  half_product<Dp, 2, false>(o, sp, lw, sv, ld, r0, part, (rows.keys + 15) / 16, lane);
  store_half<Dp>(out + base, o, r0, part, L, Dh, vec >= 2, lane);
  GAN_PROBE(5);
}

using KernelFn = void (*)(const bf16_t*, const bf16_t*, const bf16_t*, bf16_t*, int, int,
                          const int*, float, int, philox::DropoutArg);

// [dropout][L > kTwoBlockRows][width_index]
const KernelFn kKernels[2][2][3] = {
    {{attention_fwd_bf16_kernel<16, false, false>, attention_fwd_bf16_kernel<32, false, false>,
      attention_fwd_bf16_kernel<64, false, false>},
     {attention_fwd_bf16_kernel<16, false, true>, attention_fwd_bf16_kernel<32, false, true>,
      attention_fwd_bf16_kernel<64, false, true>}},
    {{attention_fwd_bf16_kernel<16, true, false>, attention_fwd_bf16_kernel<32, true, false>,
      attention_fwd_bf16_kernel<64, true, false>},
     {attention_fwd_bf16_kernel<16, true, true>, attention_fwd_bf16_kernel<32, true, true>,
      attention_fwd_bf16_kernel<64, true, true>}},
};

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if the geometry is refused).
int gan_attention_fwd_bf16_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxLen || Dh < 1 || Dh > kWidths[2]) return 0;
  const int Lp = round_up(L, 16);
  return kScratchBytes + (3 * Lp * (kWidths[width_index(Dh)] + 8) + Lp * (Lp + 8)) *
                             (int)sizeof(bf16_t);
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
  const KernelFn kernel = kKernels[dropout != 0][L > kTwoBlockRows][width_index(Dh)];
  const cudaError_t e = tf32::configure(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const void* const ptrs[] = {q, k, v, out};
  const int vec = bf16::copy_width(Dh, ptrs, 4);
  const philox::DropoutArg drop{{seed_base, seed_index}, threshold, drop_scale};
  kernel<<<B * H, block_threads(L), smem, stream>>>(q, k, v, out, L, Dh, valid_len, scale, vec,
                                                     drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_fwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
