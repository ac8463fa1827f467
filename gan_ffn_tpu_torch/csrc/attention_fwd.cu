// Fused masked multi-head attention forward for Hopper (sm_90a), f32.
//
// Replaces: gan_ffn_tpu/ops/attention.py::_fwd_kernel (pallas_call at :172),
// reached through fused_attention -> _fused_attention_padded -> _fwd_call.
//
// Computes, per (batch, head):  S = Q K^T / sqrt(Dh) in f32, keys at
// positions >= valid_len set to -1e30 (not -inf: with valid_len = 0 every
// row is a uniform softmax over the L keys, never NaN), softmax over keys in
// f32, optional attention-weight dropout, O = P_drop V.  Operands are
// (B, H, L, Dh) row-major, L <= 128, Dh <= 64.
//
// Dropout: P_drop[b, h, i, j] = P[b, h, i, j] * mask, the mask drawn from
// philox.cuh's stream kAttention at flat index ((b * H + h) * L + i) * L + j
// (ops/dropout.py is its plain twin; attention_bwd.cu draws the same mask).
// The TPU kernel seeds its core PRNG with seed + program_id instead; that
// stream exists only on the TPU.  valid_len and the seed are read from
// device memory by every block (one int; philox.cuh SeedRef), never passed
// by value, so one captured CUDA graph serves every batch of a shape.
//
// What bounds it on the H100: at the path's shapes (B = 32, L = 112,
// (H, Dh) in {(10, 10), (8, 64)}) one launch moves 1.8-7.3 MB and does
// 0.16-0.8 GFLOP: 0.5-2.2 us at 3.35 TB/s, or 1-5 us at the 165 TFLOP/s
// that 3xTF32 gives f32-accurate products.  Latency bounds it: 256-320
// blocks of 7 warps, each a chain of short dependent steps; one block alone
// takes most of the launch's time (cli/attention_probes.py times B = 1
// beside B = 32 and splits a block's cycles by phase).  As on the TPU, the
// (B, H, L, L) scores never reach device memory.
//
// Design: one block per (batch, head), one warp per 16 query rows
// (ceil(L / 16) warps).  Q and K, then V, of the (b, h) are staged in shared
// memory with cp.async in two groups (V lands while S is computed), Dh
// zero-padded to the kernel's width Dp (16, 32 or 64), rows padded to 16,
// copies of 16 or 8 bytes where Dh and the pointers allow.  A warp computes
// its 16 x L score block with TF32 mma.sync in the 3xTF32 split
// (mma_tf32.cuh), f32-exact to ~2^-21, in two halves of 64 keys: each half's
// scores stay in registers, the second half rescales the first's sums once
// (32 score registers a thread, not 64).  Row max and row sum come from quad
// shuffles.  A half whose keys are all past valid_len is skipped; inside a
// half the tile loops carry no per-tile branch, so loads, splits and mma of
// different tiles overlap.  The dropout keep bits (one Philox call per lane
// and tile when L % 4 == 0) are drawn between the k steps of S, where the
// integer work overlaps the tensor cores.  P_drop V reuses the accumulator
// as the A operand, the k order permuted so that no shuffle is needed; at
// Dp < 64 it runs on 64 / Dp interleaved accumulator sets, so there are 8
// independent mma chains at every width.  O is scaled by 1 / l and stored.
// At most 128 registers a thread, so two blocks share an SM: the path's
// 256 blocks at Dh = 64 run in one wave.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxLen = 128;  // keys (and query rows) per block
constexpr int kMaxTiles = kMaxLen / 8;
constexpr int kWidths[3] = {16, 32, 64};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int width_index(int Dh) { return Dh <= 16 ? 0 : Dh <= 32 ? 1 : 2; }

// Dp: Dh padded to 16, 32 or 64; kDrop: apply the attention-weight dropout mask.
template <int Dp, bool kDrop>
__global__ void __launch_bounds__(kMaxLen * 2, 2)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int L, int Dh,
                     const int* __restrict__ valid_len_at, float scale, int vec,
                     philox::DropoutArg drop_at) {
  constexpr int ld = Dp + 4;
  constexpr int kDt = Dp / 8;  // n tiles of O, k steps of S
  constexpr int kHalf = kMaxTiles / 2;
  extern __shared__ __align__(16) float smem[];
  GAN_PROBE(0);
  const int Lp = round_up(L, 16);
  float* sq = smem;
  float* sk = sq + Lp * ld;
  float* sv = sk + Lp * ld;
  const size_t base = (size_t)blockIdx.x * L * Dh;
  tf32::stage<Dp>(sq, q + base, L, Lp, Dh, vec);
  tf32::stage<Dp>(sk, k + base, L, Lp, Dh, vec);
  tf32::stage_commit();
  tf32::stage<Dp>(sv, v + base, L, Lp, Dh, vec);  // lands while S is computed
  tf32::stage_commit();
  tf32::stage_wait<1>();
  GAN_PROBE(1);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's first query row
  const int valid_len = __ldg(valid_len_at);
  const bool uniform = valid_len <= 0;
  const int keys = uniform ? L : min(valid_len, L);
  const int nkt = (keys + 7) / 8;  // key tiles that carry weight
  const bool upper = nkt > kHalf;  // whether tiles 8..15 carry any
  // Tile n's keys start at row 8n; past the staged rows the loads read the
  // last staged tile instead, whose products are then masked or weighted 0.
  // The tile loops carry no per-tile branch, so the compiler can overlap
  // one tile's loads and splits with another's mma.
  const auto key_row = [Lp](int n) { return min(8 * n, Lp - 8); };
  const unsigned long long row_g = ((unsigned long long)blockIdx.x * L + r0 + g) * L;
  const unsigned long long row_g8 = row_g + 8ull * L;
  const bool aligned = (L & 3) == 0;
  const philox::Dropout drop = kDrop ? philox::resolve(drop_at) : philox::Dropout{0ull, 0u, 1.f};

  // The row in two halves of 8 key tiles (64 keys), the second rescaling
  // what the first summed: 32 score registers a thread instead of 64.
  constexpr int kSets = 64 / Dp;  // interleaved accumulator sets of O: 8 mma chains at every width
  float o[kSets][kDt][4];
#pragma unroll
  for (int x = 0; x < kSets; ++x) {
#pragma unroll
    for (int d = 0; d < kDt; ++d) o[x][d][0] = o[x][d][1] = o[x][d][2] = o[x][d][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !upper) break;  // block-uniform
    float s[kHalf][4];
#pragma unroll
    for (int n = 0; n < kHalf; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // keep bit 4n + e for element e of tile n, drawn among the k steps of
    // S so that the integer work overlaps the mma (kHalf / kDt tiles a step)
    uint32_t keep = 0;
    const auto draw = [&](int n) {
      keep |= tf32::tile_keep(drop, row_g, row_g8, 8 * (h * kHalf + n), t, aligned) << (4 * n);
    };
    if (!uniform) {
#pragma unroll
      for (int kk = 0; kk < kDt; ++kk) {
        const tf32::FragA a = tf32::load_a(sq, ld, r0, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < kHalf; ++n)
          tf32::mma3(s[n], a, tf32::load_b_rows(sk, ld, key_row(h * kHalf + n), 8 * kk, g, t));
        if (kDrop) {
#pragma unroll
          for (int n = kk * kHalf / kDt; n < (kk + 1) * kHalf / kDt; ++n) draw(n);
        }
      }
    } else if (kDrop) {
#pragma unroll
      for (int n = 0; n < kHalf; ++n) draw(n);
    }
    GAN_PROBE(2 + 3 * h);  // S and the keep bits
    // scale and mask (uniform: every kept score equal, so use 0); max per row
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int n = 0; n < kHalf; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * (h * kHalf + n) + 2 * t + (e & 1);
        s[n][e] = j < keys ? s[n][e] * scale : -INFINITY;
      }
      x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
      x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
    }
    x0 = tf32::quad_max(x0);  // finite: key 0 is never masked
    x1 = tf32::quad_max(x1);
    if (h == 1) {  // rescale the first half's sums to the new max
      const float c0 = expf(m0 - x0), c1 = expf(m1 - x1);
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int x = 0; x < kSets; ++x) {
#pragma unroll
        for (int d = 0; d < kDt; ++d) {
          o[x][d][0] *= c0;
          o[x][d][1] *= c0;
          o[x][d][2] *= c1;
          o[x][d][3] *= c1;
        }
      }
    }
    m0 = x0;
    m1 = x1;
#pragma unroll
    for (int n = 0; n < kHalf; ++n) {  // masked scores give exp(-inf) = 0
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
      if (kDrop) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = keep >> (4 * n + e) & 1 ? s[n][e] * drop.scale : 0.f;
      }
    }
    GAN_PROBE(3 + 3 * h);  // softmax
    if (h == 0) tf32::stage_wait<0>();  // V is in
#pragma unroll
    for (int n = 0; n < kHalf; ++n) {
      const tf32::FragA a = tf32::acc_as_a(s[n]);
#pragma unroll
      for (int d = 0; d < kDt; ++d)
        tf32::mma3(o[n % kSets][d], a, tf32::load_b_pairs(sv, ld, key_row(h * kHalf + n), 8 * d, g, t));
    }
    GAN_PROBE(4 + 3 * h);  // P V
  }
  const float inv0 = 1.f / tf32::quad_sum(l0), inv1 = 1.f / tf32::quad_sum(l1);
#pragma unroll
  for (int x = 1; x < kSets; ++x) {
#pragma unroll
    for (int d = 0; d < kDt; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[0][d][e] += o[x][d][e];
    }
  }
  const int ra = r0 + g, rb = ra + 8;
  float* oa = out + base + (size_t)ra * Dh;
  float* ob = out + base + (size_t)rb * Dh;
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    const int c = 8 * d + 2 * t;
    tf32::store_pair(oa, c, Dh, ra < L, vec >= 2, o[0][d][0] * inv0, o[0][d][1] * inv0);
    tf32::store_pair(ob, c, Dh, rb < L, vec >= 2, o[0][d][2] * inv1, o[0][d][3] * inv1);
  }
  GAN_PROBE(8);
}

using KernelFn = void (*)(const float*, const float*, const float*, float*, int, int, const int*,
                          float, int, philox::DropoutArg);

// [dropout][width_index]
const KernelFn kKernels[2][3] = {
    {attention_fwd_kernel<16, false>, attention_fwd_kernel<32, false>,
     attention_fwd_kernel<64, false>},
    {attention_fwd_kernel<16, true>, attention_fwd_kernel<32, true>,
     attention_fwd_kernel<64, true>},
};

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if the geometry is refused).
int gan_attention_fwd_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxLen || Dh < 1 || Dh > kWidths[2]) return 0;
  return 3 * round_up(L, 16) * (kWidths[width_index(Dh)] + 4) * (int)sizeof(float);
}

// q, k, v, out: (B, H, L, Dh) f32, contiguous, on the current device;
// valid_len: one int on the device, read by every block.  dropout != 0
// applies the attention-weight mask of the seed that (seed_base,
// seed_index) refers to (philox.cuh SeedRef), threshold and drop_scale.
// Nothing is read from the device on the host, so a graph that records the
// launch replays it with whatever valid_len and seed base hold then.
// Launches on `stream`; returns cudaGetLastError() after the launch.
int gan_attention_fwd(const float* q, const float* k, const float* v, float* out,
                      int B, int H, int L, int Dh, const int* valid_len, float scale,
                      int dropout, const unsigned long long* seed_base, int seed_index,
                      unsigned int threshold, float drop_scale, cudaStream_t stream) {
  const int smem = gan_attention_fwd_smem_bytes(L, Dh);
  if (smem == 0 || B < 1 || H < 1 || valid_len == nullptr || (dropout && seed_base == nullptr))
    return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kKernels[dropout != 0][width_index(Dh)];
  const cudaError_t e = tf32::configure(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const void* const ptrs[] = {q, k, v, out};
  const int vec = tf32::stage_width(Dh, ptrs, 4);
  const philox::DropoutArg drop{{seed_base, seed_index}, threshold, drop_scale};
  kernel<<<B * H, 2 * round_up(L, 16), smem, stream>>>(q, k, v, out, L, Dh, valid_len, scale,
                                                        vec, drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
