// Fused masked multi-head attention backward for Hopper (sm_90a), f32.
//
// Replaces: gan_ffn_tpu/ops/attention.py::_bwd_kernel (pallas_call at :197),
// reached through _fa_bwd -> _bwd_call.
//
// Given dO, recomputes the forward of attention_fwd.cu (S = Q K^T * scale,
// keys >= valid_len masked to -1e30, P = softmax(S), the dropout mask M of
// philox.cuh's stream kAttention at flat index ((b * H + h) * L + i) * L + j)
// and returns
//   dV = (P * M)^T dO,   dP = dO V^T,   D_i = sum_j P_ij M_ij dP_ij,
//   dS = P * (dP * M - D) * scale,   dQ = dS K,   dK = dS^T Q.
// Nothing from the forward is stored: P and M are recomputed (flash style).
//
// valid_len = 0: the forward is a uniform softmax over all L keys (every
// score is the same -1e30).  The gradient of the mask (masked_fill /
// jnp.where) w.r.t. a masked score is 0, so dQ = dK = 0 and
// dV_j = sum_i M_ij dO_i / L, as autograd of the plain version gives.  The
// Pallas backward does not zero dS at masked keys, so it differs there (on
// top of its L/128 forward quirk); this kernel follows the plain version.
// For valid_len > 0 a masked key has P = 0 exactly, so it adds nothing.
//
// What bounds it on the H100: at the path's shapes one launch reads 4 and
// writes 3 (B, H, L, Dh) tensors (3.2-12.8 MB) and does the work of five
// (L x L x Dh) products (0.4-2.1 GFLOP): 1-4 us at 3.35 TB/s or at the
// 165 TFLOP/s of f32-accurate 3xTF32.  Latency bounds it: one block per
// (b, h) runs a chain of dependent products over at most 128 keys, and at
// Dh = 64 a block needs 159 KB of shared memory, so one block per SM and the
// path's 256 blocks in two waves.  One block alone takes about half the
// launch's time, and pass 2 is the largest share of a block's cycles
// (cli/attention_probes.py).
//
// Design: one block per (batch, head), two warps per 16 rows.  Q and K,
// then V and dO, are staged with cp.async into shared memory in two groups
// (row stride Dp + 4, Dh zero-padded to 16, 32 or 64, copies of 16 or 8
// bytes where Dh and the pointers allow); nothing L x L is kept.  Every
// product is TF32 mma.sync in the 3xTF32 split (mma_tf32.cuh).  Two passes:
//   1. query-major, rows r0 .. r0 + 15, each warp of the pair half of the
//      key tiles: S, with the dropout keep bits drawn between its k steps
//      (the integer work overlaps the mma; each row's byte per tile also
//      goes to shared memory, so the mask is drawn once per launch), then
//      dP = dO V^T; the row max, sum and D_i = sum_j P_ij M_ij dP_ij are
//      combined across the pair through shared memory in a fixed order; dS
//      and the pair's two halves of dQ = dS K, added in order and written
//      once.  Each row keeps (log2 of its sum of exp, D_i) in shared memory.
//   -- one barrier --
//   2. key-major, keys r0 .. r0 + 15, each warp half of the query tiles in
//      chunks of 4 tiles (2 at Dp = 64, for registers): S^T = K Q^T and
//      dP^T = V dO^T recomputed, P^T = exp2 of the scaled score less the
//      row's log2 sum, the keep bits read back at the transposed position,
//      A^T = P^T * M and dS^T; then
//      dV += A^T dO and dK += dS^T Q, the two halves added in order through
//      the freed staging buffers and written once.
// Two warps per group double the warps in flight (14 at L = 112) and halve
// each warp's chain.  The tile loops carry no per-tile branch (a tile past
// the staged rows reads the last one and is masked or weighted 0), so loads,
// splits and mma of different tiles overlap.  A group whose keys are all
// masked writes zeros in pass 2.  Accumulators are reused as A operands
// with the k order permuted, so no shuffle moves them.  Every sum runs in a
// fixed order (no atomics), so two calls give the same bits.  At most 128
// registers a thread (512 threads at L = 128).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxLen = 128;  // rows and keys per block
constexpr int kParts = 2;  // warps per 16-row group
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWidths[3] = {16, 32, 64};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int width_index(int Dh) { return Dh <= 16 ? 0 : Dh <= 32 ? 1 : 2; }

// Rows ra and ra + 8 of kDt accumulator tiles to the (L, Dh) slab dst.
template <int kDt>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float (&acc)[kDt][4],
                                           int ra, int L, int Dh, int t, bool pairs) {
  const int rb = ra + 8;
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    const int c = 8 * d + 2 * t;
    tf32::store_pair(dst + (size_t)ra * Dh, c, Dh, ra < L, pairs, acc[d][0], acc[d][1]);
    tf32::store_pair(dst + (size_t)rb * Dh, c, Dh, rb < L, pairs, acc[d][2], acc[d][3]);
  }
}

// Dp: Dh padded to 16, 32 or 64; kDrop: the forward applied attention-weight dropout.
template <int Dp, bool kDrop>
__global__ void __launch_bounds__(kMaxLen / 16 * 32 * kParts, 1)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int L, int Dh, const int* __restrict__ valid_len_at, float scale, int vec,
                     philox::DropoutArg drop_at) {
  constexpr int ld = Dp + 4;
  constexpr int kDt = Dp / 8;
  constexpr int kPartTiles = (kMaxLen / 8 + kParts - 1) / kParts;  // key or query tiles of a warp
  constexpr int kChunk = Dp == 64 ? 2 : 4;  // query tiles per step of pass 2 (registers)
  extern __shared__ __align__(16) float smem[];
  GAN_PROBE(0);
  const int Lp = round_up(L, 16);
  float* sq = smem;
  float* sk = sq + Lp * ld;
  float* sv = sk + Lp * ld;
  float* sdo = sv + Lp * ld;
  float* sxq = sdo + Lp * ld;               // partial dQ of parts 1.. (then dV, dK go to sq..sdo)
  float2* sst = reinterpret_cast<float2*>(sxq + (kParts - 1) * Lp * ld);  // per row: log2 sum exp, D
  float* sred = reinterpret_cast<float*>(sst + Lp);                       // per part and row: m, l, D
  unsigned char* smask = reinterpret_cast<unsigned char*>(sred + 4 * kParts * Lp);  // keep bits
  const size_t base = (size_t)blockIdx.x * L * Dh;
  tf32::stage<Dp>(sq, q + base, L, Lp, Dh, vec);
  tf32::stage<Dp>(sk, k + base, L, Lp, Dh, vec);
  tf32::stage_commit();
  tf32::stage<Dp>(sv, v + base, L, Lp, Dh, vec);  // land while the keep bits and S are computed
  tf32::stage<Dp>(sdo, dout + base, L, Lp, Dh, vec);
  tf32::stage_commit();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5, part = warp % kParts;
  const int r0 = (warp / kParts) * 16;  // the group's first row: query (pass 1), key (pass 2)
  const int ra = r0 + g, rb = ra + 8;
  const int valid_len = __ldg(valid_len_at);
  const bool uniform = valid_len <= 0;
  const int keys = uniform ? L : min(valid_len, L);
  const unsigned long long bh = blockIdx.x;
  const float scale2 = scale * kLog2e;
  // Tile n's rows start at 8n; past the staged rows the loads read the last
  // staged tile instead, whose products are then masked or weighted 0.  The
  // tile loops carry no per-tile branch, so the compiler can overlap one
  // tile's loads and splits with another's mma.
  const auto tile_row = [Lp](int n) { return min(8 * n, Lp - 8); };
  const philox::Dropout drop = kDrop ? philox::resolve(drop_at) : philox::Dropout{0ull, 0u, 1.f};

  // ---- pass 1: query rows ra, rb; this part's key tiles ----
  {
    const int nkt = (keys + 7) / 8, per = (nkt + kParts - 1) / kParts;
    const int tb = part * per, tn = max(0, min(per, nkt - tb));
    // keep bit 4n + e for element e of tile n, drawn among the k steps of S
    // so that the integer work overlaps the mma (kPartTiles / kDt tiles a
    // step); each row's byte per tile also goes to smask for pass 2
    uint32_t keep = 0;
    const unsigned long long row_a = (bh * L + ra) * L, row_b = row_a + 8ull * L;
    const bool aligned = (L & 3) == 0;
    const auto draw = [&](int n) {
      const uint32_t bits = tf32::tile_keep(drop, row_a, row_b, 8 * (tb + n), t, aligned);
      keep |= bits << (4 * n);
      const uint32_t rows = tf32::tile_keep_rows(bits, t);
      if (t == 0 && n < tn) {
        smask[ra * 16 + tb + n] = (unsigned char)rows;
        smask[rb * 16 + tb + n] = (unsigned char)(rows >> 8);
      }
    };
    float s[kPartTiles][4], dp[kPartTiles][4];
#pragma unroll
    for (int n = 0; n < kPartTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    tf32::stage_wait<1>();  // Q and K are in
    GAN_PROBE(1);
    if (!uniform) {
#pragma unroll
      for (int kk = 0; kk < kDt; ++kk) {
        const tf32::FragA a = tf32::load_a(sq, ld, r0, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < kPartTiles; ++n)
          tf32::mma3(s[n], a, tf32::load_b_rows(sk, ld, tile_row(tb + n), 8 * kk, g, t));
        if (kDrop) {
#pragma unroll
          for (int n = kk * kPartTiles / kDt; n < (kk + 1) * kPartTiles / kDt; ++n) draw(n);
        }
      }
    } else if (kDrop) {
#pragma unroll
      for (int n = 0; n < kPartTiles; ++n) draw(n);
    }
    GAN_PROBE(2);  // S and the keep bits
    tf32::stage_wait<0>();  // V and dO are in
    GAN_PROBE(3);
    float dqa[kDt][4];
#pragma unroll
    for (int d = 0; d < kDt; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;
    // log2 of each row's sum of exp(score) (uniform: L scores of 0), and D
    float lse0 = log2f((float)L), lse1 = lse0, D0 = 0.f, D1 = 0.f;
    if (!uniform) {  // block-uniform: the barriers inside are reached by every thread
#pragma unroll
      for (int kk = 0; kk < kDt; ++kk) {
        const tf32::FragA a = tf32::load_a(sdo, ld, r0, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < kPartTiles; ++n)
          tf32::mma3(dp[n], a, tf32::load_b_rows(sv, ld, tile_row(tb + n), 8 * kk, g, t));
      }
      GAN_PROBE(4);  // dP
      // this part's row max and sum, then the whole row's from all parts
      float h0 = -INFINITY, h1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kPartTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * (tb + n) + 2 * t + (e & 1);
          s[n][e] = n < tn && j < keys ? s[n][e] * scale : -INFINITY;
        }
        h0 = fmaxf(h0, fmaxf(s[n][0], s[n][1]));
        h1 = fmaxf(h1, fmaxf(s[n][2], s[n][3]));
      }
      h0 = tf32::quad_max(h0);
      h1 = tf32::quad_max(h1);
      float l0 = 0.f, l1 = 0.f;
      // masked scores give exp(-inf) = 0, also where this part has no key (h = -inf)
      const float e0 = h0 == -INFINITY ? 0.f : h0, e1 = h1 == -INFINITY ? 0.f : h1;
#pragma unroll
      for (int n = 0; n < kPartTiles; ++n) {
        s[n][0] = expf(s[n][0] - e0);
        s[n][1] = expf(s[n][1] - e0);
        s[n][2] = expf(s[n][2] - e1);
        s[n][3] = expf(s[n][3] - e1);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
      l0 = tf32::quad_sum(l0);
      l1 = tf32::quad_sum(l1);
      float* red = sred + 4 * (part * Lp + r0);
      if (t == 0) {
        red[4 * g] = h0;
        red[4 * g + 1] = l0;
        red[4 * (g + 8)] = h1;
        red[4 * (g + 8) + 1] = l1;
      }
      __syncthreads();
      GAN_PROBE(5);  // row max and sum of the pair
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int x = 0; x < kParts; ++x) {
        const float* r = sred + 4 * (x * Lp + r0);
        m0 = fmaxf(m0, r[4 * g]);
        m1 = fmaxf(m1, r[4 * (g + 8)]);
      }
      float L0 = 0.f, L1 = 0.f;  // the row sums, parts in order
#pragma unroll
      for (int x = 0; x < kParts; ++x) {
        const float* r = sred + 4 * (x * Lp + r0);
        L0 += r[4 * g + 1] * expf(r[4 * g] - m0);
        L1 += r[4 * (g + 8) + 1] * expf(r[4 * (g + 8)] - m1);
      }
      lse0 = (m0 + logf(L0)) * kLog2e;
      lse1 = (m1 + logf(L1)) * kLog2e;
      const float c0 = expf(h0 - m0) / L0, c1 = expf(h1 - m1) / L1;
      // P, dP * M and this part's share of D (P = 0 on the tiles past tn)
#pragma unroll
      for (int n = 0; n < kPartTiles; ++n) {
        s[n][0] *= c0;
        s[n][1] *= c0;
        s[n][2] *= c1;
        s[n][3] *= c1;
        if (kDrop) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[n][e] = (keep >> (4 * n + e)) & 1 ? dp[n][e] * drop.scale : 0.f;
        }
        D0 = fmaf(s[n][0], dp[n][0], D0);
        D0 = fmaf(s[n][1], dp[n][1], D0);
        D1 = fmaf(s[n][2], dp[n][2], D1);
        D1 = fmaf(s[n][3], dp[n][3], D1);
      }
      D0 = tf32::quad_sum(D0);
      D1 = tf32::quad_sum(D1);
      if (t == 0) {
        red[4 * g + 2] = D0;
        red[4 * (g + 8) + 2] = D1;
      }
      __syncthreads();
      GAN_PROBE(6);  // P and D
      D0 = D1 = 0.f;
#pragma unroll
      for (int x = 0; x < kParts; ++x) {
        const float* r = sred + 4 * (x * Lp + r0);
        D0 += r[4 * g + 2];
        D1 += r[4 * (g + 8) + 2];
      }
      // dS, then this part's share of dQ = dS K
#pragma unroll
      for (int n = 0; n < kPartTiles; ++n) {
        s[n][0] *= (dp[n][0] - D0) * scale;
        s[n][1] *= (dp[n][1] - D0) * scale;
        s[n][2] *= (dp[n][2] - D1) * scale;
        s[n][3] *= (dp[n][3] - D1) * scale;
        const tf32::FragA a = tf32::acc_as_a(s[n]);
#pragma unroll
        for (int d = 0; d < kDt; ++d)
          tf32::mma3(dqa[d], a, tf32::load_b_pairs(sk, ld, tile_row(tb + n), 8 * d, g, t));
      }
      GAN_PROBE(7);  // dS and dQ
      if (part) tf32::acc_store<kDt>(sxq + (part - 1) * Lp * ld, ld, r0, dqa, g, t);
      __syncthreads();
      if (!part) {
#pragma unroll
        for (int x = 1; x < kParts; ++x) tf32::acc_add<kDt>(sxq + (x - 1) * Lp * ld, ld, r0, dqa, g, t);
      }
    }
    if (!part) {
      store_tile<kDt>(dq + base, dqa, ra, L, Dh, t, vec >= 2);
      if (t == 0) {
        sst[ra] = make_float2(lse0, D0);
        sst[rb] = make_float2(lse1, D1);
      }
    }
  }
  __syncthreads();  // the stats and the keep bits are in
  GAN_PROBE(8);  // dQ written

  // ---- pass 2: key rows ra, rb; this part's query tiles ----
  float dva[kDt][4], dka[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[d][e] = dka[d][e] = 0.f;
  }
  if (r0 < keys) {  // else every key of the group is masked: dV = dK = 0
    const int nqt = (L + 7) / 8, per = (nqt + kParts - 1) / kParts;
    const int qb = part * per, qn = max(0, min(per, nqt - qb));
    for (int c0 = 0; c0 < qn; c0 += kChunk) {
      float st[kChunk][4], dpt[kChunk][4];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[c][e] = dpt[c][e] = 0.f;
      }
      if (!uniform) {
#pragma unroll
        for (int kk = 0; kk < kDt; ++kk) {
          const tf32::FragA a = tf32::load_a(sk, ld, r0, 8 * kk, g, t);
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            tf32::mma3(st[c], a, tf32::load_b_rows(sq, ld, tile_row(qb + c0 + c), 8 * kk, g, t));
        }
#pragma unroll
        for (int kk = 0; kk < kDt; ++kk) {
          const tf32::FragA a = tf32::load_a(sv, ld, r0, 8 * kk, g, t);
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            tf32::mma3(dpt[c], a, tf32::load_b_rows(sdo, ld, tile_row(qb + c0 + c), 8 * kk, g, t));
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const bool tile_ok = c0 + c < qn;
        const int i0 = tile_row(qb + c0 + c);
        // keep bits of keys r0 .. r0 + 15 for queries i0 + 2t and i0 + 2t + 1
        uint32_t w0 = 0xffffu, w1 = 0xffffu;
        if (kDrop) {
          w0 = *reinterpret_cast<const unsigned short*>(smask + (i0 + 2 * t) * 16 + r0 / 8);
          w1 = *reinterpret_cast<const unsigned short*>(smask + (i0 + 2 * t + 1) * 16 + r0 / 8);
        }
        const float2 stat[2] = {sst[i0 + 2 * t], sst[i0 + 2 * t + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 2 * t + (e & 1), j = (e >> 1) ? rb : ra;
          const float ks = ((e & 1 ? w1 : w0) >> (g + 8 * (e >> 1))) & 1 ? (kDrop ? drop.scale : 1.f) : 0.f;
          float p = 0.f;  // P_ij = 2^(S_ij scale log2(e) - lse2_i)
          if (tile_ok && i < L && j < keys)
            p = exp2f((uniform ? 0.f : st[c][e] * scale2) - stat[e & 1].x);
          st[c][e] = p * ks;                                             // A^T
          dpt[c][e] = p * (dpt[c][e] * ks - stat[e & 1].y) * scale;      // dS^T
        }
        const tf32::FragA a = tf32::acc_as_a(st[c]);
#pragma unroll
        for (int d = 0; d < kDt; ++d)
          tf32::mma3(dva[d], a, tf32::load_b_pairs(sdo, ld, i0, 8 * d, g, t));
        if (!uniform) {
          const tf32::FragA b = tf32::acc_as_a(dpt[c]);
#pragma unroll
          for (int d = 0; d < kDt; ++d)
            tf32::mma3(dka[d], b, tf32::load_b_pairs(sq, ld, i0, 8 * d, g, t));
        }
      }
    }
  }
  GAN_PROBE(9);  // pass 2
  __syncthreads();  // sq .. sdo are free: they take the partial dV and dK of parts 1..
  if (part) {
    tf32::acc_store<kDt>(smem + (2 * part - 2) * Lp * ld, ld, r0, dva, g, t);
    tf32::acc_store<kDt>(smem + (2 * part - 1) * Lp * ld, ld, r0, dka, g, t);
  }
  __syncthreads();
  if (!part) {
#pragma unroll
    for (int x = 1; x < kParts; ++x) {
      tf32::acc_add<kDt>(smem + (2 * x - 2) * Lp * ld, ld, r0, dva, g, t);
      tf32::acc_add<kDt>(smem + (2 * x - 1) * Lp * ld, ld, r0, dka, g, t);
    }
    store_tile<kDt>(dv + base, dva, ra, L, Dh, t, vec >= 2);
    store_tile<kDt>(dk + base, dka, ra, L, Dh, t, vec >= 2);
  }
  GAN_PROBE(10);  // dV, dK written
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*,
                          float*, float*, int, int, const int*, float, int, philox::DropoutArg);

// [dropout][width_index]
const KernelFn kKernels[2][3] = {
    {attention_bwd_kernel<16, false>, attention_bwd_kernel<32, false>,
     attention_bwd_kernel<64, false>},
    {attention_bwd_kernel<16, true>, attention_bwd_kernel<32, true>,
     attention_bwd_kernel<64, true>},
};

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if the geometry is refused).
int gan_attention_bwd_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxLen || Dh < 1 || Dh > kWidths[2]) return 0;
  const int Lp = round_up(L, 16);
  const int Dp = kWidths[width_index(Dh)], P = kParts;
  // Q, K, V, dO and P - 1 partial dQ tiles; log2 sum exp and D; 4 floats
  // per part and row; 16 bytes of keep bits per row
  return ((3 + P) * Lp * (Dp + 4) + 2 * Lp + 4 * P * Lp + 4 * Lp) * (int)sizeof(float);
}

// q, k, v, dout, dq, dk, dv: (B, H, L, Dh) f32, contiguous, on the current
// device; valid_len: one int on the device.  dropout != 0: the forward
// applied the mask of the seed (seed_base, seed_index) refers to,
// threshold and drop_scale (see gan_attention_fwd).  Launches on `stream`;
// returns cudaGetLastError().
int gan_attention_bwd(const float* q, const float* k, const float* v, const float* dout,
                      float* dq, float* dk, float* dv, int B, int H, int L, int Dh,
                      const int* valid_len, float scale, int dropout,
                      const unsigned long long* seed_base, int seed_index,
                      unsigned int threshold, float drop_scale, cudaStream_t stream) {
  const int smem = gan_attention_bwd_smem_bytes(L, Dh);
  if (smem == 0 || B < 1 || H < 1 || valid_len == nullptr || (dropout && seed_base == nullptr))
    return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kKernels[dropout != 0][width_index(Dh)];
  const cudaError_t e = tf32::configure(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const void* const ptrs[] = {q, k, v, dout, dq, dk, dv};
  const int vec = tf32::stage_width(Dh, ptrs, 7);
  const philox::DropoutArg drop{{seed_base, seed_index}, threshold, drop_scale};
  kernel<<<B * H, round_up(L, 16) / 16 * 32 * kParts, smem, stream>>>(q, k, v, dout, dq, dk, dv, L, Dh,
                                                        valid_len, scale, vec, drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
