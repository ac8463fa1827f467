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
// Products: every one runs through mlp_tile.cuh's tile_product, 3xTF32
// mma.sync on 64 x 64 tiles of 4 warps over a 3-stage cp.async ring of
// 32-deep k-slices (that header describes it).  The z1 launch computes z1 as
// mlp_fwd.cu does, through the same code on the same tiles, so the two give
// the same bits.  The ones column of steps 6 and 7 is written into the
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

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

constexpr int kSmem = ring_floats(kStages) * (int)sizeof(float);  // 55,296 bytes

enum Epi { kEpiZ1 = 0, kEpiZ2 = 1, kEpiDz1 = 2, kEpiDx = 3, kEpiGrad = 4 };

struct EpiArgs {
  const float* bias;  // z1: b1; z2: b2
  const float* aux;   // z2: dout; dx: x
  float* out0;        // z1: a1; z2: g; dz1: d1 -> dz1 in place; dx: dx; grad: dW
  float* out1;        // z1: d1; grad: db
  int a_cols;         // grad: the real columns of A (the ones column is index a_cols)
};

// What the epilogue reads at outputs (r, c .. c + 3) besides the product: z2
// dout, dx x (with pre), dz1 d1.
template <int kEpi>
__device__ __forceinline__ void epi_in(int r, int c, int kM, int kN, bool vec4, const Chain& chain,
                                       const EpiArgs& e, float (&in)[4]) {
  const bool reads = kEpi == kEpiZ2 || kEpi == kEpiDz1 || (kEpi == kEpiDx && chain.pre != kNone);
  if (!reads || r >= kM || c >= kN) return;
  load4(kEpi == kEpiDz1 ? e.out0 : e.aux, (size_t)r * kN + c, min(4, kN - c), vec4, in);
}

// The epilogue of outputs (r, c .. c + 3) of a kM x kN output (c a multiple
// of 4), where they exist: products v, the bias of those columns (z1, z2)
// and `in` from epi_in; vec4: 16-byte accesses (kN % 4 == 0, pointers
// aligned), and then one Philox call draws the four mask values from `seed`.
template <int kEpi>
__device__ __forceinline__ void epilogue4(int r, int c, const float (&v)[4], const float (&bias)[4],
                                          const float (&in)[4], int kM, int kN, bool vec4,
                                          const Chain& chain, unsigned long long seed,
                                          const EpiArgs& e) {
  if (r >= kM || c >= kN) return;
  const size_t o = (size_t)r * kN + c;
  const int n = min(4, kN - c);
  float ks[4] = {1.f, 1.f, 1.f, 1.f}, out0[4], out1[4];
  if (kEpi == kEpiZ1 && chain.on[1]) philox::keep_scale4(site(chain, 1, seed), philox::kMid, o, ks);
  if (kEpi == kEpiZ2 && chain.on[2]) philox::keep_scale4(site(chain, 2, seed), philox::kPost, o, ks);
  if (kEpi == kEpiDx && chain.on[0]) philox::keep_scale4(site(chain, 0, seed), philox::kPre, o, ks);
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
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * chunk, kend = min(kbeg + chunk, kK);
  if constexpr (kEpi == kEpiGrad) {  // the ones column, never copied over
    static_assert(kTA, "the ones column lives in a [k][m] tile");
    if (e.a_cols >= m0 && e.a_cols < m0 + kBM) {
      for (int i = threadIdx.x; i < kStages * kBK; i += kThreads)
        smem[(i / kBK) * kTile + (i % kBK) * kLdMN + e.a_cols - m0] = 1.f;
    }
  }
  float acc[2][4][4] = {};
  const int a_lim = kEpi == kEpiGrad ? e.a_cols : kM;  // rows of A in memory
  tile_product<kTA, kTB, false>(acc, smem, Operand{A, lda, vec_a, a_lim},
                                Operand{B, ldb, vec_b, kN}, m0, n0, kbeg, kend);

  stage_acc(smem, acc);
  const int cc = staged_col(), c = n0 + cc, n = min(4, kN - c);
  const int rt = staged_row0();  // the thread's first row of the tile
  const auto staged = [&](int i, float (&v)[4]) { staged_row(smem, i, v); };
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
  // the masks' seed, read after the product: it holds no register in the main loop
  const unsigned long long seed =
      kEpi == kEpiZ1 || kEpi == kEpiZ2 || kEpi == kEpiDx ? call_seed(chain) : 0ull;
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
      epilogue4<kEpi>(m0 + rt + kRowsPer * i, c, v[i], bias, in[i], kM, kN, vec4, chain, seed,
                      e);
  } else {  // Philox and the activations make a long body: one copy of it
#pragma unroll 1
    for (int i = 0; i < kGroups; ++i) {
      float v[4], in[4] = {};
      staged(i, v);
      epi_in<kEpi>(m0 + rt + kRowsPer * i, c, kM, kN, vec4, chain, e, in);
      epilogue4<kEpi>(m0 + rt + kRowsPer * i, c, v, bias, in, kM, kN, vec4, chain, seed, e);
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
  epilogue4<kEpi>(r, c, v, bias, in, kM, kN, vec4, chain, call_seed(chain), e);
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
// (pre, mid, post) from the seed (seed_base, seed_index) refers to, as
// gan_mlp_fwd took them.  Launches on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess, else cudaSuccess.
int gan_mlp_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* dout, float* dx, float* dw1, float* db1,
                float* dw2, float* db2, float* t1, float* a1, float* d1, float* g, float* ws,
                int M, int K, int H, int N, int pre, int mid, int post, int mid_act_first,
                const unsigned long long* seed_base, int seed_index,
                const unsigned int* thresholds, const float* scales, const int* drop_on,
                cudaStream_t stream) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  // int flat indices, and the grid's y extent (row tiles of M, K + 1, H + 1)
  if ((long long)M * (K > H ? (K > N ? K : N) : (H > N ? H : N)) >= (1ll << 31) ||
      (long long)(K + 1) * H >= (1ll << 31) || (long long)(H + 1) * N >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)(M > H ? (M > K ? M : K) : (H > K ? H : K)) + 1 > 65535ll * kBM)
    return (int)cudaErrorInvalidValue;
  if ((drop_on[0] || drop_on[1] || drop_on[2]) && seed_base == nullptr)
    return (int)cudaErrorInvalidValue;
  const Chain chain = make_chain(pre, mid, post, mid_act_first, seed_base, seed_index,
                                 thresholds, scales, drop_on);
  cudaError_t err;
#define GAN_MLP_BWD_STEP(call)           \
  err = (call);                          \
  if (err != cudaSuccess) return (int)err;

  const float* t1_in = x;
  if (pre != kNone) {
    GAN_MLP_BWD_STEP(launch_pre(x, t1, (long long)M * K, chain, stream));
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
