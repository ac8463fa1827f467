// Fused two-layer MLP forward for Hopper (sm_90a), f32:
//   out = post(mid(pre(x) W1 + b1) W2 + b2)
// with each of pre / mid / post one of none, relu or exact-erf gelu.
//
// Replaces: gan_ffn_tpu/ops/mlp.py::_fwd_kernel (pallas_call at :259),
// reached through fused_mlp -> _fused_mlp_padded -> _mlp_fwd.  The TPU
// kernel approximates erf (A&S 7.1.26); this one calls erff.
//
// Dropout, in the JAX chain's order (gan_ffn_tpu/ops/mlp.py::_forward_chain):
//   pre:  t1 = act(x) * M_pre                          (M, K) mask
//   mid:  drop_first a1 = act(z1 * M_mid), act_first a1 = act(z1) * M_mid
//   post: out = act(z2 * M_post)                       (M, N) mask
// Each mask is drawn from its philox.cuh stream (kPre, kMid, kPost) at the
// flat (row, column) index of its (M, K), (M, H) or (M, N) tensor, so
// mlp_bwd.cu and the plain version (ops/mlp.py) draw the same masks.
//
// What bounds it on the H100: operations.  At the path's shapes (M = 3584
// rows; K->H->N in {100->2048->100, 512->2048->512, 100->512->100,
// 512->1024->100}) the work is 2 M (K H + H N) flops, e.g. 15.0 GFLOP for
// the visual FFN: 0.091 ms at 165 TFLOP/s (495 TFLOP/s TF32 over the three
// products of the 3xTF32 split), against ~11 MB of unavoidable traffic.  As
// in the TPU kernel, the (M, H) intermediate never reaches device memory.
//
// Design: both products run through mlp_tile.cuh's tile_product (3xTF32
// mma.sync, 64 x 64 tiles of 4 warps, a 2-stage cp.async ring).  With pre,
// pre_kernel first writes t1 = pre(x) (M, K), as mlp_bwd.cu does, so both
// multiply the same t1.  A block owns one tile of 64 rows and one chunk of
// d_ff (at most kMaxChunkTiles x 64 columns):
//   1. for each 64 columns of its chunk, z1 = t1 W1 through the same tile
//      code as mlp_bwd.cu's z1 launch, so that both give the same bits
//      (relu' then takes the branch relu took); b1, mid's activation and its
//      mask go into an a1 tile that stays in shared memory;
//   2. for each 64 columns of the output, a1 W2[chunk rows] with a1 as a
//      resident A operand: only W2's slices are staged.
// So no block holds an accumulator across d_ff, and N takes any width.
// pre(x) computed in the block, on each staged slice of x, was redone for
// every 64 columns of d_ff (16 times per element at 512->1024->100), which
// cost more than the pass's one read and write of (M, K).
//
// Filling the card: 64-row tiles alone make only 56 blocks at M = 3584 on
// 132 SMs.  d_ff is split into S chunks (fwd_split; ops/mlp.py mirrors it),
// at least as many as the a1 tile needs and about as many as fill one wave
// of kWaveBlocks: 448 blocks at each of the path's geometries, two an SM
// (shared memory).  Each (row tile, chunk) block writes its partial (64, N)
// tile to the workspace, and a second kernel sums the S partials in
// ascending chunk order, then adds b2 and applies post with its mask.  Where
// the rows alone make over half a wave and one chunk holds d_ff, the block
// applies that epilogue itself.  No float atomics: two calls give the same
// bits.  The long epilogues (Philox, activations) run as one rolled loop
// (PERF.md, "Code size in the epilogue").  Weights and x stay in the 50 MB
// L2; the workspace, S M N floats written and read once (59 MB at
// 512->2048->512), is the traffic that grows with S.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

constexpr int kMaxChunkTiles = 4;  // d_ff columns a block holds: 4 x 64
constexpr int kFwdStages = 2;      // the ring's stages

// Bytes of one block's shared memory: the ring and the a1 tile of a chunk of
// `chunk` columns (row stride chunk + 4, 4 mod 32); 103,424 at 256 columns,
// so two blocks share an SM.
constexpr int smem_bytes(int chunk) {
  return (ring_floats(kFwdStages) + kBM * (chunk + 4)) * (int)sizeof(float);
}

// out[r, c .. c + 3] = post(z2) where they exist: z2 = v + b2, post's mask at
// the flat index (r, c), drawn from `seed`.  bias: b2[c .. c + 3].
__device__ __forceinline__ void out_epilogue4(int r, int c, const float (&v)[4],
                                              const float (&bias)[4], int M, int N, bool vec4,
                                              const Chain& chain, unsigned long long seed,
                                              float* out) {
  if (r >= M || c >= N) return;
  const size_t o = (size_t)r * N + c;
  float ks[4] = {1.f, 1.f, 1.f, 1.f}, y[4];
  if (chain.on[2]) philox::keep_scale4(site(chain, 2, seed), philox::kPost, o, ks);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float z = v[j] + bias[j];
    y[j] = act(chain.post, chain.on[2] ? z * ks[j] : z);
  }
  store4(out, o, min(4, N - c), vec4, y);
}

// One block: row tile blockIdx.y, d_ff chunk blockIdx.x (columns h0 ..
// h0 + chunk - 1).  t: pre(x) (or x without pre).  part == nullptr: the
// block writes out, else its partial sums to part[blockIdx.x][r][c] for
// mlp_fwd_reduce_kernel.  vec_*: copy widths of t, W1 and W2; vec4: 16-byte
// accesses of out and part.  Two blocks share an SM (shared memory), so a thread may
// take every register: capped at 168, it spilled and ran slower.
__global__ void __launch_bounds__(kThreads, 2)
mlp_fwd_kernel(const float* __restrict__ t, int vec_t, const float* __restrict__ w1, int vec_w1,
           const float* __restrict__ b1, const float* __restrict__ w2, int vec_w2,
           const float* __restrict__ b2, float* __restrict__ out, float* __restrict__ part,
           int vec4, int M, int K, int H, int N, int chunk, Chain chain) {
  const unsigned long long seed = call_seed(chain);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* a1 = smem + ring_floats(kFwdStages);  // 64 x chunk, row stride lda1
  const int lda1 = chunk + 4;
  const int m0 = blockIdx.y * kBM, h0 = blockIdx.x * chunk, hn = min(chunk, H - h0);
  const int cc = staged_col(), rt = staged_row0();

  // 1. a1 = mid(t W1[:, chunk] + b1), 64 columns at a time
  const Operand ta{t, K, vec_t, M}, wb{w1, H, vec_w1, H};
  for (int j0 = 0; j0 < hn; j0 += kBN) {
    float acc[2][4][4] = {};
    tile_product<false, false, false, kFwdStages>(acc, ring, ta, wb, m0, h0 + j0, 0, K);
    stage_acc(ring, acc);
    const int c = h0 + j0 + cc, n = min(4, H - c);
    float bias[4] = {};
    if (c < H) load4(b1, c, n, false, bias);
#pragma unroll 1
    for (int i = 0; i < kGroups; ++i) {  // Philox and activations: one copy
      const int rl = rt + kRowsPer * i, r = m0 + rl;
      float v[4], ks[4] = {1.f, 1.f, 1.f, 1.f}, a[4], d;
      staged_row(ring, i, v);
      if (chain.on[1] && r < M && c < H)
        philox::keep_scale4(site(chain, 1, seed), philox::kMid, (size_t)r * H + c, ks);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mid_act(chain, v[e] + bias[e], ks[e], a[e], d);
        if (e >= n) a[e] = 0.f;  // past H: W2's rows there are zero-filled
      }
      *reinterpret_cast<float4*>(a1 + rl * lda1 + j0 + cc) = make_float4(a[0], a[1], a[2], a[3]);
    }
    __syncthreads();  // the ring is free again
  }

  // 2. a1 W2[chunk, :], 64 output columns at a time
  const Operand aa{a1, lda1, 0, 0}, wc{w2, N, vec_w2, N};
  for (int n0 = 0; n0 < N; n0 += kBN) {
    float acc[2][4][4] = {};
    tile_product<false, false, true, kFwdStages>(acc, ring, aa, wc, m0, n0, h0, h0 + hn);
    stage_acc(ring, acc);
    const int c = n0 + cc, n = min(4, N - c);
    if (part != nullptr) {
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int r = m0 + rt + kRowsPer * i;
        float v[4];
        staged_row(ring, i, v);
        if (r < M && c < N) store4(part, ((size_t)blockIdx.x * M + r) * N + c, n, vec4, v);
      }
    } else {
      float bias[4] = {};
      if (c < N) load4(b2, c, n, false, bias);
#pragma unroll 1
      for (int i = 0; i < kGroups; ++i) {
        float v[4];
        staged_row(ring, i, v);
        out_epilogue4(m0 + rt + kRowsPer * i, c, v, bias, M, N, vec4, chain, seed, out);
      }
    }
    __syncthreads();  // the ring is free again
  }
}

// The second pass of a split launch: out (r, c) = post(part[0][r][c] + ...
// + part[S - 1][r][c] + b2[c]), summed in that order.  One thread per 4
// consecutive columns.
__global__ void __launch_bounds__(256)
mlp_fwd_reduce_kernel(const float* __restrict__ part, int S, const float* __restrict__ b2,
                      float* __restrict__ out, int M, int N, int vec4, Chain chain) {
  const int quads = (N + 3) / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * quads) return;
  const int r = (int)(i / quads), c = 4 * (int)(i % quads), n = min(4, N - c);
  const size_t o = (size_t)r * N + c, stride = (size_t)M * N;
  float v[4] = {}, p[4], bias[4];
  for (int s = 0; s < S; ++s) {
    load4(part, s * stride + o, n, vec4, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += p[j];
  }
  load4(b2, c, n, false, bias);
  out_epilogue4(r, c, v, bias, M, N, vec4, chain, call_seed(chain), out);
}

struct Split {
  int chunk, S;  // d_ff columns of a chunk, and chunks
};

// How d_ff splits over blocks at M rows: into at least the chunks the a1
// tile allows (kMaxChunkTiles 64-column tiles each); where that leaves at
// most half a wave (kWaveBlocks / 2) of blocks, into s = min(kWaveBlocks /
// row tiles, tiles of d_ff) chunks instead.  A chunk takes ceil(tiles / s)
// 64-column tiles (the last may be shorter; rounding may leave fewer than s).
Split fwd_split(int M, int H) {
  const long long rows = (M + kBM - 1) / kBM;
  const int tiles = (H + kBN - 1) / kBN;
  long long s = (tiles + kMaxChunkTiles - 1) / kMaxChunkTiles;
  if (2 * rows * s <= kWaveBlocks) {
    const long long fill = kWaveBlocks / rows < tiles ? kWaveBlocks / rows : tiles;
    if (fill > s) s = fill;
  }
  const int per = (int)((tiles + s - 1) / s);
  return {per * kBN, (tiles + per - 1) / per};
}

}  // namespace

extern "C" {

// Floats of workspace gan_mlp_fwd needs for M rows of K -> H -> N: S x M x N
// where d_ff splits into S > 1 chunks, else 0.
long long gan_mlp_fwd_workspace_floats(int M, int K, int H, int N) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return 0;
  const Split sp = fwd_split(M, H);
  return sp.S > 1 ? (long long)sp.S * M * N : 0;
}

// x (M, K), w1 (K, H), b1 (H), w2 (H, N), b2 (N) in; out (M, N); scratch:
// t1 (M, K) (used only with pre), ws (gan_mlp_fwd_workspace_floats): f32,
// contiguous, on the current device.  pre / mid / post: 0 none, 1 relu, 2
// gelu; mid_act_first: the mid order (0 drop_first, 1 act_first).
// thresholds[s] and scales[s] (host arrays) describe the dropout of site
// s (pre, mid, post), drawn from the seed that (seed_base, seed_index)
// refers to in device memory (philox.cuh SeedRef); drop_on[s] != 0 where its
// rate is > 0.  Launches on `stream`; returns the first cudaGetLastError()
// that is not cudaSuccess, else cudaSuccess.
int gan_mlp_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, float* out, float* t1, float* ws, int M, int K, int H, int N,
                int pre, int mid, int post, int mid_act_first,
                const unsigned long long* seed_base, int seed_index,
                const unsigned int* thresholds, const float* scales, const int* drop_on,
                cudaStream_t stream) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  // int flat indices, and the grid's y extent (row tiles)
  if ((long long)M * (K > H ? (K > N ? K : N) : (H > N ? H : N)) >= (1ll << 31) ||
      (long long)M > 65535ll * kBM)
    return (int)cudaErrorInvalidValue;
  if ((drop_on[0] || drop_on[1] || drop_on[2]) && seed_base == nullptr)
    return (int)cudaErrorInvalidValue;
  const Chain chain = make_chain(pre, mid, post, mid_act_first, seed_base, seed_index,
                                 thresholds, scales, drop_on);
  cudaError_t err;
  const float* t = x;
  if (pre != kNone) {
    err = launch_pre(x, t1, (long long)M * K, chain, stream);
    if (err != cudaSuccess) return (int)err;
    t = t1;
  }
  const Split sp = fwd_split(M, H);
  const int smem = smem_bytes(sp.chunk);
  err = tf32::configure(mlp_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const void* const pt[] = {t};
  const void* const pw1[] = {w1};
  const void* const pw2[] = {w2};
  const void* const pout[] = {out, ws};
  const int vec4 = tf32::stage_width(N, pout, 2) == 4;
  float* part = sp.S > 1 ? ws : nullptr;
  const dim3 grid(sp.S, (M + kBM - 1) / kBM);
  mlp_fwd_kernel<<<grid, kThreads, smem, stream>>>(t, tf32::stage_width(K, pt, 1), w1,
                                                   tf32::stage_width(H, pw1, 1), b1, w2,
                                                   tf32::stage_width(N, pw2, 1), b2, out, part,
                                                   vec4, M, K, H, N, sp.chunk, chain);
  err = cudaGetLastError();
  if (err == cudaSuccess && part != nullptr) {
    const long long n = (long long)M * ((N + 3) / 4);
    mlp_fwd_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, sp.S, b2, out,
                                                                          M, N, vec4, chain);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* gan_mlp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
