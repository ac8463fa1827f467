// Fused two-layer MLP forward for Hopper (sm_90a), bf16:
//   out = post(mid(pre(x) W1 + b1) W2 + b2)
// with each of pre / mid / post one of none, relu or exact-erf gelu.
//
// Replaces: gan_ffn_tpu/ops/mlp.py::_fwd_kernel (pallas_call at :259) at
// bfloat16 operands, as the JAX package runs it with dtype=bfloat16 (the
// serving variant serving.bf16_variant, cli/predict.py --bf16).  The rounding
// points are the JAX kernel's (_forward_chain): x, b1 and b2 are read as f32
// (:142-144); the pre chain runs in f32 and t1 is rounded to bf16 for the
// first product (:107); z1 = t1 W1 with f32 sums, + b1, and the mid chain
// in f32, a1 rounded to bf16 (:122); z2 = a1 W2 with f32 sums, + b2, the
// post chain in f32, and the output rounded to bf16 (:146).  The plain twin
// is ops/mlp.py::mlp_plain at bf16, which rounds at the same points.
//
// Dropout, as in mlp_fwd.cu: each mask drawn from its philox.cuh stream
// (kPre, kMid, kPost) at the flat (row, column) index of its (M, K), (M, H)
// or (M, N) tensor, from one seed in device memory.
//
// What bounds it on the H100: operations.  At the path's shapes (M = 3584
// rows; K->H->N in {100->2048->100, 512->2048->512, 100->512->100,
// 512->1024->100}) the work is 2 M (K H + H N) flops, e.g. 15.0 GFLOP for
// the visual FFN: 0.015 ms at 989 TFLOP/s (bf16 tensor cores, dense), 0.22
// ms at the 67 TFLOP/s of the f64 tensor cores this kernel runs them on
// (below), against ~6 MB of unavoidable traffic (0.002 ms).  As in the TPU
// kernel, the (M, H) intermediate never reaches device memory.
//
// Why the f64 tensor cores.  The bf16 tensor cores do not round a k-step's
// sum to nearest: on the H100 a 16-product bf16 sum matched the
// round-to-nearest f32 of the exact sum in 92% of cases, and truncation in
// 99.4% (55% and 77% with operands spread over 2^16).  So no plain version
// reproduces their z1, and z1 feeds a1 = bf16(mid(z1 + b1)): a one-ulp
// difference in z1 at a bf16 rounding boundary changes a1, and that a1
// moves every output of its row (up to 20% of a head's 100 outputs by one
// bf16 ulp, measured at M = 1; with f64 sums over bf16 k-steps, 0.03% of
// the visual FFN's outputs and one at its largest, past the 2^-8 limit).
// mma.m8n8k4.f64 on operands converted from bf16 multiplies them exactly
// (16 significant bits) and sums in f64, so z1 and z2 are the exact sums
// rounded to f32 once, as the plain version takes them (f64 products): the
// two agree bit for bit but where the chunks' f32 partials of z2 round.
//
// Design: mlp_fwd.cu's split of the work (a block owns 64 rows and a chunk
// of at most 256 d_ff columns, fwd_split; a second kernel sums the chunks'
// f32 partial z2 in ascending chunk order, in f64, then adds b2 and applies
// post: no atomics, so two calls give the same bits).  A block of 4 warps
// computes 64 x 64 output tiles, each warp 32 x 32 as 4 x 4 mma tiles of 8 x
// 8.  Both A operands stay in shared memory for the block's life: the block
// first writes its t1 = bf16(pre(x)) tile (64 x K, K padded to 32 with
// zeros; computed there, so no t1 reaches device memory), and the first
// product's epilogue writes its bf16 a1 tile (64 x chunk).  Only the weights
// stream through a 2-stage cp.async ring of 32-deep slices, read as they lie
// in device memory (W1 (K, H), W2 (H, N)).  The epilogues work on the
// accumulators in place, one Philox call per pair of mask values.  The t1
// staging, the products and z1 live in mlp_bf16_tile.cuh, which
// mlp_bwd_bf16.cu calls for its recompute, so the two give z1 the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp_bf16_tile.cuh"
#include "mlp_tile.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16::bf16_t;
using mlp::Chain;
using namespace mlp_bf16;

// Row stride of the resident a1 tile (a chunk of d_ff), 8 mod 64 bf16.
__host__ __device__ constexpr int ld_a1(int chunk) { return chunk + 8; }

// Bytes of one block's shared memory: the t1 and a1 tiles and the ring;
// 109,568 at K = 512 and 256 columns, so two blocks share an SM.
constexpr int smem_bytes(int K, int chunk) {
  return (kBM * ld_t1(K) + kBM * ld_a1(chunk) + kStages * kSliceElems) * (int)sizeof(bf16_t);
}

// post(z2) of output (r, c): z2 = v + b2[c], post's mask value ks.
__device__ __forceinline__ float post_value(const Chain& chain, float z, float ks) {
  return mlp::act(chain.post, chain.on[2] ? z * ks : z);
}

// One block: row tile blockIdx.y, d_ff chunk blockIdx.x (columns h0 ..
// h0 + chunk - 1).  part == nullptr: the block writes out, else its partial
// sums to part[blockIdx.x][r][c] for mlp_fwd_bf16_reduce_kernel.  vec_*:
// copy widths of x, W1 and W2; pairs: 4-byte bf16 pairs of out and 8-byte
// float pairs of part.
__global__ void __launch_bounds__(kThreads, 2)
mlp_fwd_bf16_kernel(const bf16_t* __restrict__ x, int vec_x, const bf16_t* __restrict__ w1,
                    int vec_w1, const bf16_t* __restrict__ b1, const bf16_t* __restrict__ w2,
                    int vec_w2, const bf16_t* __restrict__ b2, bf16_t* __restrict__ out,
                    float* __restrict__ part, int pairs, int M, int K, int H, int N, int chunk,
                    Chain chain) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* t1 = reinterpret_cast<bf16_t*>(smem_raw);  // 64 x Kp, row stride ldt
  const int lda1 = ld_a1(chunk);
  bf16_t* a1 = t1 + kBM * ld_t1(K);  // 64 x chunk, row stride lda1
  bf16_t* ring = a1 + kBM * lda1;
  const int m0 = blockIdx.y * kBM, h0 = blockIdx.x * chunk, hn = min(chunk, H - h0);
  const unsigned long long seed = mlp::call_seed(chain);

  // 0. t1 = bf16(pre(x)) of the block's rows (zero past M and K)
  stage_t1(t1, x, vec_x, m0, M, K, chain, seed);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // 1. a1 = bf16(mid(t1 W1[:, chunk] + b1)), 64 columns at a time
  for (int j0 = 0; j0 < hn; j0 += kBN) {
    Acc acc;
    z1_product(acc, ring, t1, w1, K, H, h0 + j0, vec_w1);
#pragma unroll 1
    for (int x = 0; x < 4; ++x) {
      const int rl = wm + 8 * x + g, r = m0 + rl;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int cl = j0 + wn + 8 * y + 2 * t, c = h0 + cl;  // c even
        float a[2] = {0.f, 0.f}, d;
        if (r < M && c < H) {
          float k0, k1;
          site_pair(chain, 1, philox::kMid, seed, (size_t)r * H + c, k0, k1);
          mlp::mid_act(chain, z1_value(acc[x][y][0], b1, c), k0, a[0], d);
          if (c + 1 < H) mlp::mid_act(chain, z1_value(acc[x][y][1], b1, c + 1), k1, a[1], d);
        }
        // past H: W2's rows there are zero-filled, and a1 is zero
        *reinterpret_cast<__nv_bfloat162*>(a1 + rl * lda1 + cl) = __floats2bfloat162_rn(a[0], a[1]);
      }
    }
  }

  // 2. a1 W2[chunk, :], 64 output columns at a time
  for (int n0 = 0; n0 < N; n0 += kBN) {
    Acc acc = {};
    product(acc, ring, a1, lda1, w2, N, H, n0, N, vec_w2, h0, h0 + round_up(hn, kSlice));
#pragma unroll 1
    for (int x = 0; x < 4; ++x) {
      const int r = m0 + wm + 8 * x + g;
      if (r >= M) continue;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int c = n0 + wn + 8 * y + 2 * t;
        if (c >= N) continue;
        const size_t o = (size_t)r * N + c;
        const float v0 = (float)acc[x][y][0], v1 = (float)acc[x][y][1];
        if (part != nullptr) {
          float* p = part + (size_t)blockIdx.x * M * N + o;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (c + 1 < N) p[1] = v1;
          }
        } else {
          float k0, k1;
          site_pair(chain, 2, philox::kPost, seed, o, k0, k1);
          const float bias1 = c + 1 < N ? __bfloat162float(b2[c + 1]) : 0.f;
          bf16::store_pair(out + (size_t)r * N, c, N, pairs,
                           post_value(chain, v0 + __bfloat162float(b2[c]), k0),
                           post_value(chain, v1 + bias1, k1));
        }
      }
    }
  }
}

// The second pass of a split launch: out (r, c) = bf16(post(part[0][r][c] +
// ... + part[S - 1][r][c] + b2[c])), the partials summed in that order in
// f64 and rounded to f32 once before b2.  One thread per output.
__global__ void __launch_bounds__(256)
mlp_fwd_bf16_reduce_kernel(const float* __restrict__ part, int S, const bf16_t* __restrict__ b2,
                           bf16_t* __restrict__ out, int M, int N, Chain chain) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long long)M * N) return;
  const size_t stride = (size_t)M * N;
  double v = 0.0;
  for (int s = 0; s < S; ++s) v += (double)part[s * stride + o];
  float ks = 1.f;
  if (chain.on[2])
    ks = philox::keep_scale(mlp::site(chain, 2, mlp::call_seed(chain)), philox::kPost,
                            (unsigned long long)o);
  out[o] = __float2bfloat16_rn(post_value(chain, (float)v + __bfloat162float(b2[o % N]), ks));
}

}  // namespace

extern "C" {

// Floats of workspace gan_mlp_fwd_bf16 needs for M rows of K -> H -> N:
// S x M x N where d_ff splits into S > 1 chunks, else 0.
long long gan_mlp_fwd_bf16_workspace_floats(int M, int K, int H, int N) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return 0;
  const Split sp = fwd_split(M, H);
  return sp.S > 1 ? (long long)sp.S * M * N : 0;
}

// x (M, K), w1 (K, H), b1 (H), w2 (H, N), b2 (N) in, out (M, N): bf16; ws
// (gan_mlp_fwd_bf16_workspace_floats) f32; contiguous, on the current
// device.  pre / mid / post: 0 none, 1 relu, 2 gelu; mid_act_first: the mid
// order (0 drop_first, 1 act_first).  thresholds[s] and scales[s] (host
// arrays) describe the dropout of site s (pre, mid, post), drawn from the
// seed that (seed_base, seed_index) refers to in device memory (philox.cuh
// SeedRef); drop_on[s] != 0 where its rate is > 0.  Launches on `stream`;
// returns the first cudaGetLastError() that is not cudaSuccess, else
// cudaSuccess.
int gan_mlp_fwd_bf16(const bf16_t* x, const bf16_t* w1, const bf16_t* b1, const bf16_t* w2,
                     const bf16_t* b2, bf16_t* out, float* ws, int M, int K, int H, int N,
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
  const Chain chain = mlp::make_chain(pre, mid, post, mid_act_first, seed_base, seed_index,
                                      thresholds, scales, drop_on);
  const Split sp = fwd_split(M, H);
  const int smem = smem_bytes(K, sp.chunk);
  cudaError_t err = tf32::configure(mlp_fwd_bf16_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const void* const px[] = {x};
  const void* const pw1[] = {w1};
  const void* const pw2[] = {w2};
  const int pairs = N % 2 == 0 && ((unsigned long long)out & 3) == 0 &&
                    ((unsigned long long)ws & 7) == 0;
  float* part = sp.S > 1 ? ws : nullptr;
  const dim3 grid(sp.S, (M + kBM - 1) / kBM);
  mlp_fwd_bf16_kernel<<<grid, kThreads, smem, stream>>>(
      x, bf16::copy_width(K, px, 1), w1, bf16::copy_width(H, pw1, 1), b1, w2,
      bf16::copy_width(N, pw2, 1), b2, out, part, pairs, M, K, H, N, sp.chunk, chain);
  err = cudaGetLastError();
  if (err == cudaSuccess && part != nullptr) {
    const long long n = (long long)M * N;
    mlp_fwd_bf16_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, sp.S, b2,
                                                                               out, M, N, chain);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* gan_mlp_fwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
