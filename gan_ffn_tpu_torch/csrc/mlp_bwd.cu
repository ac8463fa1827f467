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
// outputs, and every sum runs in a fixed ascending order: no float atomics,
// and two calls give the same bits.  One generic tiled product C = A B (A
// and B each read plain or transposed) with a per-launch epilogue does it:
//   1. t1 (only with pre): elementwise, to a scratch (M, K);
//   2. z1 = t1 W1 + b1 -> a1 and d1, to scratch (M, H) each;
//   3. z2 = a1 W2 + b2 -> g, to a scratch (M, N)   (only with post);
//   4. g W2^T -> dz1 = (g W2^T) * d1, over d1 in place;
//   5. dz1 W1^T -> dx;
//   6. [t1 | 1]^T dz1 -> dW1 and, from the ones column, db1;
//   7. [a1 | 1]^T g   -> dW2 and db2.
// Launches 6 and 7 sum over all M rows inside one block per output tile.
// The wrapper (ops/mlp.py) allocates the scratch.  Nothing is stored
// between the forward and the backward: the backward recomputes z1, z2 and
// the masks.
//
// What bounds it on the H100: f32 FMAs.  At M = 3584 the products are
// 2 M (K H + H N) flops each for the recompute (z2 only with post) and for
// the four gradient products, e.g. ~45 GFLOP for the visual FFN
// 512->2048->512 (~0.67 ms at 67 TFLOP/s f32), against ~100 MB of scratch
// traffic (~30 us at 3.35 TB/s).  Tiles of 64 x 64 outputs, 16-deep
// slices, 4 x 4 outputs a thread; CUDA cores only (no cuBLAS, no wgmma).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;  // output tile and reduction slice
constexpr int kThreads = 256;                // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;                      // shared row padding, floats

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

// C[r, c] = sum_k A(r, k) B(k, c) over a kM x kN output, then the epilogue.
// A(r, k) = kTA ? A[k * lda + r] : A[r * lda + k]; B likewise with kTB.
// For kEpiGrad, A(a_cols, k) = 1 (the ones column that gives the bias).
template <bool kTA, bool kTB, int kEpi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
            int kM, int kN, int kK, Chain chain, EpiArgs e) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < kK; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < kBM * kBK / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      int r, k;
      if (kTA) { k = idx / kBM; r = idx % kBM; } else { r = idx / kBK; k = idx % kBK; }
      const int gr = m0 + r, gk = k0 + k;
      float val = 0.f;
      if (gr < kM && gk < kK) {
        if (kEpi == kEpiGrad && gr == e.a_cols) val = 1.f;
        else val = kTA ? A[(size_t)gk * lda + gr] : A[(size_t)gr * lda + gk];
      }
      As[k][r] = val;
    }
#pragma unroll
    for (int u = 0; u < kBN * kBK / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      int c, k;
      if (kTB) { c = idx / kBK; k = idx % kBK; } else { k = idx / kBN; c = idx % kBN; }
      const int gc = n0 + c, gk = k0 + k;
      float val = 0.f;
      if (gc < kN && gk < kK) val = kTB ? B[(size_t)gc * ldb + gk] : B[(size_t)gk * ldb + gc];
      Bs[k][c] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= kM) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= kN) continue;
      const size_t o = (size_t)r * kN + c;
      const float v = acc[i][j];
      if (kEpi == kEpiZ1) {  // kM = M rows, kN = H
        const float z = v + e.bias[c];
        float a, d;
        if (chain.on[1]) {
          const float ks = philox::keep_scale(chain.site[1], philox::kMid, o);
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
        e.out0[o] = a;
        e.out1[o] = d;
      } else if (kEpi == kEpiZ2) {  // kN = N
        const float z = v + e.bias[c];
        const float ks =
            chain.on[2] ? philox::keep_scale(chain.site[2], philox::kPost, o) : 1.f;
        e.out0[o] = e.aux[o] * act_grad(chain.post, chain.on[2] ? z * ks : z) * ks;
      } else if (kEpi == kEpiDz1) {  // kN = H
        e.out0[o] = v * e.out0[o];
      } else if (kEpi == kEpiDx) {  // kN = K
        float dx = v;
        if (chain.pre != kNone) {
          if (chain.on[0]) dx *= philox::keep_scale(chain.site[0], philox::kPre, o);
          dx *= act_grad(chain.pre, e.aux[o]);
        }
        e.out0[o] = dx;
      } else {  // kEpiGrad: kM = a_cols + 1
        if (r < e.a_cols) e.out0[o] = v;
        else e.out1[c] = v;
      }
    }
  }
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

template <bool kTA, bool kTB, int kEpi>
cudaError_t gemm(const float* A, int lda, const float* B, int ldb, int kM, int kN, int kK,
                 const Chain& chain, const EpiArgs& e, cudaStream_t stream) {
  const dim3 grid((kN + kBN - 1) / kBN, (kM + kBM - 1) / kBM);
  gemm_kernel<kTA, kTB, kEpi><<<grid, kThreads, 0, stream>>>(A, lda, B, ldb, kM, kN, kK,
                                                              chain, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K), w1 (K, H), b1 (H), w2 (H, N), b2 (N), dout (M, N) in;
// dx (M, K), dw1 (K, H), db1 (H), dw2 (H, N), db2 (N) out; scratch: t1 (M, K)
// (used only with pre), a1 (M, H), d1 (M, H), g (M, N) (used only with
// post).  All f32, contiguous, on the current device.  pre / mid / post:
// 0 none, 1 relu, 2 gelu; mid_act_first: the mid order; thresholds[s],
// scales[s], drop_on[s]: the dropout of site s (pre, mid, post) from `seed`,
// as gan_mlp_fwd took them.  Launches on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess, else cudaSuccess.
int gan_mlp_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* dout, float* dx, float* dw1, float* db1,
                float* dw2, float* db2, float* t1, float* a1, float* d1, float* g,
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
  GAN_MLP_BWD_STEP((gemm<false, false, kEpiZ1>(t1_in, K, w1, H, M, H, K, chain, e, stream)));
  const float* g_in = dout;
  if (post != kNone) {
    e = EpiArgs{};
    e.bias = b2;
    e.aux = dout;
    e.out0 = g;
    GAN_MLP_BWD_STEP((gemm<false, false, kEpiZ2>(a1, H, w2, N, M, N, H, chain, e, stream)));
    g_in = g;
  }
  e = EpiArgs{};
  e.out0 = d1;  // d1 -> dz1 in place
  GAN_MLP_BWD_STEP((gemm<false, true, kEpiDz1>(g_in, N, w2, N, M, H, N, chain, e, stream)));
  e = EpiArgs{};
  e.aux = x;
  e.out0 = dx;
  GAN_MLP_BWD_STEP((gemm<false, true, kEpiDx>(d1, H, w1, H, M, K, H, chain, e, stream)));
  e = EpiArgs{};
  e.out0 = dw1;
  e.out1 = db1;
  e.a_cols = K;
  GAN_MLP_BWD_STEP((gemm<true, false, kEpiGrad>(t1_in, K, d1, H, K + 1, H, M, chain, e, stream)));
  e.out0 = dw2;
  e.out1 = db2;
  e.a_cols = H;
  GAN_MLP_BWD_STEP((gemm<true, false, kEpiGrad>(a1, H, g_in, N, H + 1, N, M, chain, e, stream)));
#undef GAN_MLP_BWD_STEP
  return (int)cudaSuccess;
}

const char* gan_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
