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
// mlp_bwd.cu and the plain version (ops/mlp.py) draw the same masks.  A
// rate of 0 draws nothing: dropout is a template flag of the kernel.
//
// What bounds it on the H100: f32 FMAs.  At the serving shapes (M = L*B up to
// 3584 rows; K->H->N in {100->2048->100, 512->2048->512, 100->512->100,
// 512->1024->100}) the work is 2*M*(K*H + H*N) flops, e.g. 15.0 GFLOP for the
// visual FFN, ~224 us at 67 TFLOP/s f32 outside the tensor cores, against
// ~11 MB of unavoidable traffic (~3 us at 3.35 TB/s).  The TPU kernel's
// point -- the (M, H) intermediate never reaches device memory -- is kept.
//
// Design: one block of 8 warps per tile of 32 rows.  The block stages pre(x)
// for its rows whole in shared memory, then streams d_ff in chunks of 128
// columns: z = pre(x) W1[:, chunk] + b1, a = mid(z) into shared memory,
// acc += a W2[chunk, :].  The (32, N) f32 accumulator lives in registers.
// Both products use 2-D thread tiles so that shared-memory loads stay far
// below the FMAs: the warps form a 2 (rows) x 4 (columns) grid, lane l takes
// rows r + 4i (r = 16 * warp_row + l / 8) and the 4 adjacent columns at
// 4 * (8 * warp_col + l % 8) of every 128-column group.  A thread reads its 4
// rows as 16-byte loads along k (row strides are 4 mod 32 floats, so the 4
// rows a warp reads sit in 4 different bank groups) and its 4 columns as one
// 16-byte load (a warp reads 128 contiguous bytes, broadcast over rows).
// Weight slices (32 rows of W1's chunk, 16 rows of W2's chunk) are double
// buffered with cp.async: the next one is in flight while the block computes
// on the current one.  Each output is a sum over k, then over d_ff, in
// ascending order.  Weights are re-read by every block from L2 (50 MB holds
// them all).  CUDA cores only: wgmma / TMA / bf16 are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int kRows = 32;           // rows per block
constexpr int kChunk = 128;         // d_ff columns per step
constexpr int kSliceK = 32;         // W1 rows staged at once
constexpr int kSliceH = 16;         // W2 rows staged at once
constexpr int kColGroup = 128;      // output columns the block's threads cover at once
constexpr int kMaxColGroups = 4;    // N <= 512
constexpr int kPad = 4;             // row padding of the x and mid tiles, floats
constexpr int kAs = kChunk + kPad;  // row stride of the mid tile

enum Act { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float act(int a, float x) {
  if (a == kRelu) return fmaxf(x, 0.f);
  if (a == kGelu) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  return x;
}

__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Asynchronous global -> shared copy of kBytes (4 or 16); only the first
// src_bytes are read, the rest of the destination is zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of the kR x kC tile at (r0, c0) of a row-major matrix with
// leading dimension ld into dst (row stride kC); entries at rows >= row_lim or
// columns >= col_lim are zero-filled.  kVec copies 16 bytes at a time, which
// needs ld % 4 == 0 and a 16-byte aligned src.
template <int kR, int kC, bool kVec>
__device__ __forceinline__ void stage(float* dst, const float* src, int ld, int r0, int c0,
                                      int row_lim, int col_lim) {
  constexpr int kWidth = kVec ? 4 : 1;
  constexpr int kGroups = kC / kWidth;
  static_assert(kR * kGroups % kThreads == 0, "tile must split evenly over the block");
#pragma unroll
  for (int u = 0; u < kR * kGroups / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / kGroups, c = (i % kGroups) * kWidth;
    const int gr = r0 + r, gc = c0 + c;
    const int n = gr < row_lim ? min(max(col_lim - gc, 0), kWidth) : 0;
    cp_async<4 * kWidth>(dst + r * kC + c, n ? src + (size_t)gr * ld + gc : src, 4 * n);
  }
}

// The three dropout sites of one call; `on` says which rates are > 0.
struct Drops {
  philox::Dropout site[3];  // pre, mid, post
  int on[3];
  int mid_act_first;        // mid order: 0 drop_first, 1 act_first
};

// NJ = ceil(N / 128): 128-column groups of the accumulator.  kDrop: some
// rate is > 0.
template <int NJ, bool kVec, bool kDrop>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out,
               int M, int K, int H, int N, int pre, int mid, int post, Drops drops) {
  constexpr int Np = NJ * kColGroup;
  constexpr int nH = kChunk / kSliceH;
  extern __shared__ __align__(16) float smem[];
  const int Kp = round_up(K, kSliceK) + kPad;
  float* xs = smem;                          // kRows x Kp          pre(x) tile
  float* w1s = xs + kRows * Kp;              // 2 x kSliceK x kChunk
  float* as = w1s + 2 * kSliceK * kChunk;    // kRows x kAs         mid(z) chunk
  float* w2s = as + kRows * kAs;             // 2 x kSliceH x Np

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rb = (warp >> 2) * 16 + (lane >> 3);    // this thread's rows: rb + 4i
  const int c0 = ((warp & 3) * 8 + (lane & 7)) * 4;  // and columns c0..c0+3 of each group
  const int row0 = blockIdx.x * kRows;
  const int nK = (K + kSliceK - 1) / kSliceK;
  const int nChunks = (H + kChunk - 1) / kChunk;

  auto load_w1 = [&](int c, int ks) {
    stage<kSliceK, kChunk, kVec>(w1s + ((c * nK + ks) & 1) * (kSliceK * kChunk), w1, H,
                                 ks * kSliceK, c * kChunk, K, H);
  };
  auto load_w2 = [&](int c, int hs) {
    stage<kSliceH, Np, kVec>(w2s + ((c * nH + hs) & 1) * (kSliceH * Np), w2, N,
                             c * kChunk + hs * kSliceH, 0, H, N);
  };

  load_w1(0, 0);
  for (int i = tid; i < kRows * Kp; i += kThreads) {
    const int r = i / Kp, k = i - r * Kp;
    const int gr = row0 + r;
    float t = 0.f;
    if (gr < M && k < K) {
      t = act(pre, x[(size_t)gr * K + k]);
      if (kDrop && drops.on[0])
        t *= philox::keep_scale(drops.site[0], philox::kPre, (unsigned long long)gr * K + k);
    }
    xs[i] = t;
  }

  float acc[4][NJ][4] = {};
  for (int c = 0; c < nChunks; ++c) {
    // z[i][j] = pre(x)[rb + 4i, :] . W1[:, c * kChunk + c0 + j]
    float z[4][4] = {};
    for (int ks = 0; ks < nK; ++ks) {
      cp_async_wait_all();
      __syncthreads();  // slice ks has landed; everyone is done with the buffer reloaded next
      if (ks + 1 < nK) load_w1(c, ks + 1); else load_w2(c, 0);
      const float* ws = w1s + ((c * nK + ks) & 1) * (kSliceK * kChunk);
      const float* xk = xs + ks * kSliceK;
#pragma unroll
      for (int kk = 0; kk < kSliceK; kk += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(xk + (rb + 4 * i) * Kp + kk, a[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float b[4];
          load4(ws + (kk + u) * kChunk + c0, b);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) z[i][j] = fmaf(a[i][u], b[j], z[i][j]);
        }
      }
    }
    // The last W2 step of the previous chunk is behind the syncs above, so
    // the mid tile is free to overwrite.
    float bias[4];
    bool in[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gh = c * kChunk + c0 + j;
      in[j] = gh < H;
      bias[j] = in[j] ? b1[gh] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a[4];
      if (kDrop && drops.on[1]) {
        float ks[4];
        philox::keep_scale4(drops.site[1], philox::kMid,
                            (unsigned long long)(row0 + rb + 4 * i) * H + c * kChunk + c0, ks);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float zz = z[i][j] + bias[j];
          a[j] = drops.mid_act_first ? act(mid, zz) * ks[j] : act(mid, zz * ks[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = act(mid, z[i][j] + bias[j]);
      }
      float4 v;
      v.x = in[0] ? a[0] : 0.f;
      v.y = in[1] ? a[1] : 0.f;
      v.z = in[2] ? a[2] : 0.f;
      v.w = in[3] ? a[3] : 0.f;
      *reinterpret_cast<float4*>(as + (rb + 4 * i) * kAs + c0) = v;
    }
    // acc[i][j][e] += a[rb + 4i, :] . W2[chunk, j * 128 + c0 + e]
    for (int hs = 0; hs < nH; ++hs) {
      cp_async_wait_all();
      __syncthreads();  // the mid tile is written and W2 slice hs has landed
      if (hs + 1 < nH) load_w2(c, hs + 1); else if (c + 1 < nChunks) load_w1(c + 1, 0);
      const float* ws = w2s + ((c * nH + hs) & 1) * (kSliceH * Np);
      const float* ah = as + hs * kSliceH;
#pragma unroll
      for (int hh = 0; hh < kSliceH; hh += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(ah + (rb + 4 * i) * kAs + hh, a[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float b[4];
            load4(ws + (hh + u) * Np + j * kColGroup + c0, b);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] = fmaf(a[i][u], b[e], acc[i][j][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + rb + 4 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float ks[4] = {1.f, 1.f, 1.f, 1.f};
      if (kDrop && drops.on[2])
        philox::keep_scale4(drops.site[2], philox::kPost,
                            (unsigned long long)gr * N + j * kColGroup + c0, ks);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kColGroup + c0 + e;
        if (col >= N) continue;
        const float zz = acc[i][j][e] + b2[col];
        out[(size_t)gr * N + col] = act(post, kDrop && drops.on[2] ? zz * ks[e] : zz);
      }
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*,
                          const float*, float*, int, int, int, int, int, int, int, Drops);

#define GAN_MLP_FWD_ROW(VEC, DROP)                                                        \
  {                                                                                       \
    mlp_fwd_kernel<1, VEC, DROP>, mlp_fwd_kernel<2, VEC, DROP>,                           \
        mlp_fwd_kernel<3, VEC, DROP>, mlp_fwd_kernel<4, VEC, DROP>                        \
  }

// [dropout][vectorised copies][NJ - 1]
const KernelFn kKernels[2][2][kMaxColGroups] = {
    {GAN_MLP_FWD_ROW(false, false), GAN_MLP_FWD_ROW(true, false)},
    {GAN_MLP_FWD_ROW(false, true), GAN_MLP_FWD_ROW(true, true)},
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if N is out of range).
int gan_mlp_fwd_smem_bytes(int K, int N) {
  if (K < 1 || N < 1 || N > kMaxColGroups * kColGroup) return 0;
  const long nj = (N + kColGroup - 1) / kColGroup;
  const long floats = (long)kRows * (round_up(K, kSliceK) + kPad) + 2L * kSliceK * kChunk +
                      (long)kRows * kAs + 2L * kSliceH * nj * kColGroup;
  return (int)(floats * sizeof(float));
}

// x (M, K), w1 (K, H), b1 (H), w2 (H, N), b2 (N), out (M, N): f32, contiguous,
// on the current device.  pre / mid / post: 0 none, 1 relu, 2 gelu;
// mid_act_first: the mid order (0 drop_first, 1 act_first).  thresholds[s]
// and scales[s] describe the dropout of site s (pre, mid, post), drawn from
// `seed`; drop_on[s] != 0 where its rate is > 0.  Launches on `stream`;
// returns cudaGetLastError() after the launch.
int gan_mlp_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, float* out, int M, int K, int H, int N,
                int pre, int mid, int post, int mid_act_first, unsigned long long seed,
                const unsigned int* thresholds, const float* scales, const int* drop_on,
                cudaStream_t stream) {
  const int smem = gan_mlp_fwd_smem_bytes(K, N);
  if (smem == 0 || M < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Drops drops;
  bool any = false;
  for (int s = 0; s < 3; ++s) {
    drops.site[s] = philox::Dropout{seed, thresholds[s], scales[s]};
    drops.on[s] = drop_on[s] != 0;
    any = any || drops.on[s];
  }
  drops.mid_act_first = mid_act_first;
  const bool vec = H % 4 == 0 && N % 4 == 0 && aligned16(w1) && aligned16(w2);
  const KernelFn kernel = kKernels[any][vec][(N + kColGroup - 1) / kColGroup - 1];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (M + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, stream>>>(x, w1, b1, w2, b2, out, M, K, H, N,
                                             pre, mid, post, drops);
  return (int)cudaGetLastError();
}

const char* gan_mlp_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
