// Grouped SwiGLU expert FFN for Hopper (sm_90a), f32: the routed experts of
// a mixture-of-experts layer, forward and backward, with each group's rows
// and offsets read from device memory, so that one captured CUDA graph
// replays any routing.
//
// Rows arrive sorted by group: group e owns rows [off[e], off[e + 1]) of x
// (T, H), with off (E + 1 ints) on the device; with off == nullptr the one
// group is all T rows (a shared expert, a dense SwiGLU).  Rows at or past
// off[E] belong to no group and are never read or written.  For row t of
// group e, with routing weight w[t] (1 where w == nullptr):
//   g = x Wg[e]^T,  u = x Wu[e]^T                       (F each)
//   a = w * silu(g) * u                                  (F)
//   y = a Wd[e]^T                                        (H)
// Wg, Wu (E, F, H) and Wd (E, H, F) as torch's Linear weights.  Backward,
// given dy (T, H):
//   da = dy Wd[e];  h = silu(g) u;  dw = sum_f da h
//   dg = w da u silu'(g),  du = w da silu(g),  silu'(g) = s (1 + g (1 - s))
//   dx = [dg du] [Wg; Wu][e]
//   dWg[e] = sum_rows dg^T x,  dWu[e] = sum_rows du^T x,  dWd[e] = sum_rows dy^T a
//
// Every product runs mlp_tile.cuh's tile code: 3xTF32 mma.sync over 64 x 64
// output tiles of 4 warps and a 3-stage cp.async ring of 32-deep k-slices
// (mlp::load_tile, the tf32 fragments, mlp::stage_acc), each 8-deep k step
// summed apart and added to the accumulator in round-to-nearest (mma3_rn), so
// the products are f32-accurate at any depth.  The
// row-tile launches (gate-up, down, the SwiGLU backward, dx) take a grid of
// ceil(T / 64) + E row tiles, the most that sum_e ceil(n_e / 64) can reach;
// a block finds its group and tile from off, and the blocks past the last
// tile exit.  A gate-up block computes 32 columns of g and the same 32 of u
// as one 64-wide tile (B's rows 0-31 from Wg, 32-63 from Wu), so SwiGLU is
// its epilogue; g and u are kept (z, (T, 2F) as [g | u]) for the backward
// where z is given.  The weight gradients reduce over all of a group's rows
// in one block: their grids (E x ceil(F / 64) x ceil(H / 64) tiles and
// more) fill many waves at the widths this library serves, so their
// reduction is not split as mlp_bwd.cu's is.  dw sums each row's 64-column tile
// partials within a half warp (a fixed tree) and then over the tiles in
// order.  No float atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

using namespace mlp;

constexpr int kSmem = ring_floats(kStages) * (int)sizeof(float);  // 55,296 bytes
constexpr int kHalf = kBN / 2;  // the gate (and up) columns of a gate-up tile
// The product kernels take 3 blocks an SM (168 registers a thread; capped at
// 128 for 4, they spilled 250-560 bytes), 166 KB of shared memory.

struct Group {
  int e, tile, off, rows;  // e < 0: the block has no tile
};

// Row-tile block y's group and tile: groups in order, ceil(n_e / 64) tiles each.
__device__ __forceinline__ Group find_tile(const int* __restrict__ off, int E, int T, int y) {
  __shared__ int s[4];
  if (threadIdx.x == 0) {
    int e = -1, tile = 0, o = 0, rows = 0;
    if (off == nullptr) {
      if (y < (T + kBM - 1) / kBM) e = 0, tile = y, rows = T;
    } else {
      int acc = 0;
      for (int j = 0; j < E; ++j) {
        const int o0 = off[j], n = off[j + 1] - o0, t = (n + kBM - 1) / kBM;
        if (y < acc + t) {
          e = j, tile = y - acc, o = o0, rows = n;
          break;
        }
        acc += t;
      }
    }
    s[0] = e, s[1] = tile, s[2] = o, s[3] = rows;
  }
  __syncthreads();
  return Group{s[0], s[1], s[2], s[3]};
}

// acc += a b in f32 accuracy: the 3xTF32 products of one 8-deep k step
// summed in a fresh fragment, then added to acc by the FP32 pipe.  The tensor
// core adds into its accumulator by truncation (round toward zero), so
// running the whole reduction through it (tf32::mma3 into acc, as
// mlp_tile.cuh does) leaves an error that grows with the depth: on the H100
// 3e-5 to 1.8e-4 of the outputs' RMS at depths of 1,408 to 22,528, against
// cuBLAS f32's 1e-6 (both against float64).  Truncating within one step and
// rounding to nearest across steps keeps it near cuBLAS f32's.
__device__ __forceinline__ void mma3_rn(float (&acc)[4], const tf32::FragA& a,
                                        const tf32::FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  tf32::mma3(t, a, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += t[j];
}

// acc += A B over nk k-slices, as mlp::tile_product, with the slices' tiles
// staged by load_a(dst, i) and load_b(dst, i): A as [m][k] (or [k][m] where
// kTA), B as [k][n] (or [n][k] where kTB).
template <bool kTA, bool kTB, class LoadA, class LoadB>
__device__ __forceinline__ void product(float (&acc)[2][4][4], float* ring, int nk,
                                        const LoadA& load_a, const LoadB& load_b) {
  float* sa = ring;
  float* sb = ring + kStages * kTile;
  const auto load = [=](int i) {
    const int s = i % kStages;
    load_a(sa + s * kTile, i);
    load_b(sb + s * kTile, i);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load(i);
    tf32::stage_commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int i = 0; i < nk; ++i) {
    tf32::stage_wait<kStages - 2>();
    if (i + kStages - 1 < nk) load(i + kStages - 1);
    tf32::stage_commit();
    const float* as = sa + (i % kStages) * kTile;
    const float* bs = sb + (i % kStages) * kTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      tf32::FragA fa[2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
        fa[x] = tf32::load_a_fast<kTA>(as, kTA ? kLdMN : kLdK, wm + 16 * x, kk, g, t);
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const tf32::FragB fb = tf32::load_b_fast<!kTB>(bs, kTB ? kLdK : kLdMN, kk, wn + 8 * y, g, t);
#pragma unroll
        for (int x = 0; x < 2; ++x) mma3_rn(acc[x][y], fa[x], fb);
      }
    }
  }
}

__device__ __forceinline__ float sigmoid(float g) { return 1.f / (1.f + expf(-g)); }

// a = w silu(g) u (and z = [g | u] where z): a block's 64 rows x 32 columns.
__global__ void __launch_bounds__(kThreads, 3)
grouped_gate_up_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const int* __restrict__ off, int E, int T, const float* __restrict__ wg,
                       const float* __restrict__ wu, float* __restrict__ z, float* __restrict__ a,
                       int H, int F, int vec_x, int vec_w, int vec_o) {
  extern __shared__ __align__(16) float smem[];
  const Group gr = find_tile(off, E, T, blockIdx.y);
  if (gr.e < 0) return;
  const int m0 = gr.tile * kBM, c0 = blockIdx.x * kHalf;
  const float* xe = x + (size_t)gr.off * H;
  const float* we_g = wg + (size_t)gr.e * F * H;
  const float* we_u = wu + (size_t)gr.e * F * H;
  float acc[2][4][4] = {};
  product<false, true>(
      acc, smem, (H + kBK - 1) / kBK,
      [=](float* dst, int i) {
        load_tile<kBM, kBK, kLdK, false>(dst, xe, H, m0, gr.rows, i * kBK, H, vec_x);
      },
      [=](float* dst, int i) {
        load_tile<kHalf, kBK, kLdK, false>(dst, we_g, H, c0, F, i * kBK, H, vec_w);
        load_tile<kHalf, kBK, kLdK, false>(dst + kHalf * kLdK, we_u, H, c0, F, i * kBK, H, vec_w);
      });
  stage_acc(smem, acc);
  constexpr int kQuads = kHalf / 4, kRows = kThreads / kQuads;
  const int q = threadIdx.x % kQuads, f = c0 + 4 * q, n = min(4, F - f);
  if (f >= F) return;
#pragma unroll 1
  for (int r = threadIdx.x / kQuads; r < kBM; r += kRows) {
    if (m0 + r >= gr.rows) break;
    const size_t row = (size_t)gr.off + m0 + r;
    const float4 gq = *reinterpret_cast<const float4*>(smem + r * kLdMN + 4 * q);
    const float4 uq = *reinterpret_cast<const float4*>(smem + r * kLdMN + kHalf + 4 * q);
    const float gv[4] = {gq.x, gq.y, gq.z, gq.w}, uv[4] = {uq.x, uq.y, uq.z, uq.w};
    const float wt = w != nullptr ? w[row] : 1.f;
    float av[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) av[j] = wt * (gv[j] * sigmoid(gv[j]) * uv[j]);
    store4(a, row * F + f, n, vec_o == 4, av);
    if (z != nullptr) {
      store4(z, row * 2 * F + f, n, vec_o == 4, gv);
      store4(z, row * 2 * F + F + f, n, vec_o == 4, uv);
    }
  }
}

// y = a Wd[e]^T: a block's 64 rows x 64 columns of H.
__global__ void __launch_bounds__(kThreads, 3)
grouped_down_kernel(const float* __restrict__ a, const int* __restrict__ off, int E, int T,
                    const float* __restrict__ wd, float* __restrict__ y, int H, int F, int vec_a,
                    int vec_w, int vec_o) {
  extern __shared__ __align__(16) float smem[];
  const Group gr = find_tile(off, E, T, blockIdx.y);
  if (gr.e < 0) return;
  const int m0 = gr.tile * kBM, n0 = blockIdx.x * kBN;
  const float* ae = a + (size_t)gr.off * F;
  const float* we = wd + (size_t)gr.e * H * F;
  float acc[2][4][4] = {};
  product<false, true>(
      acc, smem, (F + kBK - 1) / kBK,
      [=](float* dst, int i) {
        load_tile<kBM, kBK, kLdK, false>(dst, ae, F, m0, gr.rows, i * kBK, F, vec_a);
      },
      [=](float* dst, int i) {
        load_tile<kBN, kBK, kLdK, false>(dst, we, F, n0, H, i * kBK, F, vec_w);
      });
  stage_acc(smem, acc);
  const int c = n0 + staged_col(), n = min(4, H - c);
  if (c >= H) return;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int r = m0 + staged_row0() + kRowsPer * i;
    if (r >= gr.rows) break;
    float v[4];
    staged_row(smem, i, v);
    store4(y, ((size_t)gr.off + r) * H + c, n, vec_o == 4, v);
  }
}

// da = dy Wd[e] over a block's 64 rows x 64 columns of F, then SwiGLU's
// derivative into dz = [dg | du], and each row's sum of da h over the tile's
// columns into dw_part[row][blockIdx.x] where w is given.
__global__ void __launch_bounds__(kThreads, 3)
grouped_swiglu_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                          const int* __restrict__ off, int E, int T, const float* __restrict__ wd,
                          const float* __restrict__ z, float* __restrict__ dz,
                          float* __restrict__ dw_part, int H, int F, int vec_dy, int vec_w,
                          int vec_o) {
  extern __shared__ __align__(16) float smem[];
  const Group gr = find_tile(off, E, T, blockIdx.y);
  if (gr.e < 0) return;
  const int m0 = gr.tile * kBM, f0 = blockIdx.x * kBN;
  const float* dye = dy + (size_t)gr.off * H;
  const float* we = wd + (size_t)gr.e * H * F;
  float acc[2][4][4] = {};
  product<false, false>(
      acc, smem, (H + kBK - 1) / kBK,
      [=](float* dst, int i) {
        load_tile<kBM, kBK, kLdK, false>(dst, dye, H, m0, gr.rows, i * kBK, H, vec_dy);
      },
      [=](float* dst, int i) {
        load_tile<kBK, kBN, kLdMN, true>(dst, we, F, i * kBK, H, f0, F, vec_w);
      });
  stage_acc(smem, acc);
  const int f = f0 + staged_col(), n = min(4, F - f);
  const int nft = gridDim.x;
#pragma unroll 1
  for (int i = 0; i < kGroups; ++i) {
    const int r = m0 + staged_row0() + kRowsPer * i;
    const bool in = r < gr.rows && f < F;
    const size_t row = (size_t)gr.off + r;
    float s = 0.f;
    if (in) {
      float v[4], gv[4], uv[4], dg[4], du[4];
      staged_row(smem, i, v);
      load4(z, row * 2 * F + f, n, vec_o == 4, gv);
      load4(z, row * 2 * F + F + f, n, vec_o == 4, uv);
      const float wt = w != nullptr ? w[row] : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sg = sigmoid(gv[j]), silu = gv[j] * sg, dh = wt * v[j];
        du[j] = dh * silu;
        dg[j] = dh * uv[j] * (sg * (1.f + gv[j] * (1.f - sg)));
        if (j < n) s += v[j] * (silu * uv[j]);
      }
      store4(dz, row * 2 * F + f, n, vec_o == 4, dg);
      store4(dz, row * 2 * F + F + f, n, vec_o == 4, du);
    }
    if (dw_part != nullptr) {  // the 16 threads of a staged row: one half warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (staged_col() == 0 && r < gr.rows) dw_part[row * nft + blockIdx.x] = s;
    }
  }
}

// dw[t] = dw_part[t][0] + ... + dw_part[t][nft - 1], in that order; 0 past
// the last group's rows.
__global__ void __launch_bounds__(256)
grouped_dw_sum_kernel(const float* __restrict__ dw_part, int nft, const int* __restrict__ off,
                      int E, int T, float* __restrict__ dw) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int total = off != nullptr ? off[E] : T;
  float s = 0.f;
  if (t < total)
    for (int j = 0; j < nft; ++j) s += dw_part[(size_t)t * nft + j];
  dw[t] = s;
}

// dx = dg Wg[e] + du Wu[e]: a block's 64 rows x 64 columns of H, the
// reduction over F gate slices and then F up slices.
__global__ void __launch_bounds__(kThreads, 3)
grouped_dx_kernel(const float* __restrict__ dz, const int* __restrict__ off, int E, int T,
                  const float* __restrict__ wg, const float* __restrict__ wu,
                  float* __restrict__ dx, int H, int F, int vec_dz, int vec_w, int vec_o) {
  extern __shared__ __align__(16) float smem[];
  const Group gr = find_tile(off, E, T, blockIdx.y);
  if (gr.e < 0) return;
  const int m0 = gr.tile * kBM, n0 = blockIdx.x * kBN, nkg = (F + kBK - 1) / kBK;
  const float* dze = dz + (size_t)gr.off * 2 * F;
  const float* we_g = wg + (size_t)gr.e * F * H;
  const float* we_u = wu + (size_t)gr.e * F * H;
  float acc[2][4][4] = {};
  product<false, false>(
      acc, smem, 2 * nkg,
      [=](float* dst, int i) {
        const bool up = i >= nkg;
        load_tile<kBM, kBK, kLdK, false>(dst, up ? dze + F : dze, 2 * F, m0, gr.rows,
                                         (up ? i - nkg : i) * kBK, F, vec_dz);
      },
      [=](float* dst, int i) {
        const bool up = i >= nkg;
        load_tile<kBK, kBN, kLdMN, true>(dst, up ? we_u : we_g, H, (up ? i - nkg : i) * kBK, F,
                                         n0, H, vec_w);
      });
  stage_acc(smem, acc);
  const int c = n0 + staged_col(), n = min(4, H - c);
  if (c >= H) return;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int r = m0 + staged_row0() + kRowsPer * i;
    if (r >= gr.rows) break;
    float v[4];
    staged_row(smem, i, v);
    store4(dx, ((size_t)gr.off + r) * H + c, n, vec_o == 4, v);
  }
}

// dW[e][m][n] = sum_t G[t][col + m] X[t][n] over group e's rows:
// blockIdx.y = e * mt + m-tile.  kTwo: the m-tiles' second half are the up
// weights (col = F, out1), the first the gate's (col = 0, out0).
template <bool kTwo>
__global__ void __launch_bounds__(kThreads, 3)
grouped_wgrad_kernel(const float* __restrict__ G, int ldg, const float* __restrict__ X, int ldx,
                     const int* __restrict__ off, int E, int T, int n_out, int k_in, int mt,
                     float* __restrict__ out0, float* __restrict__ out1, int vec_g, int vec_x,
                     int vec_o) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.y / mt;
  int mtile = blockIdx.y % mt, half = 0;
  if (kTwo && mtile >= mt / 2) mtile -= mt / 2, half = 1;
  const int m0 = mtile * kBM, n0 = blockIdx.x * kBN;
  const int o = off != nullptr ? off[e] : 0, rows = off != nullptr ? off[e + 1] - o : T;
  const int nk = (rows + kBK - 1) / kBK;
  const float* ge = G + (size_t)o * ldg + half * n_out;
  const float* xe = X + (size_t)o * ldx;
  float acc[2][4][4] = {};
  product<true, false>(
      acc, smem, nk,
      [=](float* dst, int i) {
        load_tile<kBK, kBM, kLdMN, true>(dst, ge, ldg, i * kBK, rows, m0, n_out, vec_g);
      },
      [=](float* dst, int i) {
        load_tile<kBK, kBN, kLdMN, true>(dst, xe, ldx, i * kBK, rows, n0, k_in, vec_x);
      });
  stage_acc(smem, acc);
  const int c = n0 + staged_col(), n = min(4, k_in - c);
  if (c >= k_in) return;
  float* dst = (half ? out1 : out0) + (size_t)e * n_out * k_in;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int r = m0 + staged_row0() + kRowsPer * i;
    if (r >= n_out) break;
    float v[4];
    staged_row(smem, i, v);
    store4(dst, (size_t)r * k_in + c, n, vec_o == 4, v);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// 4, 2 or 1 floats a copy: every ld and offset a multiple and every pointer aligned.
int width(const int* lds, int n_ld, const void* const* ptrs, int n_ptr) {
  unsigned long long bits = 0;
  int all = 0;
  for (int i = 0; i < n_ptr; ++i) bits |= (unsigned long long)ptrs[i];
  for (int i = 0; i < n_ld; ++i) all |= lds[i];
  if (all % 4 == 0 && (bits & 15) == 0) return 4;
  if (all % 2 == 0 && (bits & 7) == 0) return 2;
  return 1;
}

int row_tiles(const int* off, int E, int T) { return cdiv(T, kBM) + (off != nullptr ? E : 0); }

// One weight gradient, (E x halves, n_out, k_in) = sum over each group's
// rows of G's n_out columns (of each half) times X's k_in columns.
template <bool kTwo>
cudaError_t wgrad(int n_out, int k_in, const float* G, int ldg, const float* X, int ldx,
                  const int* off, int E, int T, float* out0, float* out1, cudaStream_t stream) {
  const auto kernel = grouped_wgrad_kernel<kTwo>;
  cudaError_t err = tf32::configure(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const int mt = (kTwo ? 2 : 1) * cdiv(n_out, kBM);
  const int lg[] = {ldg, kTwo ? n_out : 0}, lx[] = {ldx}, lo[] = {k_in};
  const void* pg[] = {G};
  const void* px[] = {X};
  const void* po[] = {out0, out1 != nullptr ? out1 : out0};
  kernel<<<dim3(cdiv(k_in, kBN), E * mt), kThreads, kSmem, stream>>>(
      G, ldg, X, ldx, off, E, T, n_out, k_in, mt, out0, out1, width(lg, 2, pg, 1),
      width(lx, 1, px, 1), width(lo, 1, po, 2));
  return cudaGetLastError();
}

bool bad_sizes(int E, int T, int H, int F) {
  return E < 1 || T < 0 || H < 1 || F < 1 || (long long)T * 2 * F >= (1ll << 31) ||
         (long long)T * H >= (1ll << 31) || (long long)E * F * H >= (1ll << 31) ||
         cdiv(T, kBM) + E > 65535 || (long long)E * 2 * cdiv(F > H ? F : H, kBM) > 65535;
}

}  // namespace

extern "C" {

// x (T, H), w (T) or null, off (E + 1 ints, device) or null (one group of T
// rows), wg, wu (E, F, H), wd (E, H, F) in; z (T, 2F) (or null), a (T, F),
// y (T, H) out, rows at or past off[E] untouched.  All f32, contiguous, on
// the current device; launches on `stream`.  Returns the first CUDA error.
int gan_moe_ffn_fwd(const float* x, const float* w, const int* off, int E, int T, int H, int F,
                    const float* wg, const float* wu, const float* wd, float* z, float* a, float* y,
                    cudaStream_t stream) {
  if (bad_sizes(E, T, H, F) || (off == nullptr && E != 1)) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaError_t err = tf32::configure(grouped_gate_up_kernel, kSmem);
  if (err == cudaSuccess) err = tf32::configure(grouped_down_kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int rt = row_tiles(off, E, T);
  {
    const int lx[] = {H}, lw[] = {H}, lo[] = {F};
    const void* px[] = {x};
    const void* pw[] = {wg, wu};
    const void* po[] = {a, z != nullptr ? z : a};
    grouped_gate_up_kernel<<<dim3(cdiv(F, kHalf), rt), kThreads, kSmem, stream>>>(
        x, w, off, E, T, wg, wu, z, a, H, F, width(lx, 1, px, 1), width(lw, 1, pw, 2),
        width(lo, 1, po, 2));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int la[] = {F}, lo[] = {H};
  const void* pa[] = {a, wd};
  const void* po[] = {y};
  grouped_down_kernel<<<dim3(cdiv(H, kBN), rt), kThreads, kSmem, stream>>>(
      a, off, E, T, wd, y, H, F, width(la, 1, pa, 1), width(la, 1, pa + 1, 1),
      width(lo, 1, po, 1));
  return (int)cudaGetLastError();
}

// The backward of gan_moe_ffn_fwd, given dy (T, H), the forward's x, w, z
// and a: dx (T, H) (rows at or past off[E] untouched), dwg, dwu (E, F, H),
// dwd (E, H, F), and dw (T) where w is given (0 past off[E]).  Scratch: dz
// (T, 2F), and dw_part (T, ceil(F / 64)) where w is given.  Launches on
// `stream`.
int gan_moe_ffn_bwd(const float* x, const float* w, const int* off, int E, int T, int H, int F,
                    const float* wg, const float* wu, const float* wd, const float* z,
                    const float* a, const float* dy, float* dx, float* dwg, float* dwu,
                    float* dwd, float* dw, float* dz, float* dw_part, cudaStream_t stream) {
  if (bad_sizes(E, T, H, F) || (off == nullptr && E != 1)) return (int)cudaErrorInvalidValue;
  if (w != nullptr && (dw == nullptr || dw_part == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = tf32::configure(grouped_swiglu_bwd_kernel, kSmem);
  if (err == cudaSuccess) err = tf32::configure(grouped_dx_kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int rt = row_tiles(off, E, T), nft = cdiv(F, kBN);
  if (T > 0) {
    const int ly[] = {H}, lw[] = {F}, lo[] = {F};
    const void* py[] = {dy};
    const void* pw[] = {wd};
    const void* po[] = {z, dz};
    grouped_swiglu_bwd_kernel<<<dim3(nft, rt), kThreads, kSmem, stream>>>(
        dy, w, off, E, T, wd, z, dz, w != nullptr ? dw_part : nullptr, H, F, width(ly, 1, py, 1),
        width(lw, 1, pw, 1), width(lo, 1, po, 2));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (w != nullptr) {
      grouped_dw_sum_kernel<<<cdiv(T, 256), 256, 0, stream>>>(dw_part, nft, off, E, T, dw);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    const int lz[] = {2 * F, F}, lh[] = {H};
    const void* pz[] = {dz};
    const void* pgu[] = {wg, wu};
    const void* px[] = {dx};
    grouped_dx_kernel<<<dim3(cdiv(H, kBN), rt), kThreads, kSmem, stream>>>(
        dz, off, E, T, wg, wu, dx, H, F, width(lz, 2, pz, 1), width(lh, 1, pgu, 2),
        width(lh, 1, px, 1));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = wgrad<true>(F, H, dz, 2 * F, x, H, off, E, T, dwg, dwu, stream);
  if (err == cudaSuccess) err = wgrad<false>(H, F, dy, H, a, F, off, E, T, dwd, nullptr, stream);
  return (int)err;
}

const char* gan_moe_ffn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
