// Fused two-layer MLP backward for Hopper (sm_90a), bf16.
//
// Replaces: gan_ffn_tpu/ops/mlp.py::_bwd_kernel (pallas_call at :292) at
// bfloat16 operands, as the JAX trainers run it under --bf16
// (gan_ffn_tpu/cli/train_iemocap.py:155, train_iemocap_dialoguernn.py:137).
// At the JAX kernel's rounding points (mlp.py:162-233):
//   the chain recomputed in f32 from bf16 operands (:180): t1 = bf16(pre(x)
//     M_pre), z1 = t1 W1 + b1, a1 = bf16(mid(z1)), z2 = a1 W2 + b2;
//   g = post ? dout act'(z2 M_post) M_post : dout, in f32; gd = bf16(g);
//   dW2 = a1^T gd, db2 = sum_rows g (the f32 g, :189-194);
//   da1 = gd W2^T; dz1 = da1 act'(zd1) M_mid (drop_first) or (da1 M_mid)
//     act'(z1) (act_first), in f32; dz1d = bf16(dz1) (:195-207);
//   dW1 = t1^T dz1d, db1 = sum_rows dz1 (the f32 dz1, :208-213);
//   dx = bf16((dz1d W1^T) M_pre act'(x)) (:214-221);
//   dW, db summed over every row in f32 and cast once to the weights'
//     dtype, bf16 (out_shape :294-299, :305-308).
// The plain twin is ops/mlp.py::_mlp_backward_bf16, which rounds at the
// same points.
//
// Every product runs on the f64 tensor cores (mma.m16n8k4.f64,
// mlp_bf16_tile.cuh) from bf16 operands, so each output is the exact sum
// rounded to f32 once, as the plain version takes it: its roundings to bf16
// (dx, dW) and the f32 chain between do not depend on an order of
// summation.  z1 comes from mlp_bf16_tile.cuh, the tile code of
// mlp_fwd_bf16.cu (stage_t1, z1_product, z1_value on the same 64 x 64
// tiles), so it is the forward's bits and relu' takes the branch that relu
// took.  The f32 chain's steps are single rounded operations (__fmul_rn), as
// torch and XLA run them, with act' of the exact gelu as Phi(z) + z phi(z).
//
// The TPU kernel sums dW over row tiles in one resident accumulator; Hopper
// blocks run in no order, so the work is split into launches that each own
// their outputs, as in mlp_bwd.cu:
//   1. z1: t1 (written out for dW1 where pre exists), a1 and act'(z1) or
//      act'(z1 M_mid) (bf16 for relu, whose act' is 0 or 1; else f32), one
//      block per 64 rows and d_ff chunk (z1_split: whole waves);
//   2. z2 -> g, gd (only with post; else g = gd = dout);
//   3. gd W2^T -> dz1 (over act') -> dz1d, and db1's column sums of the f32
//      dz1 per 64-row tile, which a second kernel adds in ascending tiles;
//   4. dz1d W1^T -> dx            (reduces over H);
//   5. t1^T dz1d -> dW1           (over M);
//   6. a1^T gd   -> dW2           (over M);
//   7. db2: column sums of g in f64 (two passes, a fixed order).
// Steps 2-6 run one tiled product: a 64 x 64 tile of 4 warps, A and B each
// read as they lie (plain or transposed; ldmatrix, .trans where the layout
// wants it) through a 3-stage cp.async ring of 32-deep slices, four blocks
// an SM.  Steps 2 and 4-6 split their reduction as mlp_bwd.cu does where
// the grid is at most half a wave (split_reduction; ops/mlp.py
// bwd_bf16_launches mirrors it): each chunk writes its f64 partial sums to
// the workspace and a second kernel adds them in ascending chunk order, so
// the sums stay exact and two calls give the same bits.  No atomics.  The
// epilogues draw one Philox call per two pairs of mask values (site_row)
// and move pairs of outputs in one access.
//
// What bounds it on the H100: operations.  At M = 3584 rows the products
// are 2 M (K H + H N) flops each for z1, da1, dx, dW1 and dW2 (and z2 with
// post): 37.6 GFLOP for the visual FFN 512->2048->512, 0.038 ms at 989
// TFLOP/s (bf16, dense), 0.56 ms at the 67 TFLOP/s of the f64 tensor cores
// this kernel runs them on; the scratch traffic is ~120 MB (0.036 ms).

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

constexpr int kRing = 3;                  // the streamed product's ring stages
constexpr int kLdK = kSlice + 8;          // [m][k] and [n][k] tiles: 40 bf16
constexpr int kLdMN = kBM + 8;            // [k][m] and [k][n] tiles: 72 bf16
constexpr int kOpElems = kBM * kLdK;      // one staged operand tile (the larger layout)
static_assert(kSlice * kLdMN <= kOpElems, "both layouts of a tile fit");
constexpr int kGemmSmem = 2 * kRing * kOpElems * (int)sizeof(bf16_t);  // 30,720 bytes

// d act(z) / dz, each step rounded as the plain version (f32 torch) rounds
// it: the exact gelu's Phi(z) + z phi(z).
__device__ __forceinline__ float act_grad(int a, float z) {
  if (a == mlp::kRelu) return z > 0.f ? 1.f : 0.f;
  if (a == mlp::kGelu) {
    const float Phi = __fmul_rn(0.5f, __fadd_rn(1.f, erff(__fmul_rn(z, 0.70710678118654752f))));
    const float phi = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, z), z)), 0.39894228040143268f);
    return __fadd_rn(Phi, __fmul_rn(z, phi));
  }
  return 1.f;
}

// acc += sum_k A(r, k) B(k, c) over the 64 x 64 output tile at (m0, n0), k
// in [kbeg, kend): A(r, k) = kTA ? A[k * lda + r] : A[r * lda + k], B(k, c)
// = kTB ? B[c * ldb + k] : B[k * ldb + c], bf16 in device memory, zero past
// kM, kN and kK; copies of vec_a, vec_b bf16.  Both stream through a ring of
// kRing stages of 32-deep slices, as they lie in device memory ([m][k] or
// [k][m], [k][n] or [n][k]); ldmatrix (.trans where the layout wants it)
// gives every layout the same fragments, and mma_k16 multiplies them on the
// f64 tensor cores.  Every thread of the block must call.
template <bool kTA, bool kTB>
__device__ __forceinline__ void streamed_product(Acc& acc, bf16_t* ring,
                                                 const bf16_t* __restrict__ A, int lda, int vec_a,
                                                 const bf16_t* __restrict__ B, int ldb, int vec_b,
                                                 int kM, int kN, int kK, int m0, int n0, int kbeg,
                                                 int kend) {
  bf16_t* sa = ring;
  bf16_t* sb = ring + kRing * kOpElems;
  const int nk = (kend - kbeg + kSlice - 1) / kSlice;
  const auto load = [&](int i) {
    const int k0 = kbeg + i * kSlice, s = i % kRing;
    if (kTA)
      bf16::load_tile(sa + s * kOpElems, kLdMN, A, lda, k0, kK, m0, kM, kSlice, kBM, vec_a);
    else
      bf16::load_tile(sa + s * kOpElems, kLdK, A, lda, m0, kM, k0, kK, kBM, kSlice, vec_a);
    if (kTB)
      bf16::load_tile(sb + s * kOpElems, kLdK, B, ldb, n0, kN, k0, kK, kBN, kSlice, vec_b);
    else
      bf16::load_tile(sb + s * kOpElems, kLdMN, B, ldb, k0, kK, n0, kN, kSlice, kBN, vec_b);
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < nk) load(i);
    bf16::commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int i = 0; i < nk; ++i) {
    bf16::wait<kRing - 2>();  // slice i is in; every warp is done with slice i - 1
    if (i + kRing - 1 < nk) load(i + kRing - 1);  // into slice i - 1's buffer
    bf16::commit();
    const bf16_t* as = sa + (i % kRing) * kOpElems;
    const bf16_t* bs = sb + (i % kRing) * kOpElems;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16) {
      uint32_t ra[2][4], rb[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kTA)
          bf16::load_a_t(ra[h], as, kLdMN, wm + 16 * h, kk, lane);
        else
          bf16::load_a(ra[h], as, kLdK, wm + 16 * h, kk, lane);
        if (kTB)
          bf16::load_b_nk(rb[h], bs, kLdK, wn + 16 * h, kk, lane);
        else
          bf16::load_b_kn(rb[h], bs, kLdMN, kk, wn + 16 * h, lane);
      }
      mma_k16(acc, ra, rb);
    }
  }
}

enum Epi { kEpiZ2 = 0, kEpiDz1 = 1, kEpiDx = 2, kEpiDw = 3 };

struct EpiArgs {
  const bf16_t* bias;  // z2: b2
  const bf16_t* in;    // z2: dout; dx: x
  float* f32;          // z2: g (written); dz1: act' (read; bf16 where mid is relu)
  bf16_t* out;         // z2: gd; dz1: dz1d; dx: dx; dw: dW
  double* col_part;    // dz1: each row tile's column sums of dz1, [row tile][column]
  int pairs;           // kN even and the pointers aligned: pairs move in one access
};

// Elements o and o + 1 of p (the second where n == 2; 0 past the row): one
// access where `pair`.
__device__ __forceinline__ void load_pair(const float* p, size_t o, int n, bool pair,
                                          float (&v)[2]) {
  if (pair) {
    const float2 x = *reinterpret_cast<const float2*>(p + o);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = p[o];
    v[1] = n == 2 ? p[o + 1] : 0.f;
  }
}

__device__ __forceinline__ void load_pair(const bf16_t* p, size_t o, int n, bool pair,
                                          float (&v)[2]) {
  if (pair) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + o));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __bfloat162float(p[o]);
    v[1] = n == 2 ? __bfloat162float(p[o + 1]) : 0.f;
  }
}

__device__ __forceinline__ void store_pair(float* p, size_t o, int n, bool pair,
                                           const float (&v)[2]) {
  if (pair) {
    *reinterpret_cast<float2*>(p + o) = make_float2(v[0], v[1]);
  } else {
    p[o] = v[0];
    if (n == 2) p[o + 1] = v[1];
  }
}

__device__ __forceinline__ void store_pair(bf16_t* p, size_t o, int n, bool pair,
                                           const float (&v)[2]) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p + o) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    p[o] = __float2bfloat16_rn(v[0]);
    if (n == 2) p[o + 1] = __float2bfloat16_rn(v[1]);
  }
}

// The dropout site of an epilogue's masks (none for dW): post for z2, mid
// for dz1, pre for dx.
template <int kEpi>
__host__ __device__ constexpr int epi_site() {
  return kEpi == kEpiZ2 ? 2 : kEpi == kEpiDz1 ? 1 : 0;
}
template <int kEpi>
__host__ __device__ constexpr uint32_t epi_stream() {
  return kEpi == kEpiZ2 ? philox::kPost : kEpi == kEpiDz1 ? philox::kMid : philox::kPre;
}

// The epilogue of outputs (r, c) and (r, c + 1) where c + 1 < kN (c even),
// from their sums v0, v1 rounded to f32 and their mask values ks (of the
// site epi_site<kEpi>()); res gets the f32 values (dz1: the f32 dz1, 0 past
// kN, for the column sums of db1).
template <int kEpi>
__device__ __forceinline__ void epilogue(int r, int c, float v0, float v1, const float (&ks)[2],
                                         int kN, const Chain& chain, const EpiArgs& e,
                                         float (&res)[2]) {
  const size_t o = (size_t)r * kN + c;
  const int n = c + 1 < kN ? 2 : 1;
  const bool pair = n == 2 && e.pairs;
  float v[2] = {v0, v1}, in[2];
  if (kEpi == kEpiZ2 || (kEpi == kEpiDx && chain.pre != mlp::kNone)) load_pair(e.in, o, n, pair, in);
  if (kEpi == kEpiDz1) {
    if (chain.mid == mlp::kRelu)
      load_pair(reinterpret_cast<const bf16_t*>(e.f32), o, n, pair, in);
    else
      load_pair(e.f32, o, n, pair, in);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (kEpi == kEpiZ2) {  // kN = N: g = dout act'(z2 M) M, gd = bf16(g)
      const float z = __fadd_rn(v[j], __bfloat162float(e.bias[c + (j < n ? j : 0)]));
      float gj = __fmul_rn(in[j], act_grad(chain.post, chain.on[2] ? __fmul_rn(z, ks[j]) : z));
      if (chain.on[2]) gj = __fmul_rn(gj, ks[j]);
      res[j] = gj;
    } else if (kEpi == kEpiDz1) {  // kN = H: in holds act' of z1 (act_first) or z1 M (drop_first)
      float d;
      if (chain.mid_act_first) {
        const float da = chain.on[1] ? __fmul_rn(v[j], ks[j]) : v[j];
        d = __fmul_rn(da, in[j]);
      } else {
        d = __fmul_rn(v[j], in[j]);
        if (chain.on[1]) d = __fmul_rn(d, ks[j]);
      }
      res[j] = d;
    } else if (kEpi == kEpiDx) {  // kN = K
      float d = v[j];
      if (chain.pre != mlp::kNone) {
        if (chain.on[0]) d = __fmul_rn(d, ks[j]);
        d = __fmul_rn(d, act_grad(chain.pre, in[j]));
      }
      res[j] = d;
    } else {  // kEpiDw
      res[j] = v[j];
    }
  }
  if (kEpi == kEpiZ2) store_pair(e.f32, o, n, pair, res);
  store_pair(e.out, o, n, pair, res);
  if (n == 1) res[1] = 0.f;
}

// C = A B (see streamed_product) over one 64 x 64 tile of a kM x kN output
// and one chunk of the reduction, k in [z chunk, min((z + 1) chunk, kK)) for
// z = blockIdx.z.  With part == nullptr the block applies the epilogue, else
// it writes its f64 sums to part[z][r][c] for reduce_kernel.
template <bool kTA, bool kTB, int kEpi>
__global__ void __launch_bounds__(kThreads, 4)
gemm_kernel(const bf16_t* __restrict__ A, int lda, int vec_a, const bf16_t* __restrict__ B,
            int ldb, int vec_b, int kM, int kN, int kK, int chunk, double* __restrict__ part,
            Chain chain, EpiArgs e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* ring = reinterpret_cast<bf16_t*>(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * chunk, kend = min(kbeg + chunk, kK);
  Acc acc = {};
  streamed_product<kTA, kTB>(acc, ring, A, lda, vec_a, B, ldb, vec_b, kM, kN, kK, m0, n0, kbeg,
                             kend);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const unsigned long long seed = part == nullptr ? mlp::call_seed(chain) : 0ull;
  double col[4][2] = {};  // dz1: the lane's column sums over its rows, in row order
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = m0 + wm + 8 * x + g;
    float ks[4][2] = {};
    if (part == nullptr && kEpi != kEpiDw)  // the same for the whole block
      site_row(chain, epi_site<kEpi>(), epi_stream<kEpi>(), seed, r, n0 + wn + 2 * t, kN, ks);
    if (r >= kM) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int c = n0 + wn + 8 * y + 2 * t;
      if (c >= kN) continue;
      if (part != nullptr) {
        double* p = part + ((size_t)blockIdx.z * kM + r) * kN + c;
        p[0] = at(acc, x, y, 0);
        if (c + 1 < kN) p[1] = at(acc, x, y, 1);
      } else {
        float res[2];
        epilogue<kEpi>(r, c, (float)at(acc, x, y, 0), (float)at(acc, x, y, 1), ks[y], kN, chain,
                       e, res);
        if (kEpi == kEpiDz1) {
          col[y][0] += (double)res[0];
          col[y][1] += (double)res[1];
        }
      }
    }
  }
  if (kEpi == kEpiDz1) {
    // db1's partial column sums of the tile, in a fixed order: each lane's
    // rows, then across its 8 row groups g (butterfly: every lane gets the
    // same sum), then the warp of rows 0 .. 31 before that of rows 32 .. 63
    double* red = reinterpret_cast<double*>(smem_raw);  // [2][64], over the ring
#pragma unroll
    for (int y = 0; y < 4; ++y) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int m = 4; m < 32; m *= 2) col[y][j] += __shfl_xor_sync(0xffffffffu, col[y][j], m);
      }
    }
    __syncthreads();  // every warp is done with the ring
    if (g == 0) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        red[(wm >> 5) * 64 + wn + 8 * y + 2 * t] = col[y][0];
        red[(wm >> 5) * 64 + wn + 8 * y + 2 * t + 1] = col[y][1];
      }
    }
    __syncthreads();
    const int c = n0 + (int)threadIdx.x;
    if (threadIdx.x < kBN && c < kN)
      e.col_part[(size_t)blockIdx.y * kN + c] = red[threadIdx.x] + red[kBN + threadIdx.x];
  }
}

// The second pass of a split launch: outputs (r, c), (r, c + 1) = part[0] +
// ... + part[S - 1] there, in that order in f64, rounded to f32 once, then
// the epilogue.  One thread per pair of columns.
template <int kEpi>
__global__ void __launch_bounds__(256)
reduce_kernel(const double* __restrict__ part, int S, int kM, int kN, Chain chain, EpiArgs e) {
  const int pairs = (kN + 1) / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)kM * pairs) return;
  const int r = (int)(i / pairs), c = 2 * (int)(i % pairs);
  const size_t o = (size_t)r * kN + c, stride = (size_t)kM * kN;
  double v0 = 0.0, v1 = 0.0;
  for (int s = 0; s < S; ++s) {
    v0 += part[s * stride + o];
    if (c + 1 < kN) v1 += part[s * stride + o + 1];
  }
  float ks[2] = {1.f, 1.f};
  if (kEpi != kEpiDw)
    site_pair(chain, epi_site<kEpi>(), epi_stream<kEpi>(), mlp::call_seed(chain), o, ks[0], ks[1]);
  float res[2];
  epilogue<kEpi>(r, c, (float)v0, (float)v1, ks, kN, chain, e, res);
}

// Step 1: z1 of rows m0 .. m0 + 63 and one d_ff chunk, through the forward's
// tile code: a1 = bf16(mid(z1)) and d = act'(z1) (act_first) or act'(z1 M)
// (drop_first), the first d_ff chunk's blocks also writing t1 where pre
// exists (t1_out).
__global__ void __launch_bounds__(kThreads, kResident)
z1_kernel(const bf16_t* __restrict__ x, int vec_x, const bf16_t* __restrict__ w1, int vec_w1,
          const bf16_t* __restrict__ b1, bf16_t* __restrict__ t1_out,
          bf16_t* __restrict__ a1_out, float* __restrict__ d_out, int pairs, int M, int K, int H,
          int chunk, Chain chain) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* t1 = reinterpret_cast<bf16_t*>(smem_raw);  // 64 x Kp, row stride ld_t1(K)
  bf16_t* ring = t1 + kBM * ld_t1(K);
  const int m0 = blockIdx.y * kBM, h0 = blockIdx.x * chunk, hn = min(chunk, H - h0);
  const unsigned long long seed = mlp::call_seed(chain);
  stage_t1(t1, x, vec_x, m0, M, K, chain, seed);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  product_start(ring, z1_stream(w1, K, H, h0, vec_w1));
  for (int j0 = 0; j0 < hn; j0 += kBN) {
    Acc acc;
    z1_product(acc, ring, t1, K, z1_stream(w1, K, H, h0 + j0, vec_w1));  // waits for t1
    if (j0 + kBN < hn) product_start(ring, z1_stream(w1, K, H, h0 + j0 + kBN, vec_w1));
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = m0 + wm + 8 * x + g;
      float ks[4][2];
      site_row(chain, 1, philox::kMid, seed, r, h0 + j0 + wn + 2 * t, H, ks);
      if (r >= M) continue;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int c = h0 + j0 + wn + 8 * y + 2 * t;  // c even
        if (c >= H) continue;
        const size_t o = (size_t)r * H + c;
        const int n = c + 1 < H ? 2 : 1;
        float a[2], d[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float z = z1_value(at(acc, x, y, j), b1, c + (j < n ? j : 0));
          float unused;
          mlp::mid_act(chain, z, ks[y][j], a[j], unused);
          const bool drop_first = chain.on[1] && !chain.mid_act_first;
          d[j] = act_grad(chain.mid, drop_first ? __fmul_rn(z, ks[y][j]) : z);
        }
        store_pair(a1_out, o, n, n == 2 && pairs, a);
        if (chain.mid == mlp::kRelu)  // relu' is 0 or 1: exact in bf16, half the bytes
          store_pair(reinterpret_cast<bf16_t*>(d_out), o, n, n == 2 && pairs, d);
        else
          store_pair(d_out, o, n, n == 2 && pairs, d);
      }
    }
  }
  if (t1_out != nullptr && blockIdx.x == 0) {  // t1 is in: z1_product waited for it
    for (int idx = threadIdx.x; idx < kBM * K; idx += kThreads) {
      const int rl = idx / K, c = idx % K;
      if (m0 + rl < M) t1_out[(size_t)(m0 + rl) * K + c] = t1[rl * ld_t1(K) + c];
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_t v) { return __bfloat162float(v); }

// Step 7: db[c] = bf16(sum_r src[r][c]) over M rows of width W, summed in
// f64 and rounded to f32 once, in two passes with a fixed order.  The first
// gives each block 32 columns and kColRows rows: 8 row groups (rows r0 + i,
// r0 + i + 8, ...) then the groups in order, into part[blockIdx.y][c]; the
// second sums those partials in ascending blockIdx.y.
constexpr int kColRows = 128;

template <typename T>
__global__ void __launch_bounds__(256)
colsum_kernel(const T* __restrict__ src, double* __restrict__ part, int M, int W) {
  __shared__ double grp[8][32];
  const int c = blockIdx.x * 32 + (threadIdx.x & 31), gr = threadIdx.x >> 5;
  const int r0 = blockIdx.y * kColRows, r1 = min(r0 + kColRows, M);
  double v = 0.0;
  if (c < W) {
    for (int r = r0 + gr; r < r1; r += 8) v += (double)to_f32(src[(size_t)r * W + c]);
  }
  grp[gr][threadIdx.x & 31] = v;
  __syncthreads();
  if (gr == 0 && c < W) {
    double s = 0.0;
    for (int i = 0; i < 8; ++i) s += grp[i][threadIdx.x];
    part[(size_t)blockIdx.y * W + c] = s;
  }
}

__global__ void __launch_bounds__(256)
colsum_finish_kernel(const double* __restrict__ part, int R, bf16_t* __restrict__ db, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  double s = 0.0;
  for (int y = 0; y < R; ++y) s += part[(size_t)y * W + c];
  db[c] = __float2bfloat16_rn((float)s);
}

template <typename T>
cudaError_t colsum(const T* src, bf16_t* db, double* ws, int M, int W, cudaStream_t stream) {
  const int R = (M + kColRows - 1) / kColRows;
  colsum_kernel<T><<<dim3((W + 31) / 32, R), 256, 0, stream>>>(src, ws, M, W);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    colsum_finish_kernel<<<(W + 255) / 256, 256, 0, stream>>>(ws, R, db, W);
    err = cudaGetLastError();
  }
  return err;
}

struct RedSplit {
  int chunk, S;  // k-extent of a chunk, and chunks
};

// mlp_bwd.cu's split: not at all where the tiles make half a wave alone,
// else into s = min(kWaveBlocks / tiles, slices) chunks of ceil(slices / s)
// slices each (the last may be shorter; rounding may leave fewer than s).
RedSplit split_reduction(long long tiles, int depth) {
  const int slices = (depth + kSlice - 1) / kSlice;
  if (2 * tiles > kWaveBlocks || slices <= 1) return {slices * kSlice, 1};
  const int s = (int)(kWaveBlocks / tiles < slices ? kWaveBlocks / tiles : slices);
  const int chunk = (slices + s - 1) / s * kSlice;
  return {chunk, (depth + chunk - 1) / chunk};
}

long long tiles_of(int kM, int kN) {
  return (long long)((kM + kBM - 1) / kBM) * ((kN + kBN - 1) / kBN);
}

int width_of(int width, const void* p) {
  const void* const ptrs[] = {p};
  return bf16::copy_width(width, ptrs, 1);
}

// Launches C = A B with the epilogue kEpi; where `split`, a grid of at most
// half a wave splits the reduction through the f64 workspace `ws`.
template <bool kTA, bool kTB, int kEpi>
cudaError_t gemm(const bf16_t* A, int lda, const bf16_t* B, int ldb, int kM, int kN, int kK,
                 bool split, double* ws, const Chain& chain, EpiArgs e, cudaStream_t stream) {
  const auto addr = [](const void* p) { return (unsigned long long)p; };
  e.pairs = kN % 2 == 0 && ((addr(e.in) | addr(e.out)) & 3) == 0 && (addr(e.f32) & 7) == 0;
  const RedSplit sp = split ? split_reduction(tiles_of(kM, kN), kK) : RedSplit{kK, 1};
  const auto kernel = gemm_kernel<kTA, kTB, kEpi>;
  cudaError_t err = tf32::configure(kernel, kGemmSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((kN + kBN - 1) / kBN, (kM + kBM - 1) / kBM, sp.S);
  kernel<<<grid, kThreads, kGemmSmem, stream>>>(A, lda, width_of(lda, A), B, ldb,
                                                width_of(ldb, B), kM, kN, kK, sp.chunk,
                                                sp.S > 1 ? ws : nullptr, chain, e);
  err = cudaGetLastError();
  if (err == cudaSuccess && sp.S > 1) {
    const long long n = (long long)kM * ((kN + 1) / 2);
    reduce_kernel<kEpi><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(ws, sp.S, kM, kN, chain,
                                                                       e);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// Doubles of workspace gan_mlp_bwd_bf16 needs for M rows of K -> H -> N: the
// largest S x (outputs) of its split launches (z2, which runs only with
// post; dx; dW1; dW2), and at least the column sums' partials: db1's, one
// row of H per 64-row tile, and db2's, one row of N per kColRows rows.
long long gan_mlp_bwd_bf16_workspace_doubles(int M, int K, int H, int N) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return 0;
  const int out[4][3] = {{M, N, H}, {M, K, H}, {K, H, M}, {H, N, M}};  // kM, kN, depth
  long long most = 0;
  for (const auto& l : out) {
    const RedSplit sp = split_reduction(tiles_of(l[0], l[1]), l[2]);
    if (sp.S > 1 && (long long)sp.S * l[0] * l[1] > most) most = (long long)sp.S * l[0] * l[1];
  }
  const long long db1 = (long long)((M + kBM - 1) / kBM) * H;
  const long long db2 = (long long)((M + kColRows - 1) / kColRows) * N;
  const long long sums = db1 > db2 ? db1 : db2;
  return most > sums ? most : sums;
}

// x (M, K), w1 (K, H), b1 (H), w2 (H, N), b2 (N), dout (M, N) in; dx (M, K),
// dw1 (K, H), db1 (H), dw2 (H, N), db2 (N) out: bf16.  Scratch: t1 (M, K)
// bf16 (used only with pre), a1 (M, H) bf16, dz1 (M, H) f32, dz1d (M, H)
// bf16, g (M, N) f32 and gd (M, N) bf16 (used only with post), ws
// (gan_mlp_bwd_bf16_workspace_doubles) f64.  All contiguous, on the current
// device.  The chain's arguments as gan_mlp_fwd_bf16 took them.  Launches on
// `stream`; returns the first cudaGetLastError() that is not cudaSuccess,
// else cudaSuccess.
int gan_mlp_bwd_bf16(const bf16_t* x, const bf16_t* w1, const bf16_t* b1, const bf16_t* w2,
                     const bf16_t* b2, const bf16_t* dout, bf16_t* dx, bf16_t* dw1, bf16_t* db1,
                     bf16_t* dw2, bf16_t* db2, bf16_t* t1, bf16_t* a1, float* dz1, bf16_t* dz1d,
                     float* g, bf16_t* gd, double* ws, int M, int K, int H, int N, int pre,
                     int mid, int post, int mid_act_first, const unsigned long long* seed_base,
                     int seed_index, const unsigned int* thresholds, const float* scales,
                     const int* drop_on, cudaStream_t stream) {
  if (M < 1 || K < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  // int flat indices, and the grid's y extent (row tiles of M, K, H)
  if ((long long)M * (K > H ? (K > N ? K : N) : (H > N ? H : N)) >= (1ll << 31) ||
      (long long)K * H >= (1ll << 31) || (long long)H * N >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if ((long long)(M > H ? (M > K ? M : K) : (H > K ? H : K)) > 65535ll * kBM)
    return (int)cudaErrorInvalidValue;
  if ((drop_on[0] || drop_on[1] || drop_on[2]) && seed_base == nullptr)
    return (int)cudaErrorInvalidValue;
  const Chain chain = mlp::make_chain(pre, mid, post, mid_act_first, seed_base, seed_index,
                                      thresholds, scales, drop_on);
  cudaError_t err;
#define GAN_MLP_BWD_STEP(call)           \
  err = (call);                          \
  if (err != cudaSuccess) return (int)err;

  // 1. z1 -> a1, act'; t1
  Device d;
  GAN_MLP_BWD_STEP(current_device(&d));
  const Split sp = z1_split(d, M, K, H);
  const bf16_t* t1_in = pre != mlp::kNone ? t1 : x;
  GAN_MLP_BWD_STEP(tf32::configure(z1_kernel, z1_smem(K)));
  z1_kernel<<<dim3(sp.S, (M + kBM - 1) / kBM), kThreads, z1_smem(K), stream>>>(
      x, width_of(K, x), w1, width_of(H, w1), b1, pre != mlp::kNone ? t1 : nullptr, a1, dz1,
      H % 2 == 0 && ((unsigned long long)a1 & 3) == 0 && ((unsigned long long)dz1 & 7) == 0, M,
      K, H, sp.chunk, chain);
  GAN_MLP_BWD_STEP(cudaGetLastError());
  // 2. g and gd
  const float* g_sum = nullptr;
  const bf16_t* g_in = dout;
  if (post != mlp::kNone) {
    const EpiArgs e{b2, dout, g, gd};
    GAN_MLP_BWD_STEP((gemm<false, false, kEpiZ2>(a1, H, w2, N, M, N, H, true, ws, chain, e,
                                                 stream)));
    g_sum = g;
    g_in = gd;
  }
  // 3. dz1 = (gd W2^T) . act' (. M_mid), over act' in place; dz1d
  // with db1's partial column sums of each row tile into the workspace, and
  // db1 = bf16 of their sum in ascending row tiles (before dx needs the
  // workspace)
  GAN_MLP_BWD_STEP((gemm<false, true, kEpiDz1>(g_in, N, w2, N, M, H, N, false, ws, chain,
                                               EpiArgs{nullptr, nullptr, dz1, dz1d, ws}, stream)));
  colsum_finish_kernel<<<(H + 255) / 256, 256, 0, stream>>>(ws, (M + kBM - 1) / kBM, db1, H);
  GAN_MLP_BWD_STEP(cudaGetLastError());
  // 4. dx
  GAN_MLP_BWD_STEP((gemm<false, true, kEpiDx>(dz1d, H, w1, H, M, K, H, true, ws, chain,
                                              EpiArgs{nullptr, x, nullptr, dx}, stream)));
  // 5, 6. dW1 = t1^T dz1d, dW2 = a1^T gd
  GAN_MLP_BWD_STEP((gemm<true, false, kEpiDw>(t1_in, K, dz1d, H, K, H, M, true, ws, chain,
                                              EpiArgs{nullptr, nullptr, nullptr, dw1}, stream)));
  GAN_MLP_BWD_STEP((gemm<true, false, kEpiDw>(a1, H, g_in, N, H, N, M, true, ws, chain,
                                              EpiArgs{nullptr, nullptr, nullptr, dw2}, stream)));
  // 7. db2 from the f32 g (or dout), its partials in the workspace, which the
  // products no longer need
  if (g_sum != nullptr) {
    GAN_MLP_BWD_STEP(colsum(g_sum, db2, ws, M, N, stream));
  } else {
    GAN_MLP_BWD_STEP(colsum(dout, db2, ws, M, N, stream));
  }
#undef GAN_MLP_BWD_STEP
  return (int)cudaSuccess;
}

// The d_ff split of the z1 recompute gan_mlp_bwd_bf16 launches for M rows
// of K -> H on the current device: split[0] chunks of split[1] columns.
// Returns a CUDA error code.
int gan_mlp_bwd_bf16_z1_split(int M, int K, int H, int* split) {
  if (M < 1 || K < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Device d;
  const cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return (int)err;
  const Split sp = z1_split(d, M, K, H);
  split[0] = sp.S;
  split[1] = sp.chunk;
  return (int)cudaSuccess;
}

const char* gan_mlp_bwd_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
