// Fused masked multi-head attention backward for Hopper (sm_90a), f32.
//
// Replaces: gan_ffn_tpu/ops/attention.py::_bwd_kernel (pallas_call at :197),
// reached through _fa_bwd -> _bwd_call.
//
// Given dO, recomputes the forward of attention_fwd.cu (S = Q K^T * scale,
// keys >= valid_len masked to -1e30, P = softmax(S), the dropout mask M of
// philox.cuh's stream kAttention at flat index ((b * H + h) * L + i) * L + j)
// and returns
//   dV = (P * M)^T dO,   dA = dO V^T,   D_i = sum_j P_ij M_ij dA_ij,
//   dS = P * (dA * M - D) * scale,   dQ = dS K,   dK = dS^T Q.
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
// writes 3 (B, H, L, Dh) tensors (~2.5-12.8 MB) and does the work of five
// (L x L x Dh) products (~0.5-2.3 GFLOP): a few microseconds at 3.35 TB/s or
// 67 TFLOP/s f32.  Latency and the serial walks of one block bound it.
//
// Design: one block per (batch, head), one thread per row (query or key),
// up to 128 threads.  Q, K, V and dO of the (b, h) and one (L, L) buffer sit
// in shared memory (at L = 128, Dh = 64: 197 KB, above the 48 KB default, so
// the launch raises the block's limit).  Passes, each thread keeping at most
// two Dh-rows in registers (256 floats would exceed the 255-register limit
// at Dh = 64):
//   1. query row i: walk the keys with an online softmax for m_i, l_i, and
//      D_i (q_i and dO_i in registers);
//   2. query row i: A_ij = P_ij M_ij into the buffer;
//   3. key row j:   dV_j = sum_i A_ij dO_i;
//   4. query row i: dS_ij into the buffer (q_i and dO_i in registers);
//   5. query row i: dQ_i = sum_j dS_ij K_j; key row j: dK_j = sum_i dS_ij Q_i.
// Every sum runs in ascending order, so two calls give the same bits.  The
// buffer's row stride is L + 1 floats, so a warp reading a column (pass 5,
// dQ) or writing a row (passes 2, 4) hits 32 different banks.

#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kMaxLen = 128;  // rows (threads) and keys per block
constexpr int kMaxDim4 = 16;  // Dh <= 64, in groups of 4

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int D4>
__device__ __forceinline__ float dot(const float (&a)[4 * D4], const float* b) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < D4; ++g) {
    const float4 bv = *reinterpret_cast<const float4*>(b + 4 * g);
    part[0] = fmaf(a[4 * g + 0], bv.x, part[0]);
    part[1] = fmaf(a[4 * g + 1], bv.y, part[1]);
    part[2] = fmaf(a[4 * g + 2], bv.z, part[2]);
    part[3] = fmaf(a[4 * g + 3], bv.w, part[3]);
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

template <int D4>
__device__ __forceinline__ void axpy(float (&acc)[4 * D4], float w, const float* x) {
#pragma unroll
  for (int g = 0; g < D4; ++g) {
    const float4 xv = *reinterpret_cast<const float4*>(x + 4 * g);
    acc[4 * g + 0] = fmaf(w, xv.x, acc[4 * g + 0]);
    acc[4 * g + 1] = fmaf(w, xv.y, acc[4 * g + 1]);
    acc[4 * g + 2] = fmaf(w, xv.z, acc[4 * g + 2]);
    acc[4 * g + 3] = fmaf(w, xv.w, acc[4 * g + 3]);
  }
}

template <int D4>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[4 * D4], int Dh) {
#pragma unroll
  for (int d = 0; d < 4 * D4; ++d)
    if (d < Dh) dst[d] = r[d];
}

template <int D4>
__device__ __forceinline__ void load_row(float (&r)[4 * D4], const float* src) {
#pragma unroll
  for (int g = 0; g < D4; ++g) {
    const float4 t = *reinterpret_cast<const float4*>(src + 4 * g);
    r[4 * g + 0] = t.x;
    r[4 * g + 1] = t.y;
    r[4 * g + 2] = t.z;
    r[4 * g + 3] = t.w;
  }
}

// D4 = ceil(Dh / 4); kDrop: the forward applied attention-weight dropout.
template <int D4, bool kDrop>
__global__ void __launch_bounds__(kMaxLen)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int L, int Dh, int valid_len, float scale, philox::Dropout drop) {
  constexpr int Dp = 4 * D4;
  extern __shared__ __align__(16) float smem[];
  const int Ls = L + 1;          // row stride of the (L, L) buffer
  float* sq = smem;              // L x Dp, zero-padded
  float* sk = sq + L * Dp;
  float* sv = sk + L * Dp;
  float* sdo = sv + L * Dp;
  float* sbuf = sdo + L * Dp;    // L x Ls: A, then dS
  float* sm = sbuf + L * Ls;     // m_i
  float* sl = sm + L;            // l_i
  float* sD = sl + L;            // D_i
  const size_t base = (size_t)blockIdx.x * L * Dh;

  for (int idx = threadIdx.x; idx < L * Dp; idx += blockDim.x) {
    const int r = idx / Dp, d = idx - r * Dp;
    const bool in = d < Dh;
    const size_t g = base + (size_t)r * Dh + d;
    sq[idx] = in ? q[g] : 0.f;
    sk[idx] = in ? k[g] : 0.f;
    sv[idx] = in ? v[g] : 0.f;
    sdo[idx] = in ? dout[g] : 0.f;
  }
  __syncthreads();

  const int t = threadIdx.x;  // query row i in passes 1, 2, 4, 5; key row j in 3, 5
  const bool uniform = valid_len <= 0;
  const int keys = uniform ? L : min(valid_len, L);
  const unsigned long long mask_row = ((unsigned long long)blockIdx.x * L + t) * L;

  // Pass 1: m_i, l_i, D_i (online over the keys; D rescaled with l).
  if (t < L && !uniform) {
    float qr[Dp], dor[Dp];
    load_row<D4>(qr, sq + t * Dp);
    load_row<D4>(dor, sdo + t * Dp);
    float m = -INFINITY, l = 0.f, d = 0.f;
    philox::Cursor cursor;
    for (int j = 0; j < keys; ++j) {
      const float s = dot<D4>(qr, sk + j * Dp) * scale;
      float da = dot<D4>(dor, sv + j * Dp);
      if (kDrop) da *= cursor.at(drop, philox::kAttention, mask_row + j);
      if (s > m) {
        const float c = expf(m - s);
        l *= c;
        d *= c;
        m = s;
      }
      const float e = expf(s - m);
      l += e;
      d = fmaf(e, da, d);
    }
    sm[t] = m;
    sl[t] = l;
    sD[t] = d / l;
  }

  // Pass 2: A_ij = P_ij M_ij (0 at masked keys).
  if (t < L) {
    float* arow = sbuf + t * Ls;
    philox::Cursor cursor;
    if (uniform) {
      const float p = 1.f / (float)L;
      for (int j = 0; j < L; ++j)
        arow[j] = kDrop ? p * cursor.at(drop, philox::kAttention, mask_row + j) : p;
    } else {
      float qr[Dp];
      load_row<D4>(qr, sq + t * Dp);
      const float m = sm[t], inv_l = 1.f / sl[t];
      for (int j = 0; j < L; ++j) {
        float a = 0.f;
        if (j < keys) {
          a = expf(dot<D4>(qr, sk + j * Dp) * scale - m) * inv_l;
          if (kDrop) a *= cursor.at(drop, philox::kAttention, mask_row + j);
        }
        arow[j] = a;
      }
    }
  }
  __syncthreads();

  // Pass 3: dV_j = sum_i A_ij dO_i.
  if (t < L) {
    float acc[Dp];
#pragma unroll
    for (int d = 0; d < Dp; ++d) acc[d] = 0.f;
    for (int i = 0; i < L; ++i) axpy<D4>(acc, sbuf[i * Ls + t], sdo + i * Dp);
    store_row<D4>(dv + base + (size_t)t * Dh, acc, Dh);
  }
  if (uniform) {  // block-uniform: no barrier follows on this branch
    if (t < L) {
      for (int d = 0; d < Dh; ++d) {
        dq[base + (size_t)t * Dh + d] = 0.f;
        dk[base + (size_t)t * Dh + d] = 0.f;
      }
    }
    return;
  }
  __syncthreads();  // pass 3 is done with A

  // Pass 4: dS_ij = P_ij (dA_ij M_ij - D_i) scale (0 at masked keys).
  if (t < L) {
    float qr[Dp], dor[Dp];
    load_row<D4>(qr, sq + t * Dp);
    load_row<D4>(dor, sdo + t * Dp);
    const float m = sm[t], inv_l = 1.f / sl[t], D = sD[t];
    float* srow = sbuf + t * Ls;
    philox::Cursor cursor;
    for (int j = 0; j < L; ++j) {
      float ds = 0.f;
      if (j < keys) {
        const float p = expf(dot<D4>(qr, sk + j * Dp) * scale - m) * inv_l;
        float da = dot<D4>(dor, sv + j * Dp);
        if (kDrop) da *= cursor.at(drop, philox::kAttention, mask_row + j);
        ds = p * (da - D) * scale;
      }
      srow[j] = ds;
    }
  }
  __syncthreads();

  // Pass 5: dQ_i = sum_j dS_ij K_j, then dK_j = sum_i dS_ij Q_i.
  if (t < L) {
    float acc[Dp];
#pragma unroll
    for (int d = 0; d < Dp; ++d) acc[d] = 0.f;
    for (int j = 0; j < keys; ++j) axpy<D4>(acc, sbuf[t * Ls + j], sk + j * Dp);
    store_row<D4>(dq + base + (size_t)t * Dh, acc, Dh);
#pragma unroll
    for (int d = 0; d < Dp; ++d) acc[d] = 0.f;
    for (int i = 0; i < L; ++i) axpy<D4>(acc, sbuf[i * Ls + t], sq + i * Dp);
    store_row<D4>(dk + base + (size_t)t * Dh, acc, Dh);
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*,
                          float*, float*, int, int, int, float, philox::Dropout);

#define GAN_ATTN_BWD_ROW(DROP)                                                              \
  {                                                                                         \
    attention_bwd_kernel<1, DROP>, attention_bwd_kernel<2, DROP>,                           \
        attention_bwd_kernel<3, DROP>, attention_bwd_kernel<4, DROP>,                       \
        attention_bwd_kernel<5, DROP>, attention_bwd_kernel<6, DROP>,                       \
        attention_bwd_kernel<7, DROP>, attention_bwd_kernel<8, DROP>,                       \
        attention_bwd_kernel<9, DROP>, attention_bwd_kernel<10, DROP>,                      \
        attention_bwd_kernel<11, DROP>, attention_bwd_kernel<12, DROP>,                     \
        attention_bwd_kernel<13, DROP>, attention_bwd_kernel<14, DROP>,                     \
        attention_bwd_kernel<15, DROP>, attention_bwd_kernel<16, DROP>,                     \
  }

// [dropout][D4 - 1]
const KernelFn kKernels[2][kMaxDim4] = {GAN_ATTN_BWD_ROW(false), GAN_ATTN_BWD_ROW(true)};

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if the geometry is refused).
int gan_attention_bwd_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxLen || Dh < 1 || Dh > 4 * kMaxDim4) return 0;
  return (4 * L * round_up(Dh, 4) + L * (L + 1) + 3 * L) * (int)sizeof(float);
}

// q, k, v, dout, dq, dk, dv: (B, H, L, Dh) f32, contiguous, on the current
// device.  dropout != 0: the forward applied the mask of (seed, threshold,
// drop_scale).  Launches on `stream`; returns cudaGetLastError().
int gan_attention_bwd(const float* q, const float* k, const float* v, const float* dout,
                      float* dq, float* dk, float* dv, int B, int H, int L, int Dh,
                      int valid_len, float scale, int dropout, unsigned long long seed,
                      unsigned int threshold, float drop_scale, cudaStream_t stream) {
  const int smem = gan_attention_bwd_smem_bytes(L, Dh);
  if (smem == 0 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kKernels[dropout != 0][(Dh + 3) / 4 - 1];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const philox::Dropout drop{seed, threshold, drop_scale};
  kernel<<<B * H, round_up(L, 32), smem, stream>>>(q, k, v, dout, dq, dk, dv, L, Dh,
                                                   valid_len, scale, drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
