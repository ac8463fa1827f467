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
// stream exists only on the TPU.
//
// What bounds it on the H100: at the path's shapes (B <= 32, L <= 112,
// (H, Dh) in {(10, 10), (8, 64)}) one launch moves ~1.4-7.3 MB and does
// ~0.2-0.9 GFLOP, i.e. a few microseconds at 3.35 TB/s or 67 TFLOP/s f32:
// the launch and the latency of one short block dominate.  The TPU kernel's
// point -- the (B, H, L, L) scores never reach device memory -- holds here
// too: no score leaves its thread.
//
// Design: one block per (batch, head), one thread per query row.  The block
// stages K and V of its (b, h) in shared memory, rows padded to a multiple of
// 4 floats.  Each thread keeps its q row and its output row in registers and
// walks the keys with an online softmax (running max m, running sum l, the
// output rescaled when m grows).  l sums the unmasked p; the output sums
// p * mask * v, so dividing by l at the end gives P_drop V.  All threads of
// a warp read the same key row, so each 16-byte shared load is one
// broadcast feeding 4 FMAs.  With valid_len > 0 a masked key's
// p = exp(-1e30 - m) is exactly 0 in f32, so the walk stops at valid_len;
// with valid_len = 0 every score is the same -1e30 and every p is 1, so the
// walk covers all L keys with p = 1.  Dropout is a template flag: the
// rate-0 kernels draw nothing.  The TPU layout (sequence on the 128-lane
// axis, Dh padded to the sublane tile) is not carried over.

#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kMaxLen = 128;  // query rows (threads) and keys per block
constexpr int kMaxDim4 = 16;  // Dh <= 64, in groups of 4

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// D4 = ceil(Dh / 4); kDrop: apply the attention-weight dropout mask.
template <int D4, bool kDrop>
__global__ void __launch_bounds__(kMaxLen)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int L, int Dh, int valid_len, float scale, philox::Dropout drop) {
  constexpr int Dp = 4 * D4;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;         // L x Dp, zero-padded
  float* sv = sk + L * Dp;  // L x Dp, zero-padded
  const size_t base = (size_t)blockIdx.x * L * Dh;

  for (int i = threadIdx.x; i < L * Dp; i += blockDim.x) {
    const int r = i / Dp, d = i - r * Dp;
    const bool in = d < Dh;
    sk[i] = in ? k[base + (size_t)r * Dh + d] : 0.f;
    sv[i] = in ? v[base + (size_t)r * Dh + d] : 0.f;
  }
  const int row = threadIdx.x;
  float qr[Dp], o[Dp];
#pragma unroll
  for (int d = 0; d < Dp; ++d) {
    qr[d] = (row < L && d < Dh) ? q[base + (size_t)row * Dh + d] : 0.f;
    o[d] = 0.f;
  }
  __syncthreads();
  if (row >= L) return;  // no barrier follows

  const bool uniform = valid_len <= 0;
  const int keys = uniform ? L : min(valid_len, L);
  float m = -INFINITY, l = 0.f;
  const unsigned long long mask_row = ((unsigned long long)blockIdx.x * L + row) * L;
  philox::Cursor cursor;
  for (int j = 0; j < keys; ++j) {
    float s = 0.f;
    if (!uniform) {
      const float* kr = sk + j * Dp;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < D4; ++g) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * g);
        part[0] = fmaf(qr[4 * g + 0], kv.x, part[0]);
        part[1] = fmaf(qr[4 * g + 1], kv.y, part[1]);
        part[2] = fmaf(qr[4 * g + 2], kv.z, part[2]);
        part[3] = fmaf(qr[4 * g + 3], kv.w, part[3]);
      }
      s = ((part[0] + part[1]) + (part[2] + part[3])) * scale;
    }
    if (s > m) {  // the first key always, later ones rarely
      const float c = expf(m - s);
      l *= c;
#pragma unroll
      for (int d = 0; d < Dp; ++d) o[d] *= c;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    float w = p;
    if (kDrop) w *= cursor.at(drop, philox::kAttention, mask_row + j);
    const float* vr = sv + j * Dp;
#pragma unroll
    for (int g = 0; g < D4; ++g) {
      const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * g);
      o[4 * g + 0] = fmaf(w, vv.x, o[4 * g + 0]);
      o[4 * g + 1] = fmaf(w, vv.y, o[4 * g + 1]);
      o[4 * g + 2] = fmaf(w, vv.z, o[4 * g + 2]);
      o[4 * g + 3] = fmaf(w, vv.w, o[4 * g + 3]);
    }
  }
  const float inv = 1.f / l;
  float* orow = out + base + (size_t)row * Dh;
#pragma unroll
  for (int d = 0; d < Dp; ++d)
    if (d < Dh) orow[d] = o[d] * inv;
}

using KernelFn = void (*)(const float*, const float*, const float*, float*, int, int, int,
                          float, philox::Dropout);

#define GAN_ATTN_FWD_ROW(DROP)                                                              \
  {                                                                                         \
    attention_fwd_kernel<1, DROP>, attention_fwd_kernel<2, DROP>,                           \
        attention_fwd_kernel<3, DROP>, attention_fwd_kernel<4, DROP>,                       \
        attention_fwd_kernel<5, DROP>, attention_fwd_kernel<6, DROP>,                       \
        attention_fwd_kernel<7, DROP>, attention_fwd_kernel<8, DROP>,                       \
        attention_fwd_kernel<9, DROP>, attention_fwd_kernel<10, DROP>,                      \
        attention_fwd_kernel<11, DROP>, attention_fwd_kernel<12, DROP>,                     \
        attention_fwd_kernel<13, DROP>, attention_fwd_kernel<14, DROP>,                     \
        attention_fwd_kernel<15, DROP>, attention_fwd_kernel<16, DROP>,                     \
  }

// [dropout][D4 - 1]
const KernelFn kKernels[2][kMaxDim4] = {GAN_ATTN_FWD_ROW(false), GAN_ATTN_FWD_ROW(true)};

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 if the geometry is refused).
int gan_attention_fwd_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxLen || Dh < 1 || Dh > 4 * kMaxDim4) return 0;
  return 2 * L * round_up(Dh, 4) * (int)sizeof(float);
}

// q, k, v, out: (B, H, L, Dh) f32, contiguous, on the current device.
// dropout != 0 applies the attention-weight mask of (seed, threshold,
// drop_scale) (philox.cuh).  Launches on `stream`; returns
// cudaGetLastError() after the launch.
int gan_attention_fwd(const float* q, const float* k, const float* v, float* out,
                      int B, int H, int L, int Dh, int valid_len, float scale,
                      int dropout, unsigned long long seed, unsigned int threshold,
                      float drop_scale, cudaStream_t stream) {
  const int smem = gan_attention_fwd_smem_bytes(L, Dh);
  if (smem == 0 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kKernels[dropout != 0][(Dh + 3) / 4 - 1];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const philox::Dropout drop{seed, threshold, drop_scale};
  kernel<<<B * H, round_up(L, 32), smem, stream>>>(q, k, v, out, L, Dh, valid_len, scale,
                                                   drop);
  return (int)cudaGetLastError();
}

const char* gan_attention_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
