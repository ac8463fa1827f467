// Tensor-core helpers for the attention kernels: f32-accurate products from
// TF32 mma.sync (the 3xTF32 split), fragment loads from shared memory, quad
// reductions, cp.async staging, and dropout masks in the fragment layout.
//
// mma.sync.m16n8k8 (tf32 in, f32 accumulate) fragment layout, with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k8"):
//   A (16 x 8):  a0 = A[g][t],    a1 = A[g + 8][t],  a2 = A[g][t + 4],  a3 = A[g + 8][t + 4]
//   B (8 x 8):   b0 = B[t][g],    b1 = B[t + 4][g]
//   C (16 x 8):  c0 = C[g][2t],   c1 = C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]
//
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest, ties away (cvt.rna; inputs are finite); a * b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
// the small products accumulated first.  The dropped a_lo b_lo and the
// rounding of lo leave a relative error near 2^-21 per product, where one
// TF32 pass leaves 2^-11 (tests/test_torch_attention_tf32.py emulates both).
//
// An accumulator tile is reused as an A operand without a shuffle by
// permuting the k order of the product: k slot t stands for column 2t and
// slot t + 4 for column 2t + 1 (acc_as_a), and the B operand is read in the
// same order (load_b_pairs).
//
// Shared-memory tiles keep a row stride of Dp + 4 floats (Dp in {16, 32, 64}):
// load_a / load_b_rows then hit 32 different banks (stride = 4 or 20 mod 32),
// and load_b_pairs too (2 * stride = 8 mod 32).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

// Phase probes, read by scripts/attention_probes.py: built with
// -DGAN_ATTENTION_PROBES, lane 0 of each warp of the first 64 blocks records
// clock64() at probe n (< 16); otherwise GAN_PROBE compiles to nothing.
#ifdef GAN_ATTENTION_PROBES
__device__ long long gan_probe_clock[64][16][16];
#define GAN_PROBE(n)                                                          \
  do {                                                                        \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < 64)                           \
      gan_probe_clock[blockIdx.x][threadIdx.x >> 5][n] = clock64();          \
  } while (0)
extern "C" int gan_attention_probes(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gan_probe_clock, sizeof(gan_probe_clock));
}
#else
#define GAN_PROBE(n) ((void)0)
#endif

namespace tf32 {

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// Round to TF32, nearest with ties away from zero, as cvt.rna.tf32.f32 does
// for finite x (the low 13 bits cleared): integer add and mask issue at full
// rate where the conversion unit would not.
__device__ __forceinline__ uint32_t rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(__float_as_uint(x));
  lo = rna(__float_as_uint(x - __uint_as_float(hi)));
}

__device__ __forceinline__ FragA make_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in f32 accuracy (3xTF32, small products first).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// A = s[r0 .. r0 + 15][k0 .. k0 + 7], s row-major with row stride ld.
__device__ __forceinline__ FragA load_a(const float* s, int ld, int r0, int k0, int g, int t) {
  const float* p = s + (r0 + g) * ld + k0 + t;
  return make_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// B[k][n] = s[n0 + n][k0 + k]: the rows of s are B's columns (K in Q K^T).
__device__ __forceinline__ FragB load_b_rows(const float* s, int ld, int n0, int k0, int g,
                                             int t) {
  const float* p = s + (n0 + g) * ld + k0 + t;
  return make_b(p[0], p[4]);
}

// B[k][n] = s[k0 + k][n0 + n] in the permuted k order of acc_as_a.
__device__ __forceinline__ FragB load_b_pairs(const float* s, int ld, int k0, int n0, int g,
                                              int t) {
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  return make_b(p[0], p[ld]);
}

// An accumulator tile (c0..c3) as the A operand, k order permuted.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return make_a(c[0], c[2], c[1], c[3]);
}

// Max and sum over the four lanes that share a row (fixed order).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// kDt accumulator tiles of rows r0 .. r0 + 15 to a shared tile (row stride ld).
template <int kDt>
__device__ __forceinline__ void acc_store(float* s, int ld, int r0, const float (&acc)[kDt][4],
                                          int g, int t) {
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    *reinterpret_cast<float2*>(s + (r0 + g) * ld + 8 * d + 2 * t) = make_float2(acc[d][0], acc[d][1]);
    *reinterpret_cast<float2*>(s + (r0 + g + 8) * ld + 8 * d + 2 * t) =
        make_float2(acc[d][2], acc[d][3]);
  }
}

// acc = acc + (the tile acc_store wrote), in that order.
template <int kDt>
__device__ __forceinline__ void acc_add(const float* s, int ld, int r0, float (&acc)[kDt][4],
                                        int g, int t) {
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    const float2 a = *reinterpret_cast<const float2*>(s + (r0 + g) * ld + 8 * d + 2 * t);
    const float2 b = *reinterpret_cast<const float2*>(s + (r0 + g + 8) * ld + 8 * d + 2 * t);
    acc[d][0] += a.x;
    acc[d][1] += a.y;
    acc[d][2] += b.x;
    acc[d][3] += b.y;
  }
}

// Columns c and c + 1 (c even) of a row to global memory, where they exist:
// one 8-byte store when `pairs` (Dh even, row 8-byte aligned), else two.
__device__ __forceinline__ void store_pair(float* row, int c, int Dh, bool in_rows, bool pairs,
                                           float x, float y) {
  if (!in_rows || c >= Dh) return;
  if (pairs) {
    *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
  } else {
    row[c] = x;
    if (c + 1 < Dh) row[c + 1] = y;
  }
}

// ---------------------------------------------------------------- staging --

// Copies W floats (W in {1, 2, 4}) from global to shared memory, or zeros.
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 * W : 0;
  if (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n));
  else if (W == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(n));
}

template <int Dp, int W>
__device__ __forceinline__ void stage_by(float* dst, const float* __restrict__ src, int L, int Lp,
                                         int Dh) {
  constexpr int ld = Dp + 4, C = Dp / W;
  for (int idx = threadIdx.x; idx < Lp * C; idx += blockDim.x) {
    const int r = idx / C, c = W * (idx % C);
    const bool in = r < L && c < Dh;
    cp_async<W>(dst + r * ld + c, in ? src + (size_t)r * Dh + c : src, in);
  }
}

// Starts copying the (L, Dh) row-major slab `src` into the (Lp, Dp) tile
// `dst` (row stride Dp + 4), zero-filling rows >= L and columns >= Dh, in
// copies of `vec` floats: 4 where Dh % 4 == 0 and the slab is 16-byte
// aligned, 2 where Dh is even and it is 8-byte aligned, else 1.  The caller
// commits, waits and synchronises.
template <int Dp>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int L, int Lp,
                                      int Dh, int vec) {
  if (vec == 4)
    stage_by<Dp, 4>(dst, src, L, Lp, Dh);
  else if (vec == 2)
    stage_by<Dp, 2>(dst, src, L, Lp, Dh);
  else
    stage_by<Dp, 1>(dst, src, L, Lp, Dh);
}

__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most `kPending` committed groups are in flight, then syncs the block.
template <int kPending>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
  __syncthreads();
}

// The copy width for stage() and store_pair(): 4, 2 or 1 floats, from Dh and
// the alignment of every slab pointer (host side).
inline int stage_width(int Dh, const void* const* ptrs, int n) {
  unsigned long long bits = 0;
  for (int i = 0; i < n; ++i) bits |= (unsigned long long)ptrs[i];
  if (Dh % 4 == 0 && (bits & 15) == 0) return 4;
  if (Dh % 2 == 0 && (bits & 7) == 0) return 2;
  return 1;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory and asks for the
// largest shared-memory carveout, so that as many blocks as fit share an SM.
template <class Kernel>
inline cudaError_t configure(Kernel kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// ---------------------------------------------------------------- dropout --

// Keep bits (bit 0: idx, bit 1: idx + 1) of flat indices idx and idx + 1:
// one Philox call unless the pair straddles two counter groups.
__device__ __forceinline__ uint32_t keep_pair(const philox::Dropout& d, unsigned long long idx) {
  const uint4 w = philox::bits4(d.seed, philox::kAttention, idx >> 2);
  const int q = (int)(idx & 3);
  const uint32_t w1 = q < 3 ? philox::word(w, q + 1)
                            : philox::bits4(d.seed, philox::kAttention, (idx >> 2) + 1).x;
  return (uint32_t)(philox::word(w, q) >= d.threshold) | (uint32_t)(w1 >= d.threshold) << 1;
}

// tile_keep where L % 4 != 0: a pair may straddle two counter groups.  Out
// of line, so that the draw sites, unrolled per tile, each carry one Philox
// call and not five.
__device__ __noinline__ uint32_t tile_keep_unaligned(philox::Dropout d, unsigned long long row_g,
                                                     unsigned long long row_g8, int n0, int t) {
  return keep_pair(d, row_g + n0 + 2 * t) | keep_pair(d, row_g8 + n0 + 2 * t) << 2;
}

// Keep bits of an accumulator tile whose element (r, c) has flat index
// row_r + n0 + c, for rows r = g (flat start row_g) and g + 8 (row_g8):
// bit e for element e of {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
// aligned: every row start + n0 is a multiple of 4 (L % 4 == 0), so lanes t
// and t ^ 1 need the same two counter groups and draw one each.  All 32
// lanes must call.
__device__ __forceinline__ uint32_t tile_keep(const philox::Dropout& d, unsigned long long row_g,
                                              unsigned long long row_g8, int n0, int t,
                                              bool aligned) {
  if (aligned) {
    const bool odd = t & 1;
    const unsigned long long start = (odd ? row_g8 : row_g) + n0 + 4 * (t >> 1);
    const uint4 w = philox::bits4(d.seed, philox::kAttention, start >> 2);
    // even lanes keep words 0, 1 of row g and pass 2, 3 on; odd lanes the
    // words 2, 3 of row g + 8 and pass 0, 1 on
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
    const uint32_t k0 = odd ? r0 : w.x, k1 = odd ? r1 : w.y;
    const uint32_t k2 = odd ? w.z : r0, k3 = odd ? w.w : r1;
    return (uint32_t)(k0 >= d.threshold) | (uint32_t)(k1 >= d.threshold) << 1 |
           (uint32_t)(k2 >= d.threshold) << 2 | (uint32_t)(k3 >= d.threshold) << 3;
  }
  return tile_keep_unaligned(d, row_g, row_g8, n0, t);
}

// The bytes of rows g and g + 8 of a tile's keep bits (bit c: column c),
// gathered over the four lanes of a row: (row g) | (row g + 8) << 8.
__device__ __forceinline__ uint32_t tile_keep_rows(uint32_t bits, int t) {
  uint32_t v = ((bits & 3u) | (bits >> 2 & 3u) << 8) << (2 * t);
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  return v | __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace tf32
