// bf16 helpers for the bf16 kernels: one bf16 mma.sync pass with f32
// accumulation per k step, which is what the TPU's MXU does with bf16
// operands (no 3x split as in f32), the exact sum of those k steps as an
// f32 pair (Acc), and ldmatrix fragment loads, for the attention kernels
// (attention_bf16.cuh); bf16 staging with cp.async, bf16 pair stores and
// dropout mask pairs, for them and the MLP kernels (mlp_bf16_tile.cuh).
//
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fragment layout, with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// each A and B register a pair of bf16, the lower column (A) or row (B) in
// the lower half:
//   A (16 x 16): a0 = A[g][2t, 2t+1],     a1 = A[g+8][2t, 2t+1],
//                a2 = A[g][2t+8, 2t+9],   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):  b0 = B[2t, 2t+1][g],     b1 = B[2t+8, 2t+9][g]
//   C (16 x 8):  c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// C is laid out as in m16n8k8 (mma_tf32.cuh).
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lane l gives the address of
// row l % 8 of matrix l / 8, and each row is 16 bytes, so a shared tile's
// row stride is a multiple of 8 bf16.  A stride of 8 mod 64 bf16 (16 bytes
// mod 128) puts the 8 rows of a matrix in 8 different 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace bf16 {

using bf16_t = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a b: one bf16 product, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi + lo += x, exactly: Knuth's TwoSum puts the rounding error of hi + x,
// itself an f32, into lo (six adds, whatever the order of |hi| and |x|), and
// lo takes it with a seventh.  Rounded adds written out, so that nothing is
// reassociated or contracted.
__device__ __forceinline__ void two_sum(float& hi, float& lo, float x) {
  const float s = __fadd_rn(hi, x);
  const float xs = __fsub_rn(s, hi);  // the part of x that s holds
  const float hs = __fsub_rn(s, xs);  // and the part of hi
  lo = __fadd_rn(lo, __fadd_rn(__fsub_rn(hi, hs), __fsub_rn(x, xs)));
  hi = s;
}

// A sum over k steps of one accumulator tile (the C layout): element e is the
// f32 pair hi[e] + lo[e].  Each k step is one bf16 mma.sync from a zeroed f32
// accumulator, and the steps are added with two_sum, never by the tensor
// cores (which truncate a running sum): the pair carries about 48
// significant bits, so over the few steps of an attention sum (at most 8)
// hi + lo rounded to f32 once is the f32 nearest the exact sum of the
// steps, as an f64 sum of them rounded once is, except where that sum lies
// within about 2^-40 of its terms' magnitude from a rounding midpoint
// (tests/test_torch_attention_bf16_sums.py).  So the result does not depend
// on the order of the k steps, and a plain version that sums the same
// products exactly (ops/attention.py at bf16) rounds to the same bits in all
// but a few outputs in 10^5.  lo starts at +0 and never becomes -0, so a sum
// of zeros rounds to +0, as an f64 sum from +0 does.
struct Acc {
  float hi[4], lo[4];
};

// acc = a b (the first k step) or acc += a b: the k step's bf16 product
// from the tensor cores (f32, from 0), added exactly.  `first` is known once
// the k loop is unrolled.
__device__ __forceinline__ void mma_add(Acc& acc, bool first, const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma(c, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (first) {
      acc.hi[e] = c[e];
      acc.lo[e] = 0.f;
    } else {
      two_sum(acc.hi[e], acc.lo[e], c[e]);
    }
  }
}

// Element e of the sum, rounded to f32 once.
__device__ __forceinline__ float value(const Acc& acc, int e) {
  return __fadd_rn(acc.hi[e], acc.lo[e]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment of s[r0 .. r0 + 15][k0 .. k0 + 15], s row-major ([m][k],
// row stride ld bf16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16_t* s, int ld, int r0, int k0,
                                       int lane) {
  ldmatrix_x4(a, s + (r0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// B fragments of two n tiles, B[k][n] = s[n0 + n][k0 + k] for n in 0 .. 15
// (s stored [n][k], as the keys of Q K^T): b[0], b[1] for columns n0 ..
// n0 + 7, b[2], b[3] for n0 + 8 .. n0 + 15.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16_t* s, int ld, int n0,
                                          int k0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
}

// The B fragment of one n tile, B[k][n] = s[n0 + n][k0 + k] for n in 0 ..
// 7 (s stored [n][k]): b[0], b[1]; lanes 0 .. 15 give the row addresses.
__device__ __forceinline__ void load_b_nk8(uint32_t (&b)[2], const bf16_t* s, int ld, int n0,
                                           int k0, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(s + (n0 + (lane & 7)) * ld + k0 + (((lane >> 3) & 1) << 3))));
}

// B fragments of two n tiles, B[k][n] = s[k0 + k][n0 + n] (s stored [k][n],
// as V in P V and the weights of x W): b[0], b[1] for columns n0 .. n0 + 7,
// b[2], b[3] for n0 + 8 .. n0 + 15.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16_t* s, int ld, int k0,
                                          int n0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
}

// The B fragment of one n tile, B[k][n] = s[k0 + k][n0 + n] for n in 0 ..
// 7 (s stored [k][n]): b[0], b[1]; lanes 0 .. 15 give the row addresses.
__device__ __forceinline__ void load_b_kn8(uint32_t (&b)[2], const bf16_t* s, int ld, int k0,
                                           int n0, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(s + (k0 + (lane & 15)) * ld + n0)));
}

// The A fragment of A[m][k] = s[k][m] for m in m0 .. m0 + 15, k in k0 ..
// k0 + 15 (s stored [k][m], row stride ld): ldmatrix.trans of the four
// 8 x 8 blocks in the order a0 .. a3 wants them.
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16_t* s, int ld, int m0,
                                         int k0, int lane) {
  const int i = lane >> 3;
  ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + ((i >> 1) << 3)) * ld + m0 + ((i & 1) << 3));
}

// Two floats as a bf16 pair (x in the lower half), each rounded to nearest even.
__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- staging --

// Copies W bf16 (W in {2, 4, 8}: 4, 8 or 16 bytes) from global to shared
// memory, or zeros.
template <int W>
__device__ __forceinline__ void cp_async(bf16_t* dst, const bf16_t* src, bool valid) {
  const unsigned d = smem_addr(dst);
  const int n = valid ? 2 * W : 0;
  if (W == 8)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n));
  else if (W == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(n));
}

// Element (r, c) of the kRows x kCols tile at dst (row stride ld) from
// src[(r0 + r) * lds + c0 + c] where r0 + r < r_lim and c0 + c < c_lim, else
// zero; copies of W bf16 (W = 1: plain loads and stores, done on return).
// kCols is a multiple of W; W divides c_lim and lds and the pointer allows it.
template <int W>
__device__ __forceinline__ void load_tile_by(bf16_t* dst, int ld, const bf16_t* __restrict__ src,
                                             int lds, int r0, int r_lim, int c0, int c_lim,
                                             int rows, int cols) {
  const int C = cols / W;
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int r = idx / C, c = W * (idx % C);
    const bool in = r0 + r < r_lim && c0 + c < c_lim;
    const bf16_t* p = in ? src + (size_t)(r0 + r) * lds + c0 + c : src;
    if (W == 1)
      dst[r * ld + c] = in ? *p : __float2bfloat16_rn(0.f);
    else
      cp_async<W>(dst + r * ld + c, p, in);
  }
}

// load_tile_by at the copy width `vec` (8, 4, 2 or 1 bf16).  The caller
// commits, waits and synchronises.
__device__ __forceinline__ void load_tile(bf16_t* dst, int ld, const bf16_t* __restrict__ src,
                                          int lds, int r0, int r_lim, int c0, int c_lim, int rows,
                                          int cols, int vec) {
  if (vec == 8)
    load_tile_by<8>(dst, ld, src, lds, r0, r_lim, c0, c_lim, rows, cols);
  else if (vec == 4)
    load_tile_by<4>(dst, ld, src, lds, r0, r_lim, c0, c_lim, rows, cols);
  else if (vec == 2)
    load_tile_by<2>(dst, ld, src, lds, r0, r_lim, c0, c_lim, rows, cols);
  else
    load_tile_by<1>(dst, ld, src, lds, r0, r_lim, c0, c_lim, rows, cols);
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most `kPending` committed groups are in flight, then syncs the block.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
  __syncthreads();
}

// The copy width (bf16 elements) for load_tile and stores of rows of `width`
// elements: 8 (16 bytes) where width % 8 == 0 and every pointer is 16-byte
// aligned, then 4, 2, else 1 (host side).  A bf16 row of 10 or 100 elements
// is 20 or 200 bytes, so rows take 4- or 8-byte copies.
inline int copy_width(int width, const void* const* ptrs, int n) {
  unsigned long long bits = 0;
  for (int i = 0; i < n; ++i) bits |= (unsigned long long)ptrs[i];
  for (int w = 8; w > 1; w /= 2)
    if (width % w == 0 && (bits & (2 * w - 1)) == 0) return w;
  return 1;
}

// Stores x and y at row[c] and row[c + 1] where they exist (c even): one
// 4-byte store when `pairs` (even width, 4-byte aligned rows), else two.
__device__ __forceinline__ void store_pair(bf16_t* row, int c, int width, bool pairs, float x,
                                           float y) {
  if (c >= width) return;
  if (pairs) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else {
    row[c] = __float2bfloat16_rn(x);
    if (c + 1 < width) row[c + 1] = __float2bfloat16_rn(y);
  }
}

// ---------------------------------------------------------------- dropout --

// Mask values (scale or 0) of flat indices idx and idx + 1 of `stream`: one
// Philox call unless the pair straddles two counter groups.
__device__ __forceinline__ void keep_pair(const philox::Dropout& d, uint32_t stream,
                                          unsigned long long idx, float& k0, float& k1) {
  const uint4 w = philox::bits4(d.seed, stream, idx >> 2);
  const int q = (int)(idx & 3);
  const uint32_t w1 = q < 3 ? philox::word(w, q + 1) : philox::bits4(d.seed, stream, (idx >> 2) + 1).x;
  k0 = philox::keep(d, philox::word(w, q));
  k1 = philox::keep(d, w1);
}

}  // namespace bf16
