// Counter-based dropout masks for the port's kernels: Philox4x32-10.
//
// Replaces the TPU kernels' on-core PRNG (pltpu.prng_seed /
// prng_random_bits in gan_ffn_tpu/ops/attention.py::_dropout_scale), which
// cannot be reproduced off the TPU.  The plain twin is
// gan_ffn_tpu_torch/ops/dropout.py; both define one stream:
//
//   bits(seed, stream, idx) = word idx % 4 of
//       Philox4x32-10(counter = (idx / 4 lo, idx / 4 hi, stream, 0),
//                     key     = (seed lo, seed hi))
//
// where idx is the element's flat index in the tensor the mask covers, so a
// mask never depends on the block or thread layout, and the forward and the
// backward kernel regenerate it bit for bit.  Keep iff bits >= threshold,
// threshold = min(floor(rate * 2^32), 2^32 - 1); a kept element is scaled by
// `scale` = 1 / (1 - rate).  The host computes threshold and scale.
//
// A kernel reads its seed from device memory (SeedRef), so that one CUDA
// graph replays with fresh masks: a 63-bit base per train step, and the
// call's index k within the step, fixed when the call is recorded.  The
// call's seed is
//
//   seed(base, k) = (y & 0x7fffffff) << 32 | x, where (x, y, ., .) =
//       Philox4x32-10(counter = (k, 0, kDerive, 0), key = (base lo, base hi))
//
// and k < 0 takes the base itself as the seed (a caller's host seed).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key increments

enum Stream : uint32_t { kAttention = 0, kPre = 1, kMid = 2, kPost = 3, kDerive = 4 };

// One dropout site: seed, threshold on the 32 bits, scale of a kept element.
struct Dropout {
  unsigned long long seed;
  uint32_t threshold;
  float scale;
};

// Where a call's seed lives: the step's base in device memory and the
// call's index k (k < 0: the base is the seed).
struct SeedRef {
  const unsigned long long* base;
  int index;
};

// One dropout site as a kernel takes it: the seed still in device memory.
struct DropoutArg {
  SeedRef seed;
  uint32_t threshold;
  float scale;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// The four words of counter group `group` (elements 4 * group .. 4 * group + 3).
__device__ __forceinline__ uint4 bits4(unsigned long long seed, uint32_t stream,
                                       unsigned long long group) {
  return philox4x32_10(make_uint4((uint32_t)group, (uint32_t)(group >> 32), stream, 0u),
                       (uint32_t)seed, (uint32_t)(seed >> 32));
}

// The seed of the call `s` refers to (see the top of this file).
__device__ __forceinline__ unsigned long long resolve(SeedRef s) {
  const unsigned long long b = __ldg(s.base);
  if (s.index < 0) return b;
  const uint4 w = philox4x32_10(make_uint4((uint32_t)s.index, 0u, kDerive, 0u), (uint32_t)b,
                                (uint32_t)(b >> 32));
  return (unsigned long long)(w.y & 0x7fffffffu) << 32 | w.x;
}

__device__ __forceinline__ Dropout resolve(const DropoutArg& a) {
  return Dropout{resolve(a.seed), a.threshold, a.scale};
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

__device__ __forceinline__ float keep(const Dropout& d, uint32_t bits) {
  return bits >= d.threshold ? d.scale : 0.f;
}

// Mask value (scale or 0) of element idx.
__device__ __forceinline__ float keep_scale(const Dropout& d, uint32_t stream,
                                            unsigned long long idx) {
  return keep(d, word(bits4(d.seed, stream, idx >> 2), (int)(idx & 3)));
}

// Mask values of elements idx0 .. idx0 + 3: one Philox call when they share
// a counter group, four otherwise.
__device__ __forceinline__ void keep_scale4(const Dropout& d, uint32_t stream,
                                            unsigned long long idx0, float (&ks)[4]) {
  if ((idx0 & 3) == 0) {
    const uint4 w = bits4(d.seed, stream, idx0 >> 2);
    ks[0] = keep(d, w.x);
    ks[1] = keep(d, w.y);
    ks[2] = keep(d, w.z);
    ks[3] = keep(d, w.w);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) ks[e] = keep_scale(d, stream, idx0 + e);
  }
}

}  // namespace philox
