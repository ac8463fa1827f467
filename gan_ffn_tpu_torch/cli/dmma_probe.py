"""What the card's f64 tensor cores do with the bf16 MLP kernels' work, on the
card.

    python -m gan_ffn_tpu_torch.cli.dmma_probe [--no-probes] [--sass [LIBRARY ...]]

Three measurements, one JSON line each, beside the card's name and power
limit, from a probe library built with ``nvcc`` into ``build/probes/`` (as
``cli/bf16_probe.py`` builds its probe):

- ``layout``: one ``mma.sync`` of each f64 shape (m8n8k4, m16n8k4, m16n8k8,
  m16n8k16) on small whole numbers, its fragments placed as
  ``csrc/mlp_bf16_tile.cuh`` places them, against the exact product: 0
  outputs may differ.
- ``rate``: TFLOP/s of each shape over a warp tile of 32 x 32 outputs (the
  bf16 MLP kernels'), 4 warps a block and 1, 2 or 4 blocks an SM, with the
  operands (a) in registers, unchanged; (b) read as bf16 pairs from shared
  memory each k step and converted through f32 (``F2F``, as the kernels'
  ``mlp_bf16::f64_of`` does); (c) the same, converted by integer bit
  arithmetic (``via_int``, the bias added to the exponent); (d) as (c)
  for normal numbers and zeros only (what subnormals, inf and NaN cost).
  The f64 tensor cores' dense peak on an H100 SXM is 67 TFLOP/s.
- ``order``: how one m16n8k16 (and one m8n8k4) sums its k products: on
  random tiles of bf16 values whose scales spread over 2^+-40, the share of
  outputs equal to the exact sum rounded to f64 once, and to the products
  added one by one in ascending k order (f64), from a zero accumulator.

``--sass`` also prints, for each library named (default: the bf16 MLP
libraries built under ``build/kernels/``), each kernel's SASS instruction
counts by opcode (``cuobjdump -sass``): DMMA, F2F, I2F, LDS, LDSM and the
rest.  ``--no-probes`` skips the three measurements.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from gan_ffn_tpu_torch.ops import _build

PROBE_DIR = _build.BUILD_DIR.parent / "probes"
PEAK_F64_TENSOR = 67e12  # H100 SXM, dense f64 tensor cores
SHAPES = {884: (8, 8, 4), 1684: (16, 8, 4), 1688: (16, 8, 8), 16816: (16, 8, 16)}
CONVS = {0: "registers", 1: "f2f", 2: "integer", 3: "integer_normal_only"}
PROBE = r"""
#include <cuda_bf16.h>
#include <stdint.h>

template <int S> struct Shape;
template <> struct Shape<884> { static constexpr int M = 8, N = 8, K = 4, NA = 1, NB = 1, NC = 2; };
template <> struct Shape<1684> { static constexpr int M = 16, N = 8, K = 4, NA = 2, NB = 1, NC = 4; };
template <> struct Shape<1688> { static constexpr int M = 16, N = 8, K = 8, NA = 4, NB = 2, NC = 4; };
template <> struct Shape<16816> { static constexpr int M = 16, N = 8, K = 16, NA = 8, NB = 4, NC = 4; };

template <int S>
__device__ __forceinline__ void mma(double* d, const double* a, const double* b);
template <> __device__ __forceinline__ void mma<884>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1},{%2},{%3},{%0,%1};"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<1684>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5},{%6},{%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<1688>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<16816>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},"
               "{%4,%5,%6,%7,%8,%9,%10,%11},{%12,%13,%14,%15},{%0,%1,%2,%3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                 "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Fragment coordinates (g = lane / 4, t = lane % 4), as assumed by the kernels:
// A: a_i = A[g + 8 (i % 2)][t + 4 (i / 2)] (m16), A[g][t] (m8);
// B: b_i = B[t + 4 i][g];  C: c_i = C[g + 8 (i / 2)][2 t + i % 2].
template <int S> __device__ int a_row(int g, int i) { return Shape<S>::M == 16 ? g + 8 * (i % 2) : g; }
template <int S> __device__ int a_col(int t, int i) { return Shape<S>::M == 16 ? t + 4 * (i / 2) : t; }

template <int S>
__global__ void layout_kernel(const double* A, const double* B, double* D) {
  using P = Shape<S>;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[P::NA], b[P::NB], d[P::NC];
  for (int i = 0; i < P::NA; ++i) a[i] = A[a_row<S>(g, i) * P::K + a_col<S>(t, i)];
  for (int i = 0; i < P::NB; ++i) b[i] = B[(t + 4 * i) * P::N + g];
  for (int i = 0; i < P::NC; ++i) d[i] = 0.0;
  mma<S>(d, a, b);
  for (int i = 0; i < P::NC; ++i) D[(g + 8 * (i / 2)) * P::N + 2 * t + (i % 2)] = d[i];
}

// One mma per tile from a zero accumulator: A (T, M, K), B (T, K, N), D (T, M, N).
template <int S>
__global__ void order_kernel(const double* A, const double* B, double* D, int T) {
  using P = Shape<S>;
  const int tile = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (tile >= T) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double* At = A + (size_t)tile * P::M * P::K;
  const double* Bt = B + (size_t)tile * P::K * P::N;
  double a[P::NA], b[P::NB], d[P::NC];
  for (int i = 0; i < P::NA; ++i) a[i] = At[a_row<S>(g, i) * P::K + a_col<S>(t, i)];
  for (int i = 0; i < P::NB; ++i) b[i] = Bt[(t + 4 * i) * P::N + g];
  for (int i = 0; i < P::NC; ++i) d[i] = 0.0;
  mma<S>(d, a, b);
  double* Dt = D + (size_t)tile * P::M * P::N;
  for (int i = 0; i < P::NC; ++i) Dt[(g + 8 * (i / 2)) * P::N + 2 * t + (i % 2)] = d[i];
}

__device__ __forceinline__ double via_f32(uint32_t bits16) {
  return (double)__uint_as_float(bits16 << 16);
}
// bf16 -> f64 by integer bit arithmetic, exact for every bf16: the bias
// 896 added to the exponent, 1792 for inf and NaN; subnormals made normal
// through one f32 multiply by 2^64 (tests/test_torch_mlp_bf16_sums.py).
__device__ __forceinline__ double via_int(uint32_t bits16) {
  const uint32_t x = bits16 << 16, mag = x << 1;
  uint32_t h = (uint32_t)((int32_t)x >> 3) & 0x8fffffffu;
  if (mag >= 0x01000000u) {
    h += mag >= 0xff000000u ? 0x70000000u : 0x38000000u;
  } else if (mag != 0u) {
    const uint32_t y = __float_as_uint(__uint_as_float(x) * 0x1p64f);
    h = ((uint32_t)((int32_t)y >> 3) & 0x8fffffffu) + (0x38000000u - (64u << 20));
  }
  return __hiloint2double((int)h, 0);
}
// The same for normal numbers and zeros only: what the special cases cost.
__device__ __forceinline__ double via_int_normal(uint32_t bits16) {
  const uint32_t x = bits16 << 16;
  uint32_t h = (uint32_t)((int)x >> 3) & 0x8fffffffu;
  h = (x << 1) ? h + 0x38000000u : h;
  return __hiloint2double((int)h, 0);
}

// Throughput: each warp owns a 32 x 32 tile of outputs (32 / M x 4 mma
// tiles) and runs `iters` k steps of the shape; CONV 0 keeps the operands in
// registers, 1 and 2 read bf16 pairs from shared memory every step and
// convert them (1: through f32, 2: integer bits).
template <int S, int CONV>
__global__ void __launch_bounds__(128) rate_kernel(double* out, int iters) {
  using P = Shape<S>;
  constexpr int MT = 32 / P::M, NT = 4;
  constexpr int NAV = MT * P::NA, NBV = NT * P::NB, PAIRS = (NAV + NBV) / 2;
  __shared__ uint32_t src[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) {
    const uint32_t h = (i * 2654435761u) ^ (blockIdx.x * 40503u);
    src[i] = ((0x3f00u + (h & 0x7fu)) | ((0x3e80u + ((h >> 8) & 0xffu)) << 16)) ^ ((h >> 20) & 0x80008000u);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  double acc[MT][NT][P::NC];
  for (int x = 0; x < MT; ++x)
    for (int y = 0; y < NT; ++y)
      for (int c = 0; c < P::NC; ++c) acc[x][y][c] = 0.0;
  double a[MT][P::NA], b[NT][P::NB];
  for (int x = 0; x < MT; ++x)
    for (int i = 0; i < P::NA; ++i) a[x][i] = 1.0 + (lane + x + i) * 0x1p-10;
  for (int y = 0; y < NT; ++y)
    for (int i = 0; i < P::NB; ++i) b[y][i] = 1.0 - (lane + y + i) * 0x1p-10;
  for (int it = 0; it < iters; ++it) {
    if (CONV != 0) {
      uint32_t w[PAIRS];
      const int base = (it * 37 + lane * PAIRS) & 2047;
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) w[p] = src[(base + p) & 2047];
#pragma unroll
      for (int v = 0; v < NAV + NBV; ++v) {
        const uint32_t bits = (v & 1) ? w[v / 2] >> 16 : w[v / 2] & 0xffffu;
        const double f = CONV == 1 ? via_f32(bits) : CONV == 2 ? via_int(bits) : via_int_normal(bits);
        if (v < NAV) a[v / P::NA][v % P::NA] = f;
        else b[(v - NAV) / P::NB][(v - NAV) % P::NB] = f;
      }
    }
#pragma unroll
    for (int x = 0; x < MT; ++x)
#pragma unroll
      for (int y = 0; y < NT; ++y) mma<S>(acc[x][y], a[x], b[y]);
  }
  double s = 0.0;
  for (int x = 0; x < MT; ++x)
    for (int y = 0; y < NT; ++y)
      for (int c = 0; c < P::NC; ++c) s += acc[x][y][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int S>
int layout(const double* A, const double* B, double* D) {
  layout_kernel<S><<<1, 32>>>(A, B, D);
  return (int)cudaDeviceSynchronize();
}

template <int S>
int order(const double* A, const double* B, double* D, int T) {
  order_kernel<S><<<(T + 7) / 8, 256>>>(A, B, D, T);
  return (int)cudaDeviceSynchronize();
}

template <int S, int CONV>
float rate(double* out, int blocks, int iters) {
  rate_kernel<S, CONV><<<blocks, 128>>>(out, iters);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate_kernel<S, CONV><<<blocks, 128>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = -1.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}

#define SHAPE_CASES(F, ...) \
  switch (shape) { case 884: return F<884>(__VA_ARGS__); case 1684: return F<1684>(__VA_ARGS__); \
  case 1688: return F<1688>(__VA_ARGS__); case 16816: return F<16816>(__VA_ARGS__); }

extern "C" {
int run_layout(int shape, const void* A, const void* B, void* D) {
  SHAPE_CASES(layout, (const double*)A, (const double*)B, (double*)D);
  return -1;
}
int run_order(int shape, const void* A, const void* B, void* D, int T) {
  SHAPE_CASES(order, (const double*)A, (const double*)B, (double*)D, T);
  return -1;
}
float run_rate(int shape, int conv, void* out, int blocks, int iters) {
#define RATE(S) \
  if (shape == S) return conv == 0 ? rate<S, 0>((double*)out, blocks, iters) \
                       : conv == 1 ? rate<S, 1>((double*)out, blocks, iters) \
                       : conv == 2 ? rate<S, 2>((double*)out, blocks, iters) \
                                   : rate<S, 3>((double*)out, blocks, iters);
  RATE(884) RATE(1684) RATE(1688) RATE(16816)
  return -1.f;
}
}
"""


def _library() -> ctypes.CDLL:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src, out = PROBE_DIR / "dmma_probe.cu", PROBE_DIR / "dmma_probe.so"
    src.write_text(PROBE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of the f64 mma probe failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    lib.run_layout.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.run_order.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.run_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int]
    lib.run_rate.restype = ctypes.c_float
    resources = _build.ptxas_resources(proc.stdout)
    return lib, resources


def layouts(lib) -> dict:
    rng = np.random.default_rng(3)
    out = {}
    for shape, (M, N, K) in SHAPES.items():
        a = rng.integers(-8, 9, (M, K)).astype(np.float64)
        b = rng.integers(-8, 9, (K, N)).astype(np.float64)
        A, B = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        D = torch.full((M, N), float("nan"), dtype=torch.float64, device="cuda")
        code = lib.run_layout(shape, A.data_ptr(), B.data_ptr(), D.data_ptr())
        got = D.cpu().numpy()
        out[f"m{M}n{N}k{K}"] = {"cuda_error": code, "differ": int((got != a @ b).sum()),
                                "outputs": M * N}
        if out[f"m{M}n{N}k{K}"]["differ"]:
            out[f"m{M}n{N}k{K}"]["got"] = got.tolist()
    return out


def rates(lib) -> dict:
    out_buf = torch.empty(132 * 4 * 128, dtype=torch.float64, device="cuda")
    res = {}
    for shape, (M, N, K) in SHAPES.items():
        iters = max(256, 4096 * 16 // K)
        mmas = (32 // M) * 4
        for conv, name in CONVS.items():
            for per_sm in (1, 2, 4):
                blocks = 132 * per_sm
                ms = lib.run_rate(shape, conv, out_buf.data_ptr(), blocks, iters)
                flops = blocks * 4 * iters * mmas * 2 * M * N * K
                res[f"m{M}n{N}k{K} {name} {per_sm}/SM"] = (
                    round(flops / (ms * 1e-3) / 1e12, 2) if ms > 0 else "failed")
    return res


def _bf16_spread(rng, shape, spread):
    """bf16-exact values N(0, 1) with scales 2^[-spread, spread]."""
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-spread, spread + 1, shape))
    return torch.from_numpy(v.astype(np.float32)).bfloat16().double().numpy()


def orders(lib, tiles: int = 256) -> dict:
    rng = np.random.default_rng(5)
    out = {}
    for shape in (884, 16816):
        M, N, K = SHAPES[shape]
        a, b = _bf16_spread(rng, (tiles, M, K), 40), _bf16_spread(rng, (tiles, K, N), 40)
        A, B = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        D = torch.empty(tiles, M, N, dtype=torch.float64, device="cuda")
        code = lib.run_order(shape, A.data_ptr(), B.data_ptr(), D.data_ptr(), tiles)
        got = D.cpu().numpy()
        prods = a[:, :, :, None] * b[:, None, :, :]  # (T, M, K, N), each exact in f64
        seq = np.zeros((tiles, M, N))
        for k in range(K):
            seq = seq + prods[:, :, k, :]
        exact = np.empty_like(seq)
        for idx in np.ndindex(tiles, M, N):
            terms = prods[idx[0], idx[1], :, idx[2]]
            exact[idx] = float(sum(Fraction(float(p)) for p in terms))
        out[f"m{M}n{N}k{K}"] = {"cuda_error": code, "outputs": got.size,
                                "exact_rounded_once": float((got == exact).mean()),
                                "ascending_k": float((got == seq).mean())}
    return out


_SASS_FN = re.compile(r"^\s*Function : (\S+)")
_SASS_OP = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?")


def sass_counts(lib_path: Path) -> dict:
    """Kernel (mangled name) -> {opcode: count} of a library's SASS."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        from torch.utils.cpp_extension import CUDA_HOME

        tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out: dict = {}
    current = None
    for line in text.splitlines():
        if m := _SASS_FN.match(line):
            current = out.setdefault(m.group(1), collections.Counter())
        elif current is not None and (m := _SASS_OP.match(line)):
            op = m.group(1)
            if op in ("F2F", "I2F", "F2I", "DMMA", "LDS", "LDSM", "STS", "LDG", "LDGSTS"):
                op += m.group(2) or ""
            current[op] += 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in out.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sass", nargs="*", default=None, metavar="LIBRARY",
                   help="print these libraries' SASS instruction counts (default: "
                        "build/kernels/mlp_*_bf16-*.so)")
    p.add_argument("--no-probes", action="store_true", help="skip the measurements")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dmma_probe measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    if not args.no_probes:
        lib, resources = _library()
        print(json.dumps({"probe": "resources", "kernels": resources}), flush=True)
        print(json.dumps({"probe": "layout", **layouts(lib)}), flush=True)
        print(json.dumps({"probe": "rate", "tflops": rates(lib)}), flush=True)
        print(json.dumps({"probe": "order", **orders(lib)}), flush=True)
    if args.sass is not None:
        libs = args.sass or sorted(str(p) for p in _build.BUILD_DIR.glob("mlp_*_bf16-*.so"))
        for path in libs:
            print(json.dumps({"probe": "sass", "library": Path(path).name,
                              "kernels": sass_counts(Path(path))}), flush=True)


if __name__ == "__main__":
    main()
