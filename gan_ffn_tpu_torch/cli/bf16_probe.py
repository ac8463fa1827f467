"""How the card sums bf16 products, and what summation order does to a bf16
result, on the card.

    python -m gan_ffn_tpu_torch.cli.bf16_probe

Two measurements, one JSON line each, beside the card's name and power
limit:

- ``mma``: one bf16 ``mma.sync.m16n8k16`` with f32 accumulation from 0 (the
  k step of the bf16 kernels' products) on 40,000 random 16 x 16 by 16 x 8
  tile pairs, against the exact sums (f64): the share of outputs equal to
  the exact sum rounded to the nearest f32, and to it rounded toward zero,
  for operands drawn N(0, 1) and with their scales spread over 2^+-8 and
  2^+-20.  A probe kernel (built with ``nvcc`` into ``build/probes/``, as
  ``cli/attention_probes.py`` builds its variants) runs the instruction.
- ``mlp``: at the four MLP geometries of the serving forward (M = 3584; x
  N(0, 1), weights and biases at torch's default init scale, all rounded to
  bf16), ``ops.mlp.mlp_plain`` at bf16
  (exact sums rounded to f32 once) against the same chain with the
  products summed in f32 by cuBLAS: the share of outputs identical, and
  how many differ by more than 2^-8 * max(1, max |ref|), the limit the
  bf16 kernels are held to.  It shows what two f32 summation orders do to
  a bf16 result, which is why the kernels and their plain versions take
  the sums exactly.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from gan_ffn_tpu_torch.ops import _build
from gan_ffn_tpu_torch.ops import mlp as Mo
from gan_ffn_tpu_torch.utils.runtime import configure_cuda_runtime

PROBE_DIR = _build.BUILD_DIR.parent / "probes"
TILES = 40_000
ROWS = 112 * 32  # the serving forward's MLP rows at L = 112, B = 32
GEOMETRIES = ((100, 2048, 100, "ffn"), (512, 2048, 512, "ffn"), (100, 512, 100, "head"),
              (512, 1024, 100, "head"))
SITES = {"ffn": dict(mid=("relu", "act_first", 0.0)),
         "head": dict(pre=("gelu", 0.0), mid=("gelu", "drop_first", 0.0),
                      post=("gelu", "drop_first", 0.0))}
MMA_PROBE = r"""
#include <cuda_bf16.h>
#include <stdint.h>
__device__ uint32_t pk(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// One m16n8k16 product per warp: A (T, 16, 16) row-major, B (T, 16, 8) [k][n], D (T, 16, 8).
__global__ void probe(const __nv_bfloat16* A, const __nv_bfloat16* B, float* D, int T) {
  const int tile = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (tile >= T) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* a = A + (size_t)tile * 256;
  const __nv_bfloat16* b = B + (size_t)tile * 128;
  const uint32_t a0 = pk(a[g * 16 + 2 * t], a[g * 16 + 2 * t + 1]);
  const uint32_t a1 = pk(a[(g + 8) * 16 + 2 * t], a[(g + 8) * 16 + 2 * t + 1]);
  const uint32_t a2 = pk(a[g * 16 + 2 * t + 8], a[g * 16 + 2 * t + 9]);
  const uint32_t a3 = pk(a[(g + 8) * 16 + 2 * t + 8], a[(g + 8) * 16 + 2 * t + 9]);
  const uint32_t b0 = pk(b[2 * t * 8 + g], b[(2 * t + 1) * 8 + g]);
  const uint32_t b1 = pk(b[(2 * t + 8) * 8 + g], b[(2 * t + 9) * 8 + g]);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  float* o = D + (size_t)tile * 128;
  o[g * 8 + 2 * t] = d[0];
  o[g * 8 + 2 * t + 1] = d[1];
  o[(g + 8) * 8 + 2 * t] = d[2];
  o[(g + 8) * 8 + 2 * t + 1] = d[3];
}
extern "C" int run_probe(const void* A, const void* B, void* D, int T) {
  probe<<<(T + 7) / 8, 256>>>((const __nv_bfloat16*)A, (const __nv_bfloat16*)B, (float*)D, T);
  return (int)cudaDeviceSynchronize();
}
"""


def _probe_library() -> ctypes.CDLL:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src, out = PROBE_DIR / "bf16_mma_probe.cu", PROBE_DIR / "bf16_mma_probe.so"
    src.write_text(MMA_PROBE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of the bf16 mma probe failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    lib.run_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return lib


def _toward_zero(exact: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    f = exact.float()
    over = f.double().abs() > exact.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def mma_rounding() -> dict:
    lib = _probe_library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, spread in (("normal", 0), ("spread_2^8", 8), ("spread_2^20", 20)):
        a = torch.randn(TILES, 16, 16, device="cuda", generator=gen)
        b = torch.randn(TILES, 16, 8, device="cuda", generator=gen)
        if spread:
            a = a * torch.exp2(torch.randint(-spread, spread + 1, a.shape, device="cuda",
                                             generator=gen).float())
        a, b = a.bfloat16().contiguous(), b.bfloat16().contiguous()
        d = torch.empty(TILES, 16, 8, device="cuda")
        code = lib.run_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(), TILES)
        if code != 0:
            raise RuntimeError(f"bf16 mma probe: CUDA error {code}")
        exact = torch.matmul(a.double(), b.double())
        out[name] = {"nearest": (d == exact.float()).double().mean().item(),
                     "toward_zero": (d == _toward_zero(exact)).double().mean().item()}
    return out


def mlp_orders() -> dict:
    """The plain bf16 MLP (exact sums) against the same chain summed in f32."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def uniform(*shape, fan_in):  # torch's default init scale
        return (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * fan_in ** -0.5

    out = {}
    for K, H, N, site in GEOMETRIES:
        x = torch.randn(ROWS, K, device="cuda", generator=gen).bfloat16()
        w1, b1 = uniform(K, H, fan_in=K).bfloat16(), uniform(H, fan_in=K).bfloat16()
        w2, b2 = uniform(H, N, fan_in=H).bfloat16(), uniform(N, fan_in=H).bfloat16()
        cfg = SITES[site]
        exact = Mo.mlp_plain(x, w1, b1, w2, b2, **cfg)
        act = Mo._act
        pre, mid, post = cfg.get("pre"), cfg["mid"], cfg.get("post")
        t1 = act(pre[0] if pre else None, x.float()).bfloat16().float()
        a1 = act(mid[0], t1 @ w1.float() + b1.float()).bfloat16().float()
        f32 = act(post[0] if post else None, a1 @ w2.float() + b2.float()).bfloat16()
        diff = (f32.float() - exact.float()).abs()
        limit = 2.0 ** -8 * max(1.0, exact.float().abs().max().item())
        out[f"{K}->{H}->{N} {site}"] = {"identical": (f32 == exact).double().mean().item(),
                                       "past_limit": int((diff > limit).sum())}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bf16_probe measures the card: no CUDA device")
    configure_cuda_runtime()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    print(json.dumps({"probe": "mma", **mma_rounding()}), flush=True)
    print(json.dumps({"probe": "mlp", **mlp_orders()}), flush=True)


if __name__ == "__main__":
    main()
