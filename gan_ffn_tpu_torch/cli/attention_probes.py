"""Where one block of each attention kernel spends its cycles, on the card.

    python -m gan_ffn_tpu_torch.cli.attention_probes [--label NAME] [--no-probes]
        [--dtype f32|bf16|both]
    python -m gan_ffn_tpu_torch.cli.attention_probes --insert-probes ROOT

Builds ``csrc/attention_{fwd,bwd}.cu`` and their bf16 twins
``csrc/attention_{fwd,bwd}_bf16.cu`` a second time with
``-DGAN_ATTENTION_PROBES`` (into ``build/probes/``; the kernels' own
libraries are untouched), which makes lane 0 of every warp record
``clock64()`` at the kernels' ``GAN_PROBE(n)`` points.  For each path shape
(B = 32, L = 112; (H, Dh) = (10, 10) and (8, 64)) at dropout rate 0 and 0.1
and each dtype it prints one JSON line: for each kernel at B = 1 and B =
32, block 0's cycles from the first to the last probe and between
consecutive probes (mean and max over its warps), and, through the ordinary
wrappers, the kernel's ms per call at B = 1 and B = 32 (CUDA events around 10 calls queued behind a
device sleep, median of 11).  At B = 1 one block runs alone, so its time is
one block's latency.  The timed calls read ``valid_len`` and the seed from
device memory, made once, where the package's kernels take them so
(``ops.attention.device_seed``).

``--no-probes`` skips the probed builds and prints the times only.  The
script imports the ``gan_ffn_tpu_torch`` first on ``sys.path``, and builds
that package's sources, so it times (and, where its sources carry the
probes, probes) another checkout's kernels as ``cli/mlp_profile.py`` does
(run it from that checkout's root through ``runpy``; compare in turns:
parent, change, change, parent).

Probe phases, f32: forward 0 start, 1 Q and K staged, then per half of 64
keys (h = 0, 1) 2 + 3h S and keep bits, 3 + 3h softmax, 4 + 3h P V, 8
stored.  Backward 0 start, 1 Q and K staged, 2 S and keep bits, 3 V and dO
staged, 4 dP, 5 row max and sum of the warp pair, 6 P and D, 7 dS and dQ,
8 dQ written, 9 pass 2, 10 dV and dK written.  bf16 (both kernels compute
the weights through ``csrc/attention_bf16.cuh``): 0 start, 1 Q and K
staged, 2 S and keep bits, 3 softmax (row max and sum of the warp pair);
forward 4 bf16(P M) staged and V in, 5 P V stored; backward 4 V and dO in,
5 dP and the warp's half of D, 6 D of the pair, 7 A and dS staged (block
barrier), 8 dQ, 9 dV, 10 dK stored.

``--insert-probes ROOT`` writes those bf16 probe points into the bf16
attention sources of the checkout at ROOT whose kernels run one warp per 16
rows (the design these replaced, which has no probes), at the same phases,
and exits; then run this script from ROOT to probe it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gan_ffn_tpu_torch.ops import _build
from gan_ffn_tpu_torch.ops import attention as A

SHAPES = ((10, 10), (8, 64))  # (H, Dh) at L = 112
L = 112
PROBE_DIR = _build.BUILD_DIR.parent / "probes"


def _build_probed(name: str) -> ctypes.CDLL:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    out = PROBE_DIR / f"{name}-probes.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DGAN_ATTENTION_PROBES", "-o", str(out),
         str(_build.sources()[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} with probes failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    lib.gan_attention_probes.argtypes = [ctypes.c_void_p]
    return lib


def _ms(fn, reps: int = 11, group: int = 10) -> float:
    for _ in range(3):
        fn()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(group):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / group)
    return statistics.median(samples)


def _phases(lib, probes: int) -> dict:
    """Block 0's probes: the warps that recorded probe 0, each from its
    first probe to probe ``probes - 1``."""
    buf = np.zeros((64, 16, 16), dtype=np.int64)
    torch.cuda.synchronize()
    if lib.gan_attention_probes(buf.ctypes.data) != 0:
        raise RuntimeError("reading the probe buffer failed")
    warps = int((buf[0, :, 0] != 0).sum())
    block = buf[0, :warps, :probes].astype(np.float64)
    step = np.diff(block, axis=1)
    return {"warps": warps, "cycles": int((block[:, -1] - block[:, 0]).max()),
            "phase_mean": [int(x) for x in step.mean(0)],
            "phase_max": [int(x) for x in step.max(0)]}


# probes per kernel: the last probe's number + 1
PROBES = {"attention_fwd": 9, "attention_bwd": 11, "attention_fwd_bf16": 6,
          "attention_bwd_bf16": 11}


# GAN_PROBE points of the bf16 phases for the one-warp-per-16-rows bf16
# kernels: (file, the line to follow, the probe), each line found once
_ONE_WARP_PROBES = (
    ("attention_bf16.cuh", "  // scale and mask (uniform", 2, "before"),
    ("attention_bf16.cuh",
     "    for (int e = 0; e < 4; ++e) s[n][e] = __fdiv_rn(s[n][e], e < 2 ? sum0 : sum1);\n  }",
     3, "after"),
    ("attention_fwd_bf16.cu", "  extern __shared__ __align__(16) unsigned char smem_raw[];", 0,
     "after"),
    ("attention_fwd_bf16.cu", "  bf16::wait<1>();", 1, "after"),
    ("attention_fwd_bf16.cu", "  bf16::wait<0>();  // V is in", 4, "after"),
    ("attention_fwd_bf16.cu", "(float)o[x][2], (float)o[x][3]);\n    }\n  }", 5, "after"),
    ("attention_bwd_bf16.cu", "  extern __shared__ __align__(16) unsigned char smem_raw[];", 0,
     "after"),
    ("attention_bwd_bf16.cu", "  bf16::wait<1>();", 1, "after"),
    ("attention_bwd_bf16.cu", "  bf16::wait<0>();  // V and dO are in", 4, "after"),
    ("attention_bwd_bf16.cu",
     "  const float d0 = (float)quad_sum(D0), d1 = (float)quad_sum(D1);", 5, "before"),
    ("attention_bwd_bf16.cu",
     "  const float d0 = (float)quad_sum(D0), d1 = (float)quad_sum(D1);", 6, "after"),
    ("attention_bwd_bf16.cu", "  __syncthreads();  // every row's A and dS are in", 7, "after"),
    ("attention_bwd_bf16.cu", "sds, lw, sk, ld, r0, steps, L, Dh, pairs, lane);", 8, "after"),
    ("attention_bwd_bf16.cu", "sa, lw, sdo, ld, r0, steps, L, Dh, pairs, lane);", 9, "after"),
    ("attention_bwd_bf16.cu", "sds, lw, sq, ld, r0, steps, L, Dh, pairs, lane);", 10, "after"),
)


def insert_probes(root: str) -> None:
    """Write the bf16 phases' GAN_PROBE points into the one-warp-per-16-rows
    bf16 attention sources under ``root`` (see the module's docstring)."""
    from pathlib import Path

    csrc = Path(root) / "gan_ffn_tpu_torch" / "csrc"
    for name in {name for name, *_ in _ONE_WARP_PROBES}:
        if "GAN_PROBE(" in (csrc / name).read_text():
            sys.exit(f"attention_probes: {csrc / name} has probe points already")
    for name, anchor, n, where in _ONE_WARP_PROBES:
        path = csrc / name
        text = path.read_text()
        if text.count(anchor) != 1:
            sys.exit(f"attention_probes: {path} is not the one-warp design: {anchor!r}")
        probe = f"  GAN_PROBE({n});\n"
        line_end = text.index(anchor) + len(anchor) + 1  # past the anchor's newline
        line_start = text.rindex("\n", 0, text.index(anchor)) + 1
        at = line_end if where == "after" else line_start
        path.write_text(text[:at] + probe + text[at:])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--insert-probes", metavar="ROOT",
                   help="write the bf16 probe points into the one-warp sources under ROOT, exit")
    p.add_argument("--label", default="tree", help="a name for this checkout in the output")
    p.add_argument("--no-probes", action="store_true", help="time the kernels only")
    p.add_argument("--dtype", choices=("f32", "bf16", "both"), default="both")
    args = p.parse_args(argv)
    if args.insert_probes:
        insert_probes(args.insert_probes)
        return
    if not torch.cuda.is_available():
        sys.exit("attention_probes: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "package": A.__file__}), flush=True)
    dtypes = {"f32": (torch.float32,), "bf16": (torch.bfloat16,),
              "both": (torch.float32, torch.bfloat16)}[args.dtype]
    probed = {}
    if not args.no_probes:
        names = {(dtype, kind): f"attention_{kind}{'_bf16' if dtype == torch.bfloat16 else ''}"
                 for dtype in dtypes for kind in ("fwd", "bwd")}
        with ThreadPoolExecutor(len(names)) as pool:  # one nvcc each, all at once
            libs = dict(zip(names, pool.map(_build_probed, names.values())))
        for (dtype, kind), lib in libs.items():
            fn = getattr(lib, f"gan_{names[dtype, kind]}")
            fn.argtypes = A._FWD_ARGTYPES if kind == "fwd" else A._BWD_ARGTYPES
            probed[(dtype, kind)] = (names[dtype, kind], lib, fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for H, Dh in SHAPES:
        for rate in (0.0, 0.1):
            for dtype in dtypes:
                row = {"label": args.label, "dtype": str(dtype).replace("torch.", ""), "H": H,
                       "L": L, "Dh": Dh, "rate": rate}
                for B in (1, 32):
                    q, k, v, do = (torch.randn(B, H, L, Dh, device="cuda", generator=gen).to(dtype)
                                   for _ in range(4))
                    vl, seed = L, 5
                    if hasattr(A, "device_seed"):  # in device memory, as these kernels read them
                        vl = torch.full((), L, dtype=torch.int32, device="cuda")
                        seed = A.device_seed(seed, q.device)
                    row[f"fwd_ms_B{B}"] = _ms(lambda: A.fused_attention(q, k, v, vl, rate, seed))
                    row[f"bwd_ms_B{B}"] = _ms(
                        lambda: A.fused_attention_backward(q, k, v, do, vl, rate, seed))
                    if not probed:
                        continue
                    call = (B, H, L, Dh, vl.data_ptr(), 1 / math.sqrt(Dh),
                            *A._dropout_args(rate, seed), stream)
                    name, lib, fwd = probed[(dtype, "fwd")]
                    out = torch.empty_like(q)
                    if fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *call):
                        raise RuntimeError("probed forward launch failed")
                    row[f"fwd_block0_B{B}"] = _phases(lib, PROBES[name])
                    name, lib, bwd = probed[(dtype, "bwd")]
                    grads = [torch.empty_like(q) for _ in range(3)]
                    if bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                           *(g.data_ptr() for g in grads), *call):
                        raise RuntimeError("probed backward launch failed")
                    row[f"bwd_block0_B{B}"] = _phases(lib, PROBES[name])
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
