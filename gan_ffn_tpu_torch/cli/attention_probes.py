"""Where one block of each attention kernel spends its cycles, on the card.

    python -m gan_ffn_tpu_torch.cli.attention_probes [--label NAME] [--no-probes]

Builds ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` a second time
with ``-DGAN_ATTENTION_PROBES`` (into ``build/probes/``; the kernels' own
libraries are untouched), which makes lane 0 of every warp record
``clock64()`` at the kernels' ``GAN_PROBE(n)`` points.  For each path shape
(B = 32, L = 112; (H, Dh) = (10, 10) and (8, 64)) at dropout rate 0 and 0.1
it prints one JSON line per kernel: block 0's cycles from the first to the
last probe and between consecutive probes (mean and max over its warps),
and, through the ordinary wrappers, the kernel's ms per call at B = 1 and
B = 32 (CUDA events around 10 calls queued behind a device sleep, median of
11).  At B = 1 one block runs alone, so its time is one block's latency.
The timed calls read ``valid_len`` and the seed from device memory, made
once, where the package's kernels take them so (``ops.attention.device_seed``).

``--no-probes`` skips the probed builds and prints the times only.  The
script imports the ``gan_ffn_tpu_torch`` first on ``sys.path``, so with
``--no-probes`` it times another checkout's kernels as
``cli/mlp_profile.py`` does (run it from that checkout's root through
``runpy``; compare in turns: parent, change, change, parent).

Probe phases: forward 0 start, 1 Q and K staged, then per half of 64 keys
(h = 0, 1) 2 + 3h S and keep bits, 3 + 3h softmax, 4 + 3h P V, 8 stored.
Backward 0 start, 1 Q and K staged, 2 S and keep bits, 3 V and dO staged,
4 dP, 5 row max and sum of the warp pair, 6 P and D, 7 dS and dQ, 8 dQ
written, 9 pass 2, 10 dV and dK written.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys

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


def _phases(lib, warps: int, probes: int) -> dict:
    buf = np.zeros((64, 16, 16), dtype=np.int64)
    torch.cuda.synchronize()
    if lib.gan_attention_probes(buf.ctypes.data) != 0:
        raise RuntimeError("reading the probe buffer failed")
    block = buf[0, :warps, :probes].astype(np.float64)
    step = np.diff(block, axis=1)
    return {"cycles": int((block[:, -1] - block[:, 0]).max()),
            "phase_mean": [int(x) for x in step.mean(0)],
            "phase_max": [int(x) for x in step.max(0)]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--label", default="tree", help="a name for this checkout in the output")
    p.add_argument("--no-probes", action="store_true", help="time the kernels only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("attention_probes: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "package": A.__file__}), flush=True)
    if not args.no_probes:
        fwd_lib, bwd_lib = _build_probed("attention_fwd"), _build_probed("attention_bwd")
        fwd, bwd = fwd_lib.gan_attention_fwd, bwd_lib.gan_attention_bwd
        fwd.argtypes, bwd.argtypes = A._FWD_ARGTYPES, A._BWD_ARGTYPES
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for H, Dh in SHAPES:
        for rate in (0.0, 0.1):
            row = {"label": args.label, "H": H, "L": L, "Dh": Dh, "rate": rate}
            for B in (1, 32):
                q, k, v, do = (torch.randn(B, H, L, Dh, device="cuda", generator=gen) for _ in range(4))
                vl, seed = L, 5
                if hasattr(A, "device_seed"):  # in device memory, as these kernels read them
                    vl = torch.full((), L, dtype=torch.int32, device="cuda")
                    seed = A.device_seed(seed, q.device)
                row[f"fwd_ms_B{B}"] = _ms(lambda: A.fused_attention(q, k, v, vl, rate, seed))
                row[f"bwd_ms_B{B}"] = _ms(
                    lambda: A.fused_attention_backward(q, k, v, do, vl, rate, seed))
                if B != 32 or args.no_probes:
                    continue
                args = (B, H, L, Dh, vl.data_ptr(), 1 / math.sqrt(Dh), *A._dropout_args(rate, seed),
                        stream)
                out = torch.empty_like(q)
                grads = [torch.empty_like(q) for _ in range(3)]
                if fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args):
                    raise RuntimeError("probed forward launch failed")
                row["fwd_block0"] = _phases(fwd_lib, warps=7, probes=9)
                if bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                       *(g.data_ptr() for g in grads), *args):
                    raise RuntimeError("probed backward launch failed")
                row["bwd_block0"] = _phases(bwd_lib, warps=14, probes=11)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
