"""Compare the bf16 kernels of this checkout with another checkout's, bit for
bit, on the card.

    python -m gan_ffn_tpu_torch.cli.kernel_bits --other build/parent

``--other`` is the root of another checkout (e.g. the parent commit unpacked
with ``git archive``).  Its ``attention_fwd_bf16.cu``, ``mlp_fwd_bf16.cu``,
``attention_bwd_bf16.cu`` and ``mlp_bwd_bf16.cu`` are built with this
checkout's flags into ``build/other_kernels/`` and called through this
checkout's wrappers (the C entries' arguments are the same; each library's
own workspace function sizes its workspace), on chip_smoke.py's inputs: the
forwards on phase 8's (attention (32,10,112,10) and (32,8,112,64) at
valid_len 112/90/1/0, the MLP at M=3584 for the four path geometries), the
backwards on phase 9's (dq, dk and dv at those shapes and at B=30; dx, dW1,
db1, dW2 and db2 at M=3584 and 3360 for the four geometries), each at rate 0
and the path's rate.  Prints one JSON line: for each kernel the outputs
compared and how many differ in their bits.  A refactor that keeps the
arithmetic gives 0.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as A
from ..ops import mlp as M
from ..utils.runtime import configure_cuda_runtime

ATTN = ((32, 10, 112, 10), (32, 8, 112, 64))
ATTN_B30 = ((30, 10, 112, 10), (30, 8, 112, 64))  # the DialogueRNN path's (phase 9)
MLP = ((100, 2048, 100, "ffn"), (512, 2048, 512, "ffn"), (100, 512, 100, "head"),
       (512, 1024, 100, "head"))
RATE = {"attention": 0.1, "ffn": 0.1, "head": 0.2}
MLP_ROWS = (112 * 32, 112 * 30)  # phase 9's: the flagship's and the DialogueRNN's M
RELU_KINK = 2e-5  # no FFN z1 of mlp_inputs this close to relu's kink


def mlp_inputs(gen, M, K, H, N, site):
    """``(x, w1, b1, w2, b2)`` and ``dout`` of an MLP comparison at ``M``
    rows on the card, drawn from ``gen`` with torch's default init scales;
    for the relu FFN, no z1 within RELU_KINK of relu's kink, where a plain
    version summing in another order may take the other branch of relu'
    (chip_smoke.py draws its MLP inputs here)."""
    x = torch.randn(M, K, device="cuda", generator=gen)
    w1 = (torch.rand(K, H, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
    b1 = (torch.rand(H, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
    w2 = (torch.rand(H, N, device="cuda", generator=gen) * 2 - 1) * H ** -0.5
    b2 = (torch.rand(N, device="cuda", generator=gen) * 2 - 1) * H ** -0.5
    dout = torch.randn(M, N, device="cuda", generator=gen)
    while site == "ffn":
        near = ((x.double() @ w1.double() + b1.double()).abs() < RELU_KINK).any(1)
        if not near.any():
            break
        x[near] = torch.randn(int(near.sum().item()), K, device="cuda", generator=gen)
    return (x, w1, b1, w2, b2), dout


def _chain(site: str, rate: float) -> dict:
    if site == "ffn":
        return dict(mid=("relu", "act_first", rate))
    return dict(pre=("gelu", rate), mid=("gelu", "drop_first", rate),
                post=("gelu", "drop_first", rate))


def outputs() -> dict:
    """The bf16 kernels' outputs on fixed inputs, by kernel, in a fixed order."""
    out = {"attention_fwd_bf16": [], "mlp_fwd_bf16": [], "attention_bwd_bf16": [],
           "mlp_bwd_bf16": []}
    gen = torch.Generator(device="cuda").manual_seed(8)
    for B, H, L, Dh in ATTN:
        q, k, v = (torch.randn(B, H, L, Dh, device="cuda", generator=gen).bfloat16()
                   for _ in range(3))
        for rate in (0.0, RATE["attention"]):
            for vl in (L, 90, 1, 0):
                out["attention_fwd_bf16"].append(A.fused_attention(
                    q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=4000 + vl))
    rows = 112 * 32
    for K, H, N, site in MLP:
        x = torch.randn(rows, K, device="cuda", generator=gen).bfloat16()
        w1 = ((torch.rand(K, H, device="cuda", generator=gen) * 2 - 1) * K ** -0.5).bfloat16()
        b1 = ((torch.rand(H, device="cuda", generator=gen) * 2 - 1) * K ** -0.5).bfloat16()
        w2 = ((torch.rand(H, N, device="cuda", generator=gen) * 2 - 1) * H ** -0.5).bfloat16()
        b2 = ((torch.rand(N, device="cuda", generator=gen) * 2 - 1) * H ** -0.5).bfloat16()
        for rate in (0.0, RATE[site]):
            out["mlp_fwd_bf16"].append(M.fused_mlp(x, w1, b1, w2, b2, **_chain(site, rate),
                                                   dropout_seed=5000 + K + N))
    gen = torch.Generator(device="cuda").manual_seed(10)
    for B, H, L, Dh in ATTN + ATTN_B30:
        q, k, v, dout = (torch.randn(B, H, L, Dh, device="cuda", generator=gen).bfloat16()
                         for _ in range(4))
        for rate in (0.0, RATE["attention"]):
            for vl in (L, 90, 1, 0):
                out["attention_bwd_bf16"].extend(A.fused_attention_backward(
                    q, k, v, dout, vl, rate, 6000 + vl))
    gen = torch.Generator(device="cuda").manual_seed(11)
    for rows in MLP_ROWS:
        for K, H, N, site in MLP:
            args32, dout32 = mlp_inputs(gen, rows, K, H, N, site)
            args, dout = [t.bfloat16() for t in args32], dout32.bfloat16()
            for rate in (0.0, RATE[site]):
                out["mlp_bwd_bf16"].extend(M.fused_mlp_backward(
                    *args, dout, **_chain(site, rate), dropout_seed=7000 + K + N))
    torch.cuda.synchronize()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="the root of the other checkout")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA card: the kernels run only on the card")
    configure_cuda_runtime()
    mine = outputs()
    csrc, build = _build.CSRC, _build.BUILD_DIR
    try:
        _build.CSRC = Path(args.other).resolve() / "gan_ffn_tpu_torch" / "csrc"
        _build.BUILD_DIR = build.parent / "other_kernels"
        _build._functions.clear()
        theirs = outputs()
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build
        _build._functions.clear()
    res = {"card": torch.cuda.get_device_name(0)}
    for name in mine:
        differ = [int((a.view(torch.int16) != b.view(torch.int16)).sum().item())
                  for a, b in zip(mine[name], theirs[name])]
        res[name] = {"calls": len(differ), "outputs": sum(a.numel() for a in mine[name]),
                     "differing_bits": sum(differ), "calls_that_differ": sum(d > 0 for d in differ),
                     "differing_by_call": differ}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
