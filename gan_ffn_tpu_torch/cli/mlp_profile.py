"""Time the MLP kernels (``csrc/mlp_fwd.cu``, ``csrc/mlp_bwd.cu``, or with
``--dtype bf16`` their bf16 twins ``csrc/mlp_fwd_bf16.cu``,
``csrc/mlp_bwd_bf16.cu``) on the card, launch by launch.

    python -m gan_ffn_tpu_torch.cli.mlp_profile [--label NAME] [--dtype f32|bf16]

For each MLP geometry of the training path (M = 3584 rows; 100->2048->100
and 512->2048->512 encoder FFNs, 100->512->100 and 512->1024->100 generator
heads), at dropout rate 0 and at the path's rate (FFN 0.1, head 0.2), prints
one JSON line per kernel: ``fused_mlp``'s or ``fused_mlp_backward``'s ms per
call (CUDA events around 5 calls queued behind a device sleep, median of 11,
L2-warm) and, from ``torch.profiler``, each kernel launch of one call in
launch order with its device microseconds (median over 5 calls).  Where the
package reports them (``ops.mlp.fwd_launch``, ``ops.mlp.bwd_launches``),
the launches' blocks, chunks and the workspace bytes are printed too.  The
first line names the card and its power limit.

The script imports the ``gan_ffn_tpu_torch`` that is first on ``sys.path``,
so one process can time another checkout's kernels: run it from that
checkout's root with ``python -c "import runpy, sys; sys.path.insert(0, '.');
runpy.run_path('<this file>', run_name='__main__')" --label parent``, and
compare two versions in turns (parent, change, change, parent) in one call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

GEOMETRIES = ((100, 2048, 100, "ffn"), (512, 2048, 512, "ffn"), (100, 512, 100, "head"),
              (512, 1024, 100, "head"))
SITE_RATE = {"ffn": 0.1, "head": 0.2}
ROWS = 3584


def site_cfg(site: str, rate: float) -> dict:
    if site == "ffn":
        return dict(mid=("relu", "act_first", rate))
    return dict(pre=("gelu", rate), mid=("gelu", "drop_first", rate),
                post=("gelu", "drop_first", rate))


def ms_per_call(fn, reps: int = 11, group: int = 5) -> float:
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


def launches(fn, calls: int = 5) -> list:
    """[(kernel name, device us)] of one ``fn()`` call, in launch order,
    each the median over ``calls`` profiled calls; where the trace holds
    other kernels too, each name's device us summed over the trace and
    divided by ``calls`` instead, in first-launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)

    def short(e):
        return e.name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]

    if not kernels:
        return [{"profiler": "no device events"}]
    if len(kernels) % calls:
        total: dict = {}
        for e in kernels:
            total[short(e)] = total.get(short(e), 0.0) + e.time_range.elapsed_us()
        return [{"kernel": k, "us": v / calls, "summed": True} for k, v in total.items()]
    per = len(kernels) // calls
    return [{"kernel": short(kernels[i]),
             "us": statistics.median(kernels[c * per + i].time_range.elapsed_us()
                                     for c in range(calls))} for i in range(per)]


def vs_plain(M, kernel, args, dout, cfg, seed) -> list:
    """Per output of one bf16 call: max |kernel - plain| / max(1, max |plain|)
    and the share of identical elements (+0 and -0 as one)."""
    if kernel == "fwd":
        got, want = [M.fused_mlp(*args, **cfg, dropout_seed=seed)], [M.mlp_plain(
            *args, **cfg, dropout_seed=seed)]
    else:
        got = M.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)
        want = M.mlp_backward_plain(*args, dout, **cfg, dropout_seed=seed)
    return [{"max_rel_err": (g.float() - w.float()).abs().max().item()
             / max(1.0, w.float().abs().max().item()),
             "identical": (g == w).double().mean().item()} for g, w in zip(got, want)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--label", default="tree", help="a name for this checkout in the output")
    p.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                   help="the kernels' operand dtype (bf16: the bf16 twins)")
    args = p.parse_args(argv)
    bf16 = args.dtype == "bf16"
    if not torch.cuda.is_available():
        sys.exit("mlp_profile: no CUDA card")
    from gan_ffn_tpu_torch.ops import _build
    from gan_ffn_tpu_torch.ops import mlp as M
    from gan_ffn_tpu_torch.utils.runtime import configure_cuda_runtime

    configure_cuda_runtime()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "package": M.__file__}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for K, H, N, site in GEOMETRIES:
        x = torch.randn(ROWS, K, device="cuda", generator=gen)
        w1 = (torch.rand(K, H, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
        b1 = (torch.rand(H, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
        w2 = (torch.rand(H, N, device="cuda", generator=gen) * 2 - 1) * H ** -0.5
        b2 = (torch.rand(N, device="cuda", generator=gen) * 2 - 1) * H ** -0.5
        dout = torch.randn(ROWS, N, device="cuda", generator=gen)
        if bf16:
            x, w1, b1, w2, b2, dout = (t.bfloat16() for t in (x, w1, b1, w2, b2, dout))
        for rate in (0.0, SITE_RATE[site]):
            cfg, seed = site_cfg(site, rate), 2000 + K + N
            if hasattr(M, "device_seed"):  # the seed in device memory, as the kernels read it
                seed = M.device_seed(seed, x.device)
            for kernel in ("fwd", "bwd"):
                if kernel == "fwd":
                    fn = lambda: M.fused_mlp(  # noqa: E731
                        x, w1, b1, w2, b2, **cfg, dropout_seed=seed)
                else:
                    fn = lambda: M.fused_mlp_backward(x, w1, b1, w2, b2, dout, **cfg,  # noqa: E731
                                                      dropout_seed=seed)
                row = {"label": args.label, "dtype": args.dtype, "kernel": kernel, "M": ROWS,
                       "K": K, "H": H, "N": N, "site": site, "rate": rate, "ms": ms_per_call(fn),
                       "launches": launches(fn)}
                if bf16:  # against the plain version, as chip_smoke.py phases 8 and 9 hold it
                    row["vs_plain"] = vs_plain(M, kernel, (x, w1, b1, w2, b2), dout, cfg, seed)
                if kernel == "fwd" and bf16 and hasattr(M, "fwd_bf16_launch"):
                    row["launch"] = M.fwd_bf16_launch(ROWS, K, H, N)
                    row["workspace_bytes"] = 4 * M.fwd_bf16_workspace_floats(ROWS, K, H, N)
                elif kernel == "fwd" and hasattr(M, "fwd_launch"):
                    row["launch"] = M.fwd_launch(ROWS, K, H, N)
                    row["workspace_bytes"] = 4 * M.fwd_workspace_floats(ROWS, K, H, N)
                if kernel == "bwd" and bf16:
                    row["split_launches"] = M.bwd_bf16_launches(ROWS, K, H, N)
                    row["workspace_bytes"] = 8 * M.bwd_bf16_workspace_doubles(ROWS, K, H, N)
                elif kernel == "bwd" and hasattr(M, "bwd_launches"):
                    row["split_launches"] = M.bwd_launches(ROWS, K, H, N)
                    row["workspace_bytes"] = 4 * M.bwd_workspace_floats(ROWS, K, H, N)
                print(json.dumps(row), flush=True)
    print(json.dumps({"label": args.label, "resources": {
        name: _build.ptxas_resources(log) for name, log in _build.build_logs.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
