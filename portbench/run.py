#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a torch.profiler trace of a few whole epochs.  Every
run checks the probed steps against the plain reference (``correct``) and
ends its standard output with one JSON line; its standard error ends with
each compared number beside its limit.  The run needs as many CUDA cards as
the cell asks for and exits with an error, printing no result, without them,
and also when a module of JAX or of the JAX package is loaded once the
window has closed, when the window captured a graph, when a traced window's
kernel launches differ from the steps' count, or when the cell lists an
end-to-end metric that its entry does not read.
"""

import time

T0 = time.perf_counter()  # set-up counts from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gan_ffn_tpu")
sys.path.insert(0, str(CHECKOUT))

from portbench.lib import RunError  # noqa: E402


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_power() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "clocks.max.sm,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        name, limit, sm, sm_max, temp = (s.strip() for s in out[0].split(","))
        return {"name": name, "power_limit": limit, "clock_sm": sm, "clock_sm_max": sm_max,
                "temperature": temp}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)}


def _merge(base: dict, extra) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell_metrics(bench: dict, cell: str, section: str, moves=None):
    out = []
    for m in bench[section]:
        listed = m.get("workloads")
        if listed is not None and cell not in listed:
            continue
        if listed is None and moves is not None and m["moves"] not in moves:
            continue
        out.append(m)
    return out


def run(argv=None, device="cuda", overrides=None, fault_run=None, log=print) -> dict:
    """One run; returns the result.  ``device="cpu"``, ``overrides`` (of the
    configuration and traffic) and ``fault_run`` (wraps the port's step to plant a
    fault) serve the benchmark's own tests, which drive a run on the CPU."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    seed = args.seed % 2**62

    import torch

    from portbench.lib import checks, harness

    bench = harness.load_bench()
    cell = harness.cell_of(bench, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                           f"torch sees {torch.cuda.device_count()}")
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"
    overrides = overrides or {}
    cfg = _merge(harness.config(cell["config"]), overrides.get("config"))
    traf = _merge(harness.traffic(cell["traffic"]), overrides.get("traffic"))

    from gan_ffn_tpu_torch.utils.runtime import configure_cuda_runtime

    configure_cuda_runtime()  # float32 products stay float32: the configuration's precision
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RunError("TF32 is on; the configurations state float32")
    entry_cls = harness.entry_class(traf["entry"])

    parts = {"imports": time.perf_counter() - T0}
    entry = entry_cls(cfg, traf, seed, device)
    entry.setup(fault_run)
    setup_s = time.perf_counter() - T0
    parts.update(entry.setup_parts)
    win = entry.window(args.seconds, bool(args.trace), fault_run)
    produced = dict(win["e2e"], setup_s=setup_s)
    e2e = cell_metrics(bench, args.workload, "end_to_end")
    missing = [m["name"] for m in e2e if m["name"] not in produced]
    if missing:
        raise RunError(f"the entry {traf['entry']!r} produces no reading of {missing}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    for guard in win["guards"]:
        log(json.dumps(guard), file=sys.stderr)
    entry.free()
    log(json.dumps({"card": card_power() if on_card else {"name": "cpu"}}), file=sys.stderr)

    metrics, result_device = {}, {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        tr, ctx = win["trace"], win["ctx"]
        names = [m["name"] for m in cell_metrics(bench, args.workload, "per_layer",
                                                 moves={m["name"] for m in e2e})]
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in harness.per_layer(names, ctx).items()}
        result_device.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {m["name"]: {"value": produced[m["name"]], "unit": m["unit"]} for m in e2e}

    t_ref = time.perf_counter()
    values = entry.readings()
    log(json.dumps({"setup_s": setup_s, "setup_parts": parts,
                    "reference_s": time.perf_counter() - t_ref}), file=sys.stderr)
    judged = checks.judge(values, cfg["limits"])
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: {found}")
    result = {"correct": all(j["ok"] for j in judged) and win["failed"] == 0,
              "attempted": win["attempted"], "failed": win["failed"], "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {j["name"]: {"value": j["value"], "limit": j["limit"]} for j in judged}
    for j in judged:
        log(f"check {j['name']} {j['value']!r} limit {j['limit']!r} "
            f"{'ok' if j['ok'] else 'FAILED'}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    try:
        result = run(argv)
    except RunError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
