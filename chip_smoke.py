#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gan_ffn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device   -- the card's name and power limit (nvidia-smi) and torch's view.
2. build    -- nvcc builds every kernel under gan_ffn_tpu_torch/csrc.
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the serving path's shapes (B=32, L=112 bucket):
               attention (32,10,112,10) and (32,8,112,64) at valid_len
               112/90/1/0, max |diff| <= 1e-5; MLP at M=3584 rows for the four
               K->H->N geometries, max |diff| <= 1e-4 * max(1, max |ref|).
               Times: CUDA events around 10 back-to-back calls queued behind
               a device sleep (so host launch cost is hidden), median of 21,
               L2-warm; plain_ms for the plain version, library_ms for
               F.scaled_dot_product_attention (attention only; the port never
               calls it).  bound_ms = max(bytes / 3.35 TB/s, flops / 67 TFLOP/s
               f32 non-tensor), the H100 SXM data-sheet peaks.
4. serving  -- a full-width 8-layer GAN_FFN (random weights from a fixed
               seed) exported and loaded by ServingClassifier on the card,
               answering HTTP POST /predict requests through the cli/serve.py
               handler and direct log_probs calls; every forward must launch
               the attention kernel 24 times and the MLP kernel 27 times; card
               log-probs agree with the CPU path (plain versions) within 1e-3.
               Prints ms/request and utterances/s at L=112, B=32, and the
               forward's device time (CUDA events, launches hidden) beside
               its host time with the inputs on the card (enqueue, and
               enqueue plus wait).

The line before the last is the ``kernels`` summary (times per forward at
B=32, L=112); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_TOL = 1e-5
MLP_TOL = 1e-4
E2E_TOL = 1e-3
GRID = (1, 4, 8, 32)
# (B, H, L, Dh) -> attention launches per forward at B=32, L=112
ATTN_SHAPES = {(32, 10, 112, 10): 16, (32, 8, 112, 64): 8}
# (K, H, N, site) -> MLP launches per forward at M = 112 * 32 rows
MLP_SHAPES = {
    (100, 2048, 100, "ffn"): 16,
    (512, 2048, 512, "ffn"): 8,
    (100, 512, 100, "head"): 2,
    (512, 1024, 100, "head"): 1,
}
MLP_ROWS = 112 * 32
SITE_CFG = {
    "ffn": dict(mid=("relu", "act_first", 0.0)),
    "head": dict(pre=("gelu", 0.0), mid=("gelu", "drop_first", 0.0),
                 post=("gelu", "drop_first", 0.0)),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_time_ms(torch, fn, reps: int = 21, group: int = 10) -> float:
    """Median device ms of one ``fn()`` call: events around ``group`` calls
    queued behind a device sleep, so that host launch cost stays hidden."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device time to queue behind
        start.record()
        for _ in range(group):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / group)
    return statistics.median(samples)


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card to run on")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    info = {
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "capability": list(torch.cuda.get_device_capability(0)),
    }
    emit(info)
    return info


def phase_build():
    from gan_ffn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    secs = time.perf_counter() - t0
    if set(libs) != {"attention_fwd", "mlp_fwd"}:
        fail(f"expected the attention_fwd and mlp_fwd kernels, built {sorted(libs)}")
    emit({"phase": "build", "seconds": secs, "libraries": {k: str(v.relative_to(REPO)) for k, v in libs.items()}})


def phase_kernels(torch):
    import torch.nn.functional as F

    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as M

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_forward = {"attention_fwd": [], "mlp_fwd": []}
    errs = {"attention_fwd": 0.0, "mlp_fwd": 0.0}

    for (B, H, L, Dh), count in ATTN_SHAPES.items():
        q, k, v = (torch.randn(B, H, L, Dh, device="cuda", generator=gen) for _ in range(3))
        for vl in (L, 90, 1, 0):
            got = A.fused_attention(q, k, v, valid_len=vl)
            torch.cuda.synchronize()
            want = A.attention_plain(q, k, v, vl)
            err = (got - want).abs().max().item()
            if not err <= ATTN_TOL:
                fail(f"attention {(B, H, L, Dh)} valid_len={vl}: max |diff| {err} > {ATTN_TOL}")
            errs["attention_fwd"] = max(errs["attention_fwd"], err)
            if vl != L:
                emit({"phase": "kernel", "name": "attention_fwd", "shape": [B, H, L, Dh],
                      "valid_len": vl, "max_abs_err": err})
                continue
            mask = torch.arange(L, device="cuda") < vl
            row = {
                "ms": device_time_ms(torch, lambda: A.fused_attention(q, k, v, valid_len=vl)),
                "plain_ms": device_time_ms(torch, lambda: A.attention_plain(q, k, v, vl)),
                "library_ms": device_time_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            }
            row["bound_ms"], row["bound_by"] = bound_ms(
                4 * 4 * B * H * L * Dh, 2 * 2 * B * H * L * L * Dh)
            per_forward["attention_fwd"].append((count, row))
            emit({"phase": "kernel", "name": "attention_fwd", "shape": [B, H, L, Dh],
                  "valid_len": vl, "max_abs_err": err, "launches_per_forward": count, **row})

    for (K, Hd, N, site), count in MLP_SHAPES.items():
        x = torch.randn(MLP_ROWS, K, device="cuda", generator=gen)
        w1 = (torch.rand(K, Hd, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
        b1 = (torch.rand(Hd, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
        w2 = (torch.rand(Hd, N, device="cuda", generator=gen) * 2 - 1) * Hd ** -0.5
        b2 = (torch.rand(N, device="cuda", generator=gen) * 2 - 1) * Hd ** -0.5
        cfg = SITE_CFG[site]
        got = M.fused_mlp(x, w1, b1, w2, b2, **cfg)
        torch.cuda.synchronize()
        want = M.mlp_plain(x, w1, b1, w2, b2, **cfg)
        err = (got - want).abs().max().item()
        tol = MLP_TOL * max(1.0, want.abs().max().item())
        if not err <= tol:
            fail(f"mlp {K}->{Hd}->{N} ({site}): max |diff| {err} > {tol}")
        errs["mlp_fwd"] = max(errs["mlp_fwd"], err)
        row = {
            "ms": device_time_ms(torch, lambda: M.fused_mlp(x, w1, b1, w2, b2, **cfg)),
            "plain_ms": device_time_ms(torch, lambda: M.mlp_plain(x, w1, b1, w2, b2, **cfg)),
            "library_ms": None,
        }
        row["bound_ms"], row["bound_by"] = bound_ms(
            4 * (MLP_ROWS * K + K * Hd + Hd + Hd * N + N + MLP_ROWS * N),
            2 * MLP_ROWS * (K * Hd + Hd * N))
        per_forward["mlp_fwd"].append((count, row))
        emit({"phase": "kernel", "name": "mlp_fwd", "shape": [MLP_ROWS, K, Hd, N], "site": site,
              "max_abs_err": err, "tolerance": tol, "launches_per_forward": count, **row})
    return per_forward, errs


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.load(resp)


def phase_serving(torch):
    from http.server import ThreadingHTTPServer

    from gan_ffn_tpu_torch.cli.serve import make_handler
    from gan_ffn_tpu_torch.models import GAN_FFN
    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as M
    from gan_ffn_tpu_torch.serving import ServingClassifier, export_classifier

    rng = np.random.default_rng(0)

    def request(L, B):
        return [rng.standard_normal((L, B, d)).astype(np.float32) for d in (100, 512, 100)]

    def check_lp(lp, L, B, what):
        if lp.shape != (L, B, 6) or not np.isfinite(lp).all():
            fail(f"{what}: log-probs of shape {lp.shape}, finite={np.isfinite(lp).all()}")
        if not np.allclose(np.exp(lp).sum(-1), 1.0, atol=1e-4):
            fail(f"{what}: probabilities do not sum to 1")

    model = GAN_FFN(n_classes=6, D_h=100, gen_num_layers=8,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gan_ffn.pt")
        export_classifier(model, path)
        clf = ServingClassifier.load(path, device="cuda", batch_grid=GRID)
        cpu = ServingClassifier.load(path, device="cpu", batch_grid=GRID)
    warm = clf.warmup()

    launches = []  # (attention, mlp) launches of each forward of the main path
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(clf))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"
    A.fused_attention.launches = 0
    M.fused_mlp.launches = 0
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.load(resp)
        if health["status"] != "ok" or health["device"] != "cuda":
            fail(f"healthz: {health}")
        for L, B, vl in ((20, 2, None), (57, 1, 50)):
            a, v, t = request(L, B)
            before = (A.fused_attention.launches, M.fused_mlp.launches)
            body = {"audio": a.tolist(), "visual": v.tolist(), "text": t.tolist()}
            if vl is not None:
                body["valid_len"] = vl
            resp = _post(f"{url}/predict", body)
            launches.append((A.fused_attention.launches - before[0], M.fused_mlp.launches - before[1]))
            if len(resp["classes"]) != B or any(len(r) != L for r in resp["classes"]):
                fail(f"POST /predict (L={L}, B={B}): classes {resp['classes']}")
            if any(n not in clf.label_names for r in resp["class_names"] for n in r):
                fail(f"POST /predict: unknown class names {resp['class_names']}")
        for L, B in ((110, 32), (64, 8), (33, 1)):
            before = (A.fused_attention.launches, M.fused_mlp.launches)
            check_lp(clf.log_probs(*request(L, B)), L, B, f"log_probs L={L} B={B}")
            launches.append((A.fused_attention.launches - before[0], M.fused_mlp.launches - before[1]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    counts = {"attention_fwd": A.fused_attention.launches, "mlp_fwd": M.fused_mlp.launches}
    if any(n != (24, 27) for n in launches):
        fail(f"launches per forward (attention, mlp) were {launches}, expected (24, 27) each")

    xs = request(64, 4)
    card, host = clf.log_probs(*xs), cpu.log_probs(*xs)
    check_lp(card, 64, 4, "card log_probs L=64 B=4")
    e2e_err = float(np.abs(card - host).max())
    if not e2e_err <= E2E_TOL:
        fail(f"card vs CPU log-probs at L=64, B=4: max |diff| {e2e_err} > {E2E_TOL}")
    agree = float((card.argmax(-1) == host.argmax(-1)).mean())

    xs = request(112, 32)
    for _ in range(3):
        clf.log_probs(*xs)
    req_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        clf.log_probs(*xs)
        req_ms.append((time.perf_counter() - t0) * 1e3)
    dev = [torch.from_numpy(x).cuda() for x in xs]
    enqueue_ms, host_ms = [], []  # host clock, inputs already on the card
    with torch.inference_mode():
        fwd_ms = device_time_ms(torch, lambda: clf.model(*dev, valid_len=112), reps=7, group=3)
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clf.model(*dev, valid_len=112)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue_ms.append((t1 - t0) * 1e3)
            host_ms.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(req_ms)
    emit({
        "phase": "serving", "layers": 8, "widths": {"audio": 100, "visual": 512, "text": 100, "D_h": 100},
        "warmup_shapes": [[L, B] for L, B, _ in warm],
        "http_requests": 2, "direct_requests": 3, "launches_per_forward": launches,
        "card_vs_cpu_max_abs_err": e2e_err, "card_vs_cpu_argmax_agreement": agree,
        "request_ms_L112_B32": ms, "request_ms_min": min(req_ms),
        "utterances_per_s": 112 * 32 / (ms / 1e3), "forward_device_ms_L112_B32": fwd_ms,
        "forward_host_ms_L112_B32": statistics.median(host_ms),
        "forward_enqueue_ms_L112_B32": statistics.median(enqueue_ms),
    })
    return counts, fwd_ms


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card to run on")
    if not os.path.isdir(os.path.join(REPO, "gan_ffn_tpu_torch", "csrc")):
        fail(f"gan_ffn_tpu_torch/ not found beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device(torch)
    phase_build()
    per_forward, errs = phase_kernels(torch)
    counts, fwd_ms = phase_serving(torch)

    sources = {"attention_fwd": ("gan_ffn_tpu_torch/csrc/attention_fwd.cu", "gan_ffn_tpu/ops/attention.py:69"),
               "mlp_fwd": ("gan_ffn_tpu_torch/csrc/mlp_fwd.cu", "gan_ffn_tpu/ops/mlp.py:134")}
    kernels = []
    for name, rows in per_forward.items():
        total = lambda key: sum(n * r[key] for n, r in rows)  # noqa: E731
        lib = [r["library_ms"] for _, r in rows]
        ms = total("ms")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": ms, "kernel_ms": ms, "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(rows, key=lambda nr: nr[0] * nr[1]["bound_ms"])[1]["bound_by"],
            "library_ms": None if None in lib else total("library_ms"),
            "per": "one forward at B=32, L=112: launches_per_forward calls at the shapes above",
            "launches_per_forward": sum(n for n, _ in rows),
            "share_of_forward": ms / fwd_ms,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})


if __name__ == "__main__":
    main()
