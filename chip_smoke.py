#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gan_ffn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device   -- the card's name and power limit (nvidia-smi) and torch's view.
2. build    -- nvcc builds every kernel under gan_ffn_tpu_torch/csrc (four
               libraries: attention_fwd, attention_bwd, mlp_fwd, mlp_bwd),
               one process each, all at once; prints each library's nvcc
               seconds and each kernel's registers and spill bytes.
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the training path's shapes (B=32, L=112 bucket): attention
               (32,10,112,10) and (32,8,112,64) at valid_len 112/90/1/0, and
               the ragged (4,2,17,33) at rate 0.1 for correctness only; MLP
               at M=3584 rows for the four K->H->N geometries.  Each at
               dropout rate 0 and at the path's rate (attention 0.1, encoder
               FFN mid 0.1, generator head pre/mid/post 0.2): the kernels
               draw the plain versions' Philox masks, so the outputs are
               compared element by element.  Forward: attention max |diff|
               <= 1e-5, MLP <= 1e-4 * max(1, max |ref|).  Backward (against
               autograd of the plain version): <= 1e-4 * max(1, max |ref|)
               per gradient, and two calls give identical bits.  The kernels'
               keep fraction is within 5 sigma of 1 - rate.
               Times: CUDA events around 10 back-to-back calls queued behind
               a device sleep (so host launch cost is hidden), median of 21,
               L2-warm; plain_ms for the plain version (autograd of it for
               a backward); library_ms for F.scaled_dot_product_attention's
               forward and backward (attention only; the port never calls
               it).  bound_ms = max(bytes / 3.35 TB/s, flops / 165 TFLOP/s),
               each input read once and each output written once: 165 is
               the H100 SXM data sheet's 495 TFLOP/s TF32 over the three
               TF32 products that give one f32-accurate product (3xTF32),
               the card's fastest f32-accurate rate.
4. serving  -- a full-width 8-layer GAN_FFN (random weights from a fixed
               seed) exported and loaded by ServingClassifier on the card,
               answering HTTP POST /predict requests through the cli/serve.py
               handler and direct log_probs calls; every forward must launch
               the attention kernel 24 times and the MLP kernel 27 times; card
               log-probs agree with the CPU path (plain versions) within 1e-3.
               Prints ms/request and utterances/s at L=112, B=32, and the
               forward's device time (CUDA events, launches hidden) beside
               its host time with the inputs on the card.
5. training -- cli/train_iemocap.main (stage B) trains the full-width
               8-layer GAN_FFN for 2 epochs on a synthetic fixture whose
               batches fill the 112 bucket (B=32), with every dropout on:
               finite losses, a report file, and exactly 24 + 24 attention
               and 27 + 27 MLP kernel calls (forward + backward) per train
               step.  Then one train step at B=32, L=112 is timed (device ms
               by CUDA events with the launches queued behind a device
               sleep; host ms to the end of a synchronize; utterances/s),
               with each kernel's share of the step's device time.  Last,
               one deterministic step on the card against the same step on
               the CPU (plain versions) from the same weights and batch
               (L=64, B=4): loss and every parameter's gradient within max
               |diff| <= 1e-3 * max(1, max |ref|).

The kernel counts are set to 0 just before the serving and the training
paths run and are read just after; the comparisons of phase 3 do not count.
The line before the last is the ``kernels`` summary (times per train step at
B=32, L=112, at the path's dropout rates); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
PEAK_F32_ACCURATE_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, 3 products per f32 (3xTF32)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_TOL = 1e-5
GRAD_TOL = 1e-4  # relative to max(1, max |ref|)
MLP_TOL = 1e-4
E2E_TOL = 1e-3
GRID = (1, 4, 8, 32)
ATTN_RATE = 0.1
# (B, H, L, Dh) -> attention launches per forward (and per backward) at B=32, L=112
ATTN_SHAPES = {(32, 10, 112, 10): 16, (32, 8, 112, 64): 8}
RAGGED_ATTN_SHAPE = (4, 2, 17, 33)  # L, Dh off the 16-row tiles and the head widths
# (K, H, N, site) -> MLP launches per forward (and per backward) at M = 112 * 32 rows
MLP_SHAPES = {
    (100, 2048, 100, "ffn"): 16,
    (512, 2048, 512, "ffn"): 8,
    (100, 512, 100, "head"): 2,
    (512, 1024, 100, "head"): 1,
}
MLP_ROWS = 112 * 32
SITE_RATE = {"ffn": 0.1, "head": 0.2}
STEP_LAUNCHES = {"attention_fwd": 24, "attention_bwd": 24, "mlp_fwd": 27, "mlp_bwd": 27}
SOURCES = {
    "attention_fwd": ("gan_ffn_tpu_torch/csrc/attention_fwd.cu", "gan_ffn_tpu/ops/attention.py:69"),
    "attention_bwd": ("gan_ffn_tpu_torch/csrc/attention_bwd.cu", "gan_ffn_tpu/ops/attention.py:86"),
    "mlp_fwd": ("gan_ffn_tpu_torch/csrc/mlp_fwd.cu", "gan_ffn_tpu/ops/mlp.py:134"),
    "mlp_bwd": ("gan_ffn_tpu_torch/csrc/mlp_bwd.cu", "gan_ffn_tpu/ops/mlp.py:162"),
}


def site_cfg(site: str, rate: float) -> dict:
    if site == "ffn":
        return dict(mid=("relu", "act_first", rate))
    return dict(pre=("gelu", rate), mid=("gelu", "drop_first", rate),
                post=("gelu", "drop_first", rate))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_time_ms(torch, fn, reps: int = 21, group: int = 10, sleep_ms: float = 10.0) -> float:
    """Median device ms of one ``fn()`` call: events around ``group`` calls
    queued behind a device sleep of about ``sleep_ms``, so that host launch
    cost stays hidden."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * 2_000_000))  # ~2e6 cycles per ms
        start.record()
        for _ in range(group):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / group)
    return statistics.median(samples)


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_F32_ACCURATE_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


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
    if set(libs) != set(SOURCES):
        fail(f"expected the kernels {sorted(SOURCES)}, built {sorted(libs)}")
    emit({"phase": "build", "seconds": secs, "libraries": {k: str(v.relative_to(REPO)) for k, v in libs.items()},
          "nvcc_seconds": dict(_build.build_seconds),
          "kernels": {name: [{"kernel": r["kernel"], "registers": r.get("registers"),
                              "spill_stores": r.get("spill_stores"), "spill_loads": r.get("spill_loads")}
                             for r in _build.ptxas_resources(log)]
                      for name, log in _build.build_logs.items()}})


class Rows:
    """Per-kernel timing rows: ``step`` at the training path's rates (one
    train step), ``serve`` at rate 0 (one serving forward)."""

    def __init__(self):
        self.step = {name: [] for name in SOURCES}
        self.serve = {"attention_fwd": [], "mlp_fwd": []}
        self.err = {name: 0.0 for name in SOURCES}


def _attention_bytes_flops(B, H, L, Dh, backward):
    n = B * H * L * Dh
    if backward:  # q, k, v, dO in; dq, dk, dv out; S, dV, dO V^T, dQ, dK
        return 4 * 7 * n, 5 * 2 * B * H * L * L * Dh
    return 4 * 4 * n, 2 * 2 * B * H * L * L * Dh


def phase_kernels_attention(torch, rows: Rows):
    import torch.nn.functional as F

    from gan_ffn_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, L, Dh), count in ATTN_SHAPES.items():
        q, k, v, dout = (torch.randn(B, H, L, Dh, device="cuda", generator=gen) for _ in range(4))
        for rate in (0.0, ATTN_RATE):
            for vl in (L, 90, 1, 0):
                seed = 1000 + vl
                got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=rate, dropout_seed=seed)
                grads = A.fused_attention_backward(q, k, v, dout, vl, rate, seed)
                again = A.fused_attention_backward(q, k, v, dout, vl, rate, seed)
                torch.cuda.synchronize()
                want = A.attention_plain(q, k, v, vl, rate, seed)
                err = (got - want).abs().max().item()
                if not err <= ATTN_TOL:
                    fail(f"attention_fwd {(B, H, L, Dh)} rate={rate} valid_len={vl}: "
                         f"max |diff| {err} > {ATTN_TOL}")
                plain = A.attention_backward_plain(q, k, v, dout, vl, rate, seed)
                gabs = max((g - w).abs().max().item() for g, w in zip(grads, plain))
                gerr = max(max_rel_err(g, w) for g, w in zip(grads, plain))
                if not gerr <= GRAD_TOL:
                    fail(f"attention_bwd {(B, H, L, Dh)} rate={rate} valid_len={vl}: "
                         f"max |diff| / max(1, max |ref|) {gerr} > {GRAD_TOL}")
                if not all(torch.equal(g, h) for g, h in zip(grads, again)):
                    fail(f"attention_bwd {(B, H, L, Dh)} rate={rate} valid_len={vl}: "
                         "two calls differ")
                rows.err["attention_fwd"] = max(rows.err["attention_fwd"], err)
                rows.err["attention_bwd"] = max(rows.err["attention_bwd"], gabs)
                line = {"phase": "kernel", "shape": [B, H, L, Dh], "rate": rate, "valid_len": vl,
                        "fwd_max_abs_err": err, "bwd_max_abs_err": gabs, "bwd_max_rel_err": gerr}
                if vl != L:
                    emit({"name": "attention", **line})
                    continue
                fwd = {
                    "ms": device_time_ms(torch, lambda: A.fused_attention(q, k, v, vl, rate, seed)),
                    "plain_ms": device_time_ms(torch, lambda: A.attention_plain(q, k, v, vl, rate, seed)),
                    "library_ms": device_time_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, dropout_p=rate)),
                }
                fwd["bound_ms"], fwd["bound_by"] = bound_ms(*_attention_bytes_flops(B, H, L, Dh, False))
                leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
                bwd = {
                    "ms": device_time_ms(torch, lambda: A.fused_attention_backward(
                        q, k, v, dout, vl, rate, seed)),
                    "plain_ms": device_time_ms(torch, lambda: A.attention_backward_plain(
                        q, k, v, dout, vl, rate, seed)),
                    "library_ms": device_time_ms(torch, lambda: torch.autograd.grad(
                        lib_out, leaves, dout, retain_graph=True)),
                }
                bwd["bound_ms"], bwd["bound_by"] = bound_ms(*_attention_bytes_flops(B, H, L, Dh, True))
                if rate == 0.0:
                    rows.serve["attention_fwd"].append((count, fwd))
                else:
                    rows.step["attention_fwd"].append((count, fwd))
                    rows.step["attention_bwd"].append((count, bwd))
                emit({"name": "attention", **line, "launches_per_step": count,
                      "fwd": fwd, "bwd": bwd})

    # a ragged geometry (L and Dh off the kernels' tiles), correctness only
    B, H, L, Dh = RAGGED_ATTN_SHAPE
    q, k, v, dout = (torch.randn(B, H, L, Dh, device="cuda", generator=gen) for _ in range(4))
    for vl in (L, L - 3, 1, 0):
        seed = 3000 + vl
        got = A.fused_attention(q, k, v, valid_len=vl, dropout_rate=ATTN_RATE, dropout_seed=seed)
        grads = A.fused_attention_backward(q, k, v, dout, vl, ATTN_RATE, seed)
        again = A.fused_attention_backward(q, k, v, dout, vl, ATTN_RATE, seed)
        torch.cuda.synchronize()
        err = (got - A.attention_plain(q, k, v, vl, ATTN_RATE, seed)).abs().max().item()
        plain = A.attention_backward_plain(q, k, v, dout, vl, ATTN_RATE, seed)
        gerr = max(max_rel_err(g, w) for g, w in zip(grads, plain))
        if not (err <= ATTN_TOL and gerr <= GRAD_TOL):
            fail(f"attention {(B, H, L, Dh)} rate={ATTN_RATE} valid_len={vl}: forward max |diff| "
                 f"{err} (limit {ATTN_TOL}), backward {gerr} (limit {GRAD_TOL} relative)")
        if not all(torch.equal(g, h) for g, h in zip(grads, again)):
            fail(f"attention_bwd {(B, H, L, Dh)} valid_len={vl}: two calls differ")
        emit({"phase": "kernel", "name": "attention", "shape": [B, H, L, Dh], "rate": ATTN_RATE,
              "valid_len": vl, "fwd_max_abs_err": err, "bwd_max_rel_err": gerr})

    # keep fraction of the kernel's mask: uniform weights, v = e_0
    B, H, L, Dh = 32, 8, 112, 64
    z = torch.zeros(B, H, L, Dh, device="cuda")
    v = torch.zeros(B, H, L, Dh, device="cuda")
    v[..., 0] = 1.0
    out = A.fused_attention(z, z, v, dropout_rate=ATTN_RATE, dropout_seed=7)
    kept = out[..., 0].double().mean().item() * (1 - ATTN_RATE)
    sigma = (ATTN_RATE * (1 - ATTN_RATE) / (B * H * L * L)) ** 0.5
    if abs(kept - (1 - ATTN_RATE)) > 5 * sigma:
        fail(f"attention dropout keeps {kept}, expected {1 - ATTN_RATE} +- {5 * sigma}")
    emit({"phase": "kernel", "name": "attention", "keep_fraction": kept,
          "expected": 1 - ATTN_RATE, "sigma": sigma})


def _mlp_bytes_flops(M, K, H, N, post, backward):
    weights = K * H + H + H * N + N
    if backward:  # x, weights, dout in; dx, dweights out
        flops = 2 * M * (3 * K * H + 2 * H * N) + (2 * M * H * N if post else 0)
        return 4 * (2 * M * K + 2 * weights + M * N), flops
    return 4 * (M * K + weights + M * N), 2 * M * (K * H + H * N)


def phase_kernels_mlp(torch, rows: Rows):
    from gan_ffn_tpu_torch.ops import mlp as Mo

    gen = torch.Generator(device="cuda").manual_seed(1)
    M = MLP_ROWS
    for (K, Hd, N, site), count in MLP_SHAPES.items():
        x = torch.randn(M, K, device="cuda", generator=gen)
        w1 = (torch.rand(K, Hd, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
        b1 = (torch.rand(Hd, device="cuda", generator=gen) * 2 - 1) * K ** -0.5
        w2 = (torch.rand(Hd, N, device="cuda", generator=gen) * 2 - 1) * Hd ** -0.5
        b2 = (torch.rand(N, device="cuda", generator=gen) * 2 - 1) * Hd ** -0.5
        dout = torch.randn(M, N, device="cuda", generator=gen)
        args = (x, w1, b1, w2, b2)
        for rate in (0.0, SITE_RATE[site]):
            cfg, seed = site_cfg(site, rate), 2000 + K + N
            got = Mo.fused_mlp(*args, **cfg, dropout_seed=seed)
            grads = Mo.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)
            again = Mo.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)
            torch.cuda.synchronize()
            want = Mo.mlp_plain(*args, **cfg, dropout_seed=seed)
            err = (got - want).abs().max().item()
            rel = max_rel_err(got, want)
            if not rel <= MLP_TOL:
                fail(f"mlp_fwd {K}->{Hd}->{N} ({site}) rate={rate}: "
                     f"max |diff| / max(1, max |ref|) {rel} > {MLP_TOL}")
            plain = Mo.mlp_backward_plain(*args, dout, **cfg, dropout_seed=seed)
            gabs = max((g - w).abs().max().item() for g, w in zip(grads, plain))
            gerr = max(max_rel_err(g, w) for g, w in zip(grads, plain))
            if not gerr <= GRAD_TOL:
                fail(f"mlp_bwd {K}->{Hd}->{N} ({site}) rate={rate}: "
                     f"max |diff| / max(1, max |ref|) {gerr} > {GRAD_TOL}")
            if not all(torch.equal(g, h) for g, h in zip(grads, again)):
                fail(f"mlp_bwd {K}->{Hd}->{N} ({site}) rate={rate}: two calls differ")
            rows.err["mlp_fwd"] = max(rows.err["mlp_fwd"], err)
            rows.err["mlp_bwd"] = max(rows.err["mlp_bwd"], gabs)
            fwd = {
                "ms": device_time_ms(torch, lambda: Mo.fused_mlp(*args, **cfg, dropout_seed=seed)),
                "plain_ms": device_time_ms(torch, lambda: Mo.mlp_plain(*args, **cfg, dropout_seed=seed)),
                "library_ms": None,
            }
            fwd["bound_ms"], fwd["bound_by"] = bound_ms(*_mlp_bytes_flops(M, K, Hd, N, site == "head", False))
            line = {"phase": "kernel", "name": "mlp", "shape": [M, K, Hd, N], "site": site,
                    "rate": rate, "fwd_max_abs_err": err, "fwd_max_rel_err": rel,
                    "bwd_max_abs_err": gabs, "bwd_max_rel_err": gerr,
                    "launches_per_step": count, "fwd": fwd}
            if rate == 0.0:
                rows.serve["mlp_fwd"].append((count, fwd))
            else:
                bwd = {
                    "ms": device_time_ms(torch, lambda: Mo.fused_mlp_backward(
                        *args, dout, **cfg, dropout_seed=seed), reps=11, group=5),
                    "plain_ms": device_time_ms(torch, lambda: Mo.mlp_backward_plain(
                        *args, dout, **cfg, dropout_seed=seed), reps=11, group=5),
                    "library_ms": None,
                }
                bwd["bound_ms"], bwd["bound_by"] = bound_ms(
                    *_mlp_bytes_flops(M, K, Hd, N, site == "head", True))
                rows.step["mlp_fwd"].append((count, fwd))
                rows.step["mlp_bwd"].append((count, bwd))
                line["bwd"] = bwd
            emit(line)

    # keep fraction of the kernel's mid mask: z1 = 1 everywhere, out[:, 0] sums the mask
    rate, H = SITE_RATE["ffn"], 2048
    w2 = torch.zeros(H, 4, device="cuda")
    w2[:, 0] = 1.0
    out = Mo.fused_mlp(torch.zeros(M, 100, device="cuda"), torch.zeros(100, H, device="cuda"),
                       torch.ones(H, device="cuda"), w2, torch.zeros(4, device="cuda"),
                       mid=("relu", "act_first", rate), dropout_seed=9)
    kept = out[:, 0].double().sum().item() * (1 - rate) / (M * H)
    sigma = (rate * (1 - rate) / (M * H)) ** 0.5
    if abs(kept - (1 - rate)) > 5 * sigma:
        fail(f"mlp dropout keeps {kept}, expected {1 - rate} +- {5 * sigma}")
    emit({"phase": "kernel", "name": "mlp", "keep_fraction": kept, "expected": 1 - rate,
          "sigma": sigma})


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
    A.fused_attention.launches = A.fused_attention_backward.launches = 0
    M.fused_mlp.launches = M.fused_mlp_backward.launches = 0
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
    if A.fused_attention_backward.launches or M.fused_mlp_backward.launches:
        fail("serving launched a backward kernel")

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
        "launches": counts,
        "card_vs_cpu_max_abs_err": e2e_err, "card_vs_cpu_argmax_agreement": agree,
        "request_ms_L112_B32": ms, "request_ms_min": min(req_ms),
        "utterances_per_s": 112 * 32 / (ms / 1e3), "forward_device_ms_L112_B32": fwd_ms,
        "forward_host_ms_L112_B32": statistics.median(host_ms),
        "forward_enqueue_ms_L112_B32": statistics.median(enqueue_ms),
    })
    return counts, fwd_ms


def _counters():
    from gan_ffn_tpu_torch.ops import attention as A
    from gan_ffn_tpu_torch.ops import mlp as M

    return {"attention_fwd": A.fused_attention, "attention_bwd": A.fused_attention_backward,
            "mlp_fwd": M.fused_mlp, "mlp_bwd": M.fused_mlp_backward}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _steps(torch, model, deterministic=False):
    from gan_ffn_tpu_torch.cli.train_iemocap import IEMOCAP_LOSS_WEIGHTS, N_CLASSES
    from gan_ffn_tpu_torch.train.classifier import make_classifier_steps
    from gan_ffn_tpu_torch.train.optim import torch_adam

    device = next(model.parameters()).device
    opt = torch_adam(model.parameters(), 1e-4, weight_decay=0.008)
    weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device)
    return make_classifier_steps(model, opt, N_CLASSES, weights, deterministic=deterministic)


def phase_training(torch):
    from gan_ffn_tpu_torch.cli import train_iemocap as CLI
    from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
    from gan_ffn_tpu_torch.models import GAN_FFN
    from gan_ffn_tpu_torch.nn.core import set_dropout_generator
    from gan_ffn_tpu_torch.train.loop import batch_to_tensors

    epochs = 2
    with tempfile.TemporaryDirectory() as tmp:
        data = write_synthetic_iemocap(os.path.join(tmp, "iemocap.pkl"), n_train=120, n_test=31,
                                       min_len=97, max_len=110, seed=0)
        train, valid, test = get_iemocap_loaders(data, batch_size=32, valid=0.1, seed=0)
        lengths = {b.seq_len for loader in (train, valid, test) for b in loader}
        if lengths != {112}:
            fail(f"the training fixture's batches have lengths {lengths}, expected the 112 bucket")
        argv = ["--GAN-epochs", "0", "--epochs", str(epochs), "--num-layers", "8",
                "--batch-size", "32", "--seed", "0", "--device", "cuda", "--data-path", data,
                "--output-dir", os.path.join(tmp, "output"),
                "--model-save-path", os.path.join(tmp, "GAN_save")]
        out = io.StringIO()
        t0 = time.perf_counter()
        _reset_counts()
        with contextlib.redirect_stdout(out):
            result = CLI.main(argv)
        torch.cuda.synchronize()
        counts = _read_counts()
        seconds = time.perf_counter() - t0
        report_ok = os.path.isfile(result["report_path"]) and os.path.getsize(result["report_path"]) > 0
        ckpt_ok = os.path.isfile(result["checkpoint"])
        batch = batch_to_tensors(next(iter(train)), "cuda")
    lines = [l for l in out.getvalue().splitlines() if l.startswith("epoch ")]
    losses = [float(w) for l in lines for k, w in zip(l.split()[::2], l.split()[1::2])
              if k.endswith("_loss")]
    if len(lines) != epochs or len(losses) != 3 * epochs or not all(map(math.isfinite, losses)):
        fail(f"training epochs: {lines}")
    if not (report_ok and ckpt_ok and math.isfinite(result["best_loss"])):
        fail(f"training wrote no report or checkpoint: {result}")
    n_steps, n_evals = epochs * len(train), epochs * (len(valid) + len(test))
    expect = {name: per * (n_steps + (n_evals if name.endswith("fwd") else 0))
              for name, per in STEP_LAUNCHES.items()}
    if counts != expect:
        fail(f"training launches {counts}, expected {expect} ({n_steps} train steps, "
             f"{n_evals} eval forwards)")
    emit({"phase": "training", "cli": "gan_ffn_tpu_torch.cli.train_iemocap", "argv": argv[:10],
          "epochs": lines, "best_loss": result["best_loss"], "f1": result["f1"],
          "train_steps": n_steps, "eval_forwards": n_evals, "launches": counts,
          "seconds": seconds})

    # one train step at B=32, L=112, every dropout on
    model = GAN_FFN(n_classes=6, gen_num_layers=8, generator=torch.Generator().manual_seed(1),
                    device="cuda")
    set_dropout_generator(model, torch.Generator().manual_seed(2))
    train_step, _ = _steps(torch, model)
    step_counts = []
    for _ in range(3):
        before = _read_counts()
        train_step(batch)
        torch.cuda.synchronize()
        step_counts.append({k: v - before[k] for k, v in _read_counts().items()})
    if any(c != STEP_LAUNCHES for c in step_counts):
        fail(f"launches per train step {step_counts}, expected {STEP_LAUNCHES}")
    enqueue_ms, host_ms = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue_ms.append((t1 - t0) * 1e3)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    enqueue = statistics.median(enqueue_ms)
    torch.cuda.reset_peak_memory_stats()
    device_ms = device_time_ms(torch, lambda: train_step(batch), reps=7, group=3,
                               sleep_ms=3 * enqueue + 20)
    host = statistics.median(host_ms)
    utterances = int(batch["umask"].sum().item())
    step = {"phase": "train_step", "B": 32, "L": 112, "valid_len": batch["valid_len"],
            "utterances": utterances, "launches_per_step": step_counts[0],
            "device_ms": device_ms, "host_ms": host, "enqueue_ms": enqueue,
            "utterances_per_s": utterances / (host / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(step)

    # one deterministic step on the card against the CPU path, same weights and batch
    rng = np.random.default_rng(3)
    L, B = 64, 4
    lengths = np.array([64, 50, 33, 10])
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    host_batch = {
        "audio": rng.standard_normal((L, B, 100)).astype(np.float32),
        "visual": rng.standard_normal((L, B, 512)).astype(np.float32),
        "text": rng.standard_normal((L, B, 100)).astype(np.float32),
        "umask": umask, "label": rng.integers(0, 6, (B, L)) * umask.astype(np.int64),
    }
    cpu_model = GAN_FFN(n_classes=6, gen_num_layers=8, generator=torch.Generator().manual_seed(4),
                        device="cpu")
    card_model = GAN_FFN(n_classes=6, gen_num_layers=8, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    results = {}
    for name, model in (("cpu", cpu_model), ("cuda", card_model)):
        tensors = {k: torch.from_numpy(v).to(name) for k, v in host_batch.items()}
        tensors["valid_len"] = int(lengths.max())
        loss, _ = _steps(torch, model, deterministic=True)[0](tensors)
        results[name] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    loss_err = abs(results["cuda"][0] - results["cpu"][0]) / max(1.0, abs(results["cpu"][0]))
    grad_err = max(max_rel_err(results["cuda"][1][k], g) for k, g in results["cpu"][1].items())
    if not (loss_err <= E2E_TOL and grad_err <= E2E_TOL):
        fail(f"card vs CPU train step at L=64, B=4: loss {loss_err}, gradients {grad_err} "
             f"(max |diff| / max(1, max |ref|)) > {E2E_TOL}")
    emit({"phase": "train_step_vs_cpu", "L": L, "B": B, "loss_cpu": results["cpu"][0],
          "loss_cuda": results["cuda"][0], "loss_rel_err": loss_err,
          "max_grad_rel_err": grad_err, "parameters": len(results["cpu"][1])})
    return counts, step


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
    rows = Rows()
    phase_kernels_attention(torch, rows)
    phase_kernels_mlp(torch, rows)
    serve_counts, fwd_ms = phase_serving(torch)
    train_counts, step = phase_training(torch)

    kernels = []
    for name, step_rows in rows.step.items():
        total = lambda key, rs=step_rows: sum(n * r[key] for n, r in rs)  # noqa: E731
        lib = [r["library_ms"] for _, r in step_rows]
        ms = total("ms")
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "launches": train_counts[name], "max_abs_err": rows.err[name],
            "ms": ms, "kernel_ms": ms, "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(step_rows, key=lambda nr: nr[0] * nr[1]["bound_ms"])[1]["bound_by"],
            "library_ms": None if None in lib else total("library_ms"),
            "per": "one train step at B=32, L=112 with the path's dropout rates: "
                   "launches_per_step calls at the shapes of the kernels phase",
            "launches_per_step": sum(n for n, _ in step_rows),
            "share_of_train_step": ms / step["device_ms"],
        }
        if name in rows.serve:
            serve = rows.serve[name]
            entry["serving_launches"] = serve_counts[name]
            entry["serving_forward_ms"] = sum(n * r["ms"] for n, r in serve)
            entry["serving_forward_plain_ms"] = sum(n * r["plain_ms"] for n, r in serve)
            entry["share_of_serving_forward"] = entry["serving_forward_ms"] / fwd_ms
        kernels.append(entry)
    for entry in kernels:
        if entry["launches"] < 1:
            fail(f"{entry['name']} was not launched on the training path")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})


if __name__ == "__main__":
    main()
