"""Peaks, and the operations and bytes of a step, counted from its shapes.

Rows are those the batch needs: ``n_real * valid_len`` (the real dialogues,
up to the batch's longest), never the bucket's padded length; attention runs
over ``valid_len`` queries and keys.  Recompute is never counted.

Each entry's ``work`` (:func:`stage_a`, :func:`classifier`) gives two
counts of one step:

- its model FLOPs, 2 per multiply-add of every product that the step's
  algorithm needs: each forward, and in backward only the weight gradients of
  the networks being trained and the input gradients that reach them;
- each launch of the port's attention and MLP kernels, with the bytes and
  operations its result needs (``chip_smoke.py``'s ``_attention_bytes_flops``
  and ``_mlp_bytes_flops``, copied, with rows and keys cut to what the batch
  needs and the backward's recompute left out), whose bounds
  :func:`step_counts` sums.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s; 3xTF32 (495 TF32 TFLOP/s
# over its three products) is the f32-accurate rate of the port's kernels.
PEAKS = {"hbm_bytes_s": 3.35e12, "f32_accurate_flops": 165e12, "tf32_flops": 495e12,
         "bf16_flops": 989e12, "f32_simt_flops": 67e12}
F32 = 4


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_s"], flops / PEAKS["f32_accurate_flops"])


def attention_work(n: int, H: int, V: int, Dh: int, backward: bool) -> Tuple[float, float]:
    rows = n * H * V * Dh
    if backward:  # q, k, v, dO in; dq, dk, dv out; dV, dP, dQ, dK
        return F32 * 7 * rows, 4 * 2 * n * H * V * V * Dh
    return F32 * 4 * rows, 2 * 2 * n * H * V * V * Dh


def mlp_work(M: int, K: int, Hd: int, N: int, backward: bool) -> Tuple[float, float]:
    weights = K * Hd + Hd + Hd * N + N
    if backward:  # x, weights, dout in; dx, dweights out; dW1, dx, dW2, da1
        return F32 * (2 * M * K + 2 * weights + M * N), 4 * M * (K * Hd + Hd * N)
    return F32 * (M * K + weights + M * N), 2 * M * (K * Hd + Hd * N)


# ---- the networks, as lists of products ------------------------------------

def _encoder(cfg, d: int, heads: int, n: int, V: int):
    """(kind, m, k, n_out): ``lin`` products carry weights, ``att`` do not."""
    R, F = n * V, cfg["d_ff"]
    ops = []
    for _ in range(cfg["num_layers"]):
        ops += [("lin", R, d, 3 * d), ("att", n * V, d, V), ("att", n * V, V, d),
                ("lin", R, d, d), ("lin", R, d, F), ("lin", R, F, d)]
    return ops


def generator_ops(cfg, modality: str, n: int, V: int):
    g = cfg["generators"][modality]
    R = n * V
    head = [("lin", R, g["d_in"], g["d_head_hidden"]), ("lin", R, g["d_head_hidden"], cfg["D_h"])]
    return _encoder(cfg, g["d_in"], g["heads"], n, V) + head


def discriminator_ops(cfg, raw_visual: bool, n: int, V: int):
    d, R = cfg["D_h"], n * V
    ops = [("lin", R, cfg["discriminator"]["raw_visual_dim"], d)] if raw_visual else []
    ops += _encoder(cfg, d, cfg["discriminator"]["heads"], n, V)
    widths = [d] + list(cfg["discriminator"]["fc"])
    return ops + [("lin", R, a, b) for a, b in zip(widths, widths[1:])]


def ops_flops(ops, trained: bool, backward: bool, input_grad: bool) -> float:
    """Forward, plus in backward each weight gradient of a trained net and
    each input gradient that something below needs."""
    total = 0.0
    for i, (kind, m, k, n_out) in enumerate(ops):
        f = 2.0 * m * k * n_out
        total += f
        if not backward:
            continue
        if kind == "lin" and trained:
            total += f
        if input_grad or (trained and i > 0):
            total += f * (2 if kind == "att" else 1)  # an attention product: both operands
    return total


# ---- the kernel launches of a step --------------------------------------------

def _net_calls(cfg, d: int, heads: int, n: int, V: int, head=None) -> List[tuple]:
    calls = []
    for _ in range(cfg["num_layers"]):
        calls += [("attention", n, heads, V, d // heads), ("mlp", n * V, d, cfg["d_ff"], d)]
    if head is not None:
        calls.append(("mlp", n * V) + head)
    return calls


def _gen_calls(cfg, modality, n, V):
    g = cfg["generators"][modality]
    return _net_calls(cfg, g["d_in"], g["heads"], n, V,
                      (g["d_in"], g["d_head_hidden"], cfg["D_h"]))


def _disc_calls(cfg, n, V):
    return _net_calls(cfg, cfg["D_h"], cfg["discriminator"]["heads"], n, V)


def _work(call, backward: bool) -> Tuple[str, float, float]:
    kind = call[0]
    fn = attention_work if kind == "attention" else mlp_work
    n_bytes, flops = fn(*call[1:], backward=backward)
    return kind, n_bytes, flops


# stage A's schedule: (kind, trained net's modality, opponent's modality)
# (the reference's train_IEMOCAP.py:355-382; nets named by modality)
STAGE_A = (("disc", "visual", "acoustic"), ("gen", "acoustic", "visual"),
           ("disc", "visual", "text"), ("gen", "text", "visual"),
           ("disc", "text", "acoustic"), ("gen", "acoustic", "text"),
           ("disc", "acoustic", "text"), ("gen", "text", "acoustic"),
           ("disc", "text", "visual"), ("gen", "visual", "text"),
           ("disc", "acoustic", "visual"), ("gen", "visual", "acoustic"))


def stage_a(cfg, n: int, V: int) -> Tuple[float, List[tuple]]:
    """(model FLOPs, kernel launches as (kind, bytes, flops, backward)) of one 12-duel step."""
    flops, launches = 0.0, []

    def launch(calls, backward):
        for c in calls:
            launches.append(_work(c, backward) + (backward,))

    for kind, net, opp in STAGE_A:
        if kind == "gen":  # trained generator through the discriminator in eval mode
            g_ops, d_ops = generator_ops(cfg, net, n, V), discriminator_ops(cfg, False, n, V)
            flops += ops_flops(d_ops, False, True, True) + ops_flops(g_ops, True, True, False)
            g, d = _gen_calls(cfg, net, n, V), _disc_calls(cfg, n, V)
            launch(g + d, False)
            launch(g + d, True)
        else:  # trained discriminator on the real features and a detached fake
            real = discriminator_ops(cfg, net == "visual", n, V)
            fake = discriminator_ops(cfg, False, n, V)
            flops += (ops_flops(real, True, True, False) + ops_flops(fake, True, True, False)
                      + ops_flops(generator_ops(cfg, opp, n, V), False, False, False))
            d = _disc_calls(cfg, n, V)
            launch(d + _gen_calls(cfg, opp, n, V) + d, False)
            launch(d + d, True)
    return flops, launches


def _scan_ops(cfg, n: int, V: int):
    c = cfg["dialoguernn"]
    Dm, Dg, Dp, De, P = cfg["D_h"], c["D_g"], c["D_p"], c["D_e"], c["parties"]
    ops = []
    for t in range(V):
        step = [("lin", n, Dm + Dp, 3 * Dg), ("lin", n, Dg, 3 * Dg),
                ("lin", n, Dm + Dg, 3 * Dp), ("lin", n * P, Dp, 3 * Dp),
                ("lin", n, Dp, 3 * De), ("lin", n, De, 3 * De)]
        if t > 0:
            step += [("lin", n, Dm, Dg), ("att", n, Dg, t), ("att", n, t, Dg)]
        ops += step * 2  # both directions
    E2, R = 2 * De, n * V
    ops += [("lin", R, E2, E2), ("att", R, E2, V), ("att", R, V, E2),
            ("lin", R, E2, 2 * c["D_h"]), ("lin", R, 2 * c["D_h"], cfg["n_classes"])]
    return ops


def classifier(cfg, n: int, V: int) -> Tuple[float, List[tuple]]:
    """(model FLOPs, kernel launches) of one ``GAN_FFN_DialogueRNN`` train step."""
    flops, calls = ops_flops(_scan_ops(cfg, n, V), True, True, True), []
    for modality in ("acoustic", "visual", "text"):
        flops += ops_flops(generator_ops(cfg, modality, n, V), True, True, False)
        calls += _gen_calls(cfg, modality, n, V)
    launches = [_work(c, False) + (False,) for c in calls]
    launches += [_work(c, True) + (True,) for c in calls]
    return flops, launches


def step_counts(work, cfg, n: int, V: int) -> Dict[str, object]:
    """The model FLOPs, the launches of each kernel and the bound seconds of
    the attention and MLP launches of one step that ``work`` (an entry's
    counting function, such as :func:`stage_a`) counts."""
    flops, launches = work(cfg, n, V)
    calls = {"attention_fwd": 0, "attention_bwd": 0, "mlp_fwd": 0, "mlp_bwd": 0}
    bounds = {"attention": 0.0, "mlp": 0.0}
    for k, n_bytes, f, backward in launches:
        calls[f"{k}_{'bwd' if backward else 'fwd'}"] += 1
        bounds[k] += bound_s(n_bytes, f)
    return {"flops": flops, "calls": calls, "bound_s": bounds}


def totals(work, cfg, batches: List[Mapping]) -> Dict[str, object]:
    """:func:`step_counts` summed over steps of ``(n_real, valid_len)``: the
    model FLOPs, the bound seconds of each layer, and the launches of each
    kernel that has any."""
    out = {"flops": 0.0, "bound_s": {"attention": 0.0, "mlp": 0.0}, "calls": {}}
    for b in batches:
        c = step_counts(work, cfg, b["n_real"], b["valid_len"])
        out["flops"] += c["flops"]
        for layer, s in c["bound_s"].items():
            out["bound_s"][layer] += s
        for call, k in c["calls"].items():
            if k:
                out["calls"][call] = out["calls"].get(call, 0) + k
    return out
