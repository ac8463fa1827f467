"""The operations, bytes and launches of a stage-A step whose text generator
is Moonlight's decoder stack (``configs/gan_ffn_moonlight.json``), counted
from its shapes as ``lib/flops.py`` counts the other networks.

Rows are those the batch needs, ``R = n_real * valid_len``: the rows the
duel mask routes.  Each routed row takes ``k`` experts, so the routed
experts' products run over ``k R`` rows; the dense layer, the shared
experts, the attention and the head over ``R``.  Recompute is never counted.

:func:`stage_a_moonlight` is the entry's ``work``: the step's model FLOPs
(every network, the text generator's four forwards and two backward passes
among them) and the launches of the port's attention and MLP kernels (the
other five networks', and the Moonlight head's ``fused_mlp``), whose bounds
``lib/flops.step_counts`` sums.  :func:`moe_step` counts the grouped expert
kernels (``ops/moe.py``): their launches by kernel name, checked against the
trace, and the bound of each, as ``max(bytes / HBM, operations / 3xTF32
peak)``, where a product's operations are ``2 * rows * K * N`` and its bytes
every expert's weights plus the rows it reads and writes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from . import flops

F32 = flops.F32
# ops/moe.py's kernels, as a device trace names them
GROUPED_KERNELS = ("grouped_gate_up_kernel", "grouped_down_kernel", "grouped_swiglu_bwd_kernel",
                   "grouped_dw_sum_kernel", "grouped_dx_kernel", "grouped_wgrad_kernel")


def moonlight_ops(cfg: Mapping, n: int, V: int) -> List[tuple]:
    """The text generator's products as ``lib/flops.py`` lists them:
    ``(kind, m, k, n_out)``, ``lin`` with weights, ``att`` without."""
    R, D = n * V, cfg["hidden_size"]
    nh, dn, dr, dv = (cfg[k] for k in ("num_attention_heads", "qk_nope_head_dim",
                                      "qk_rope_head_dim", "v_head_dim"))
    rank, k = cfg["kv_lora_rank"], cfg["num_experts_per_tok"]
    ops = [("lin", R, cfg.get("d_in", 100), D)]
    for i in range(cfg["num_hidden_layers"]):
        ops += [("lin", R, D, nh * (dn + dr)), ("lin", R, D, rank + dr),
                ("lin", R, rank, nh * (dn + dv)),
                ("att", n * V, nh * (dn + dr), V), ("att", n * V, V, nh * dv),
                ("lin", R, nh * dv, D)]
        if i < cfg["first_k_dense_replace"]:
            F_ = cfg["intermediate_size"]
            ops += [("lin", R, D, 2 * F_), ("lin", R, F_, D)]
        else:
            F_, Fs = cfg["moe_intermediate_size"], cfg["moe_intermediate_size"] * cfg[
                "n_shared_experts"]
            ops += [("lin", R, D, cfg["n_routed_experts"]),
                    ("lin", k * R, D, 2 * F_), ("lin", k * R, F_, D),
                    ("lin", R, D, 2 * Fs), ("lin", R, Fs, D)]
    H = cfg.get("d_head_hidden", 512)
    return ops + [("lin", R, D, H), ("lin", R, H, cfg["D_h"])]


def _head_call(cfg: Mapping, n: int, V: int) -> tuple:
    return ("mlp", n * V, cfg["hidden_size"], cfg.get("d_head_hidden", 512), cfg["D_h"])


def stage_a_moonlight(cfg: Mapping, n: int, V: int) -> Tuple[float, List[tuple]]:
    """(model FLOPs, kernel launches as (kind, bytes, flops, backward)) of
    one 12-duel step: ``lib/flops.stage_a`` with the text generator's
    products and launches Moonlight's."""
    total, launches = 0.0, []

    def gen_ops(net):
        return moonlight_ops(cfg, n, V) if net == "text" else flops.generator_ops(cfg, net, n, V)

    def gen_calls(net):
        return [_head_call(cfg, n, V)] if net == "text" else flops._gen_calls(cfg, net, n, V)

    def launch(calls, backward):
        for c in calls:
            launches.append(flops._work(c, backward) + (backward,))

    for kind, net, opp in flops.STAGE_A:
        if kind == "gen":
            d_ops = flops.discriminator_ops(cfg, False, n, V)
            total += (flops.ops_flops(d_ops, False, True, True)
                      + flops.ops_flops(gen_ops(net), True, True, False))
            g, d = gen_calls(net), flops._disc_calls(cfg, n, V)
            launch(g + d, False)
            launch(g + d, True)
        else:
            real = flops.discriminator_ops(cfg, net == "visual", n, V)
            fake = flops.discriminator_ops(cfg, False, n, V)
            total += (flops.ops_flops(real, True, True, False)
                      + flops.ops_flops(fake, True, True, False)
                      + flops.ops_flops(gen_ops(opp), False, False, False))
            d = flops._disc_calls(cfg, n, V)
            launch(d + gen_calls(opp) + d, False)
            launch(d + d, True)
    return total, launches


def grouped_call(E: int, rows: int, H: int, F_: int, weighted: bool,
                 backward: bool) -> Tuple[Dict[str, int], float]:
    """One ``grouped_swiglu`` call over ``rows`` rows the batch needs:
    (its launches by kernel name, the summed bounds of its products)."""
    w_gu, w_d = E * 2 * F_ * H, E * H * F_

    def bound(rows_in, rows_out, weights, ops):
        return flops.bound_s(F32 * (weights + rows * (rows_in + rows_out)), ops)

    if not backward:
        calls = {"grouped_gate_up_kernel": 1, "grouped_down_kernel": 1}
        s = (bound(H, F_, w_gu, 2 * rows * H * 2 * F_)
             + bound(F_, H, w_d, 2 * rows * F_ * H))
        return calls, s
    calls = {"grouped_swiglu_bwd_kernel": 1, "grouped_dx_kernel": 1, "grouped_wgrad_kernel": 2}
    if weighted:
        calls["grouped_dw_sum_kernel"] = 1
    s = (bound(H + 2 * F_, 2 * F_, w_d, 2 * rows * H * F_)  # da -> dz: dy, z in; dz out
         + bound(2 * F_, H, w_gu, 2 * rows * 2 * F_ * H)  # dx
         + bound(2 * F_ + H, 0, w_gu, 2 * rows * 2 * F_ * H)  # dWg, dWu
         + bound(H + F_, 0, w_d, 2 * rows * H * F_))  # dWd
    return calls, s


def moe_step(cfg: Mapping, n: int, V: int) -> Dict[str, object]:
    """The grouped kernels of one stage-A step at ``n_real`` n and
    ``valid_len`` V: launches by name and bound seconds.  The
    text generator runs four forwards (two disc duels' fakes, two gen
    duels) and two backward passes; each pass calls the op for the dense
    layer, and for each MoE layer's routed and shared experts."""
    R, D, k = n * V, cfg["hidden_size"], cfg["num_experts_per_tok"]
    E, F_, Fs = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
                 cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
    per_pass = []  # (E, rows, F, weighted)
    for i in range(cfg["num_hidden_layers"]):
        if i < cfg["first_k_dense_replace"]:
            per_pass.append((1, R, cfg["intermediate_size"], False))
        else:
            per_pass += [(E, k * R, F_, True), (1, R, Fs, False)]
    calls: Dict[str, int] = {}
    bound = 0.0
    for passes, backward in ((4, False), (2, True)):
        for e, rows, width, weighted in per_pass:
            c, s = grouped_call(e, rows, D, width, weighted, backward)
            for name, v in c.items():
                calls[name] = calls.get(name, 0) + passes * v
            bound += passes * s
    return {"calls": calls, "bound_s": bound}


def moe_totals(cfg: Mapping, batches: List[Mapping]) -> Dict[str, object]:
    """:func:`moe_step` summed over steps of (n_real, valid_len)."""
    out: Dict[str, object] = {"calls": {}, "bound_s": 0.0}
    for b in batches:
        c = moe_step(cfg, b["n_real"], b["valid_len"])
        out["bound_s"] += c["bound_s"]
        for name, v in c["calls"].items():
            out["calls"][name] = out["calls"].get(name, 0) + v
    return out
