"""The operation and byte counts against hand counts at the shapes of the
port's kernel table (B=32 or 30, L=112), and the rows they count."""

import json

import pytest

from portbench.lib import flops

from .tiny import CHECKOUT

CFG = {name: json.loads((CHECKOUT / f"portbench/configs/{name}.json").read_text())
       for name in ("gan_ffn", "gan_ffn_dialoguernn")}


def test_attention_work_by_hand():
    # (32, 10, 112, 10): q, k, v and the output once each, f32; QK^T and PV
    n_bytes, ops = flops.attention_work(32, 10, 112, 10, backward=False)
    assert n_bytes == 4 * 4 * 32 * 10 * 112 * 10
    assert ops == 2 * (2 * 32 * 10 * 112 * 112 * 10)
    n_bytes, ops = flops.attention_work(32, 10, 112, 10, backward=True)
    assert n_bytes == 7 * 4 * 32 * 10 * 112 * 10
    assert ops == 4 * (2 * 32 * 10 * 112 * 112 * 10)  # dV, dP, dQ, dK; no recompute


def test_mlp_work_by_hand():
    M, K, H, N = 3584, 100, 2048, 100
    weights = K * H + H + H * N + N
    assert flops.mlp_work(M, K, H, N, False) == (4 * (M * K + weights + M * N),
                                                 2 * M * K * H + 2 * M * H * N)
    assert flops.mlp_work(M, K, H, N, True) == (4 * (2 * M * K + 2 * weights + M * N),
                                                2 * (2 * M * K * H + 2 * M * H * N))


def test_bound_is_the_slower_of_bytes_and_operations():
    assert flops.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 165e12) == pytest.approx(1.0)
    # the PERF.md table's 100->2048->100 forward at M = 3584: operations bound it
    n_bytes, ops = flops.mlp_work(3584, 100, 2048, 100, False)
    assert flops.bound_s(n_bytes, ops) * 1e3 == pytest.approx(0.0178, rel=0.01)


STAGE_A, CLASSIFIER = flops.stage_a, flops.classifier


@pytest.mark.parametrize("kind,name,B,calls", [
    (STAGE_A, "gan_ffn", 32, {"attention_fwd": 240, "attention_bwd": 192, "mlp_fwd": 252,
                              "mlp_bwd": 198}),
    (CLASSIFIER, "gan_ffn_dialoguernn", 30, {"attention_fwd": 24, "attention_bwd": 24,
                                             "mlp_fwd": 27, "mlp_bwd": 27})])
def test_launches_a_step_equal_the_port_counters(kind, name, B, calls):
    # the op wrappers' launch counters over one step (the port's smoke run)
    assert flops.step_counts(kind, CFG[name], B, 112)["calls"] == calls
    steps = [{"n_real": B, "valid_len": 112}, {"n_real": 3, "valid_len": 40}]
    assert flops.totals(kind, CFG[name], steps)["calls"] == {k: 2 * v for k, v in calls.items()}


def test_stage_a_flops_near_the_xla_count():
    # the JAX bench's XLA count of a stage-A step at B=32, L=112 is 3.33e12
    assert flops.step_counts(STAGE_A, CFG["gan_ffn"], 32, 112)["flops"] == pytest.approx(
        3.3e12, rel=0.03)


@pytest.mark.parametrize("kind,name", [(STAGE_A, "gan_ffn"), (CLASSIFIER, "gan_ffn_dialoguernn")])
def test_counts_follow_the_rows_the_batch_needs(kind, name):
    cfg = CFG[name]
    full = flops.step_counts(kind, cfg, 32, 112)
    short = flops.step_counts(kind, cfg, 32, 56)
    fewer = flops.step_counts(kind, cfg, 16, 112)
    assert short["flops"] < 0.55 * full["flops"] and fewer["flops"] == pytest.approx(
        full["flops"] / 2, rel=1e-9)
    for layer in ("attention", "mlp"):
        assert short["bound_s"][layer] < 0.55 * full["bound_s"][layer]
        assert fewer["bound_s"][layer] == pytest.approx(full["bound_s"][layer] / 2, rel=0.01)


def test_encoder_layer_flops_by_hand():
    cfg = dict(CFG["gan_ffn"], num_layers=1)
    n, V, d, F = 2, 5, 100, 2048
    R = n * V
    fwd = 2 * R * (3 * d * d + d * d + 2 * d * F) + 2 * (2 * n * V * V * d)
    ops = flops._encoder(cfg, d, 10, n, V)
    assert flops.ops_flops(ops, trained=False, backward=False, input_grad=False) == fwd
    # trained, the input takes no gradient: every weight gradient, every input
    # gradient but the first product's
    first = 2 * R * d * 3 * d
    lin = 2 * R * (3 * d * d + d * d + 2 * d * F)
    att = 2 * (2 * n * V * V * d)
    assert flops.ops_flops(ops, True, True, False) == fwd + lin + (lin - first) + 2 * att
