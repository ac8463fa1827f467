"""The Moonlight cell's own files: its configuration against the catalog's
published config (every key but the depth as published), its traffic, its
three metrics' readers, and its counts on a tiny run on the CPU."""

import dataclasses
import json

import pytest

from portbench.lib import flops, harness, moe_counts

from .tiny import CHECKOUT, TINY, run_tiny

CELL = "gan_ffn_moonlight.stage_a.b32"
CFG = harness.config("gan_ffn_moonlight")
PUBLISHED = {  # Moonlight-16B-A3B config.json, as the configuration's source gives it
    "hidden_size": 2048, "intermediate_size": 11264, "moe_intermediate_size": 1408,
    "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
    "num_attention_heads": 16, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128, "rope_theta": 50000,
    "routed_scaling_factor": 2.446, "first_k_dense_replace": 1, "rms_norm_eps": 1e-05,
    "n_group": 1, "topk_group": 1, "topk_method": "noaux_tc", "scoring_func": "sigmoid",
    "norm_topk_prob": True, "num_hidden_layers": 27}


def test_configuration_keeps_every_width_and_cuts_depth_only():
    changed = {k for k, v in PUBLISHED.items() if CFG[k] != v}
    assert changed == set(CFG["reduced"]) == {"num_hidden_layers"}
    assert CFG["num_hidden_layers"] == 5 and CFG["published"]["num_hidden_layers"] == 27
    bench = harness.load_bench()
    entry = next(c for c in bench["configs"] if c["name"] == "gan_ffn_moonlight")
    assert entry["reduced"] == CFG["reduced"] and len(entry["source"]) <= 200


def test_traffic_is_stage_a_b32_s_with_its_own_entry():
    mine, theirs = harness.traffic("stage_a_moonlight.b32"), harness.traffic("stage_a.b32")
    assert mine.pop("entry") == "stage_a_moonlight" and theirs.pop("entry") == "stage_a"
    assert mine == theirs


@pytest.mark.parametrize("name", ["moonlight_step_mfu.train", "moe_ffn_roofline.train",
                                  "moe_route_ms.train"])
def test_metrics_read_their_context(name):
    read = harness.metric_reader(name)
    ctx = {"window_s": 2.0, "steps": 8, "busy_s": 1.9, "layer_s": {}, "flops": 66e12,
           "bound_s": {"attention": 0.0, "mlp": 0.0}, "peaks": flops.PEAKS,
           "moe_s": 1.0, "moe_bound_s": 0.2, "moe_route_s": 0.08}
    want = {"moonlight_step_mfu.train": 20.0, "moe_ffn_roofline.train": 20.0,
            "moe_route_ms.train": 10.0}[name]
    assert read(ctx) == pytest.approx(want)
    for key in ("moe_s", "moe_bound_s", "moe_route_s"):  # a program without the layer
        ctx.pop(key)
    if name != "moonlight_step_mfu.train":
        assert read(ctx) is None


def test_counts_at_the_published_widths():
    # per row and forward: 836 MFLOP, the routed experts 4 x 103.8 of them
    ops = moe_counts.moonlight_ops(CFG, 1, 1)
    per_row = flops.ops_flops(ops, False, False, False)
    assert per_row / 1e6 == pytest.approx(836, rel=0.02)
    step = moe_counts.moe_step(CFG, 32, 110)
    # each pass: the dense layer, four routed and four shared calls; four forwards, two backwards
    assert step["calls"] == {"grouped_gate_up_kernel": 36, "grouped_down_kernel": 36,
                             "grouped_swiglu_bwd_kernel": 18, "grouped_dx_kernel": 18,
                             "grouped_wgrad_kernel": 36, "grouped_dw_sum_kernel": 8}
    total, launches = moe_counts.stage_a_moonlight(CFG, 32, 110)
    assert total > 20e12  # the text generator's ~22 TFLOP and the rest's ~3


def test_the_cell_runs_correct_at_a_tiny_size():
    keys = ("hidden_size", "num_hidden_layers", "intermediate_size", "moe_intermediate_size",
            "n_routed_experts", "n_shared_experts", "num_experts_per_tok", "num_attention_heads",
            "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "d_head_hidden")
    from gan_ffn_tpu_torch.models.moonlight import MoonlightConfig

    tiny = dataclasses.asdict(MoonlightConfig.tiny())
    result = run_tiny(CELL, overrides={"config": dict(TINY["config"], **{k: tiny[k] for k in keys}),
                                       "traffic": TINY["traffic"]})
    assert result["correct"], json.dumps(result["checks"])
    assert result["checks"]["tie_rows"]["value"] <= result["checks"]["tie_rows"]["limit"]


def test_checkout_holds_the_reference():
    assert (CHECKOUT / "portbench/reference/gan_ffn_moonlight.py").exists()
