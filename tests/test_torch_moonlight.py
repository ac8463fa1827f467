"""The Moonlight-16B-A3B text generator (``models/moonlight.py``,
``nn/mla.py``, ``nn/moe.py``, ``ops/moe.py``) on the CPU at a tiny size
(``MoonlightConfig.tiny()``: hidden 64, 4 heads of qk 16 + 8 and v 16, KV
latent 32, 8 experts of 32 with top 2 and one shared, a dense layer and 2
MoE layers), held to the plain reference that the benchmark's cell uses
(``portbench/reference/gan_ffn_moonlight.py``) on seeded weights.

Tolerances: the port and the reference compute the same float32 algebra
in another order (fused F.linear against matmul, the grouped op's
per-group products against the reference's per-expert rows), so outputs
and gradients agree to a few float32 ulps of their largest values: 1e-5
relative to max |ref| leaves room above that and below any change of the
algebra.
"""

import dataclasses

import pytest
import torch

from gan_ffn_tpu_torch.cli import common as cli_common
from gan_ffn_tpu_torch.cli import train_iemocap
from gan_ffn_tpu_torch.data import write_synthetic_iemocap
from gan_ffn_tpu_torch.models import gan_ffn
from gan_ffn_tpu_torch.models.moonlight import MoonlightConfig, MoonlightGenerator
from gan_ffn_tpu_torch.nn import moe as M
from gan_ffn_tpu_torch.ops import moe as O
from gan_ffn_tpu_torch.train.gan import (GANConfig, GANState, create_gan_modules,
                                         create_gan_optimizers)
from gan_ffn_tpu_torch.utils.checkpoint import load_gan_state, save_gan_state
from portbench.lib import harness
from portbench.lib.checks import judge
from portbench.reference import gan_ffn_moonlight as R
from portbench.tests.tiny import TINY

TINY_CFG = MoonlightConfig.tiny()
CFG = dict(dataclasses.asdict(TINY_CFG), D_h=100, dropout=0.2)
L, B = 12, 3
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, more oversubscribe
    the cores and the many small ops of a stage-A step slow fifty-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    scale = max(want.abs().max().item(), 1e-30)
    return (got - want).abs().max().item() / scale <= tol


def _generator(seed=0):
    torch.manual_seed(seed)
    return MoonlightGenerator(100, 0.2, TINY_CFG, generator=torch.Generator().manual_seed(seed),
                              device="cpu")


def _inputs():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(L, B, 100, generator=g)
    mask = torch.zeros(L, B, 1)
    mask[:9, :2] = 1.0  # valid_len 9, n_real 2
    return x, mask


def _ref_state(gen):
    st = R.Moonlight(CFG, "cpu")
    for layer, m in zip(sorted(st.bias), gen.moe_layers()):
        st.bias[layer] = m.gate.e_score_correction_bias.detach().clone()
    return st


def test_generator_forward_and_gradients_match_the_reference():
    gen = _generator()
    with torch.no_grad():  # routing that the correction bias moves
        gen.moe_layers()[0].gate.e_score_correction_bias.copy_(torch.linspace(-0.2, 0.2, 8))
    gen.eval()
    x, mask = _inputs()
    y = gen(x, valid_len=9, row_mask=mask)
    gen.train()  # the head's dropout off below: rate 0 keeps the comparison deterministic
    gen.dropout = 0.0
    w = torch.randn(L, B, 100, generator=torch.Generator().manual_seed(2))
    y_train = gen(x, valid_len=9, row_mask=mask)
    params = dict(gen.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]
    grads = torch.autograd.grad((y_train * w).sum() + gen.balance_loss, [params[n] for n in names])

    W = {n: p.detach().clone().requires_grad_(p.requires_grad) for n, p in params.items()}
    st = _ref_state(gen)
    with torch.no_grad():
        want, _, _ = R.text_generator(W, x, 9, mask[:, :, 0] > 0, False, CFG, st, None)
    want_train, balance, _ = R.text_generator(W, x, 9, mask[:, :, 0] > 0, False, CFG, st, None)
    ref_grads = torch.autograd.grad((want_train * w).sum() + balance, [W[n] for n in names])
    assert _close(y, want) and _close(y_train, want_train)
    assert torch.allclose(gen.balance_loss, balance, rtol=1e-5, atol=0.0)
    for n, g, r in zip(names, grads, ref_grads):
        assert _close(g, r), n


def _layer(seed=0, bias=None):
    torch.manual_seed(seed)
    layer = M.MoE(64, 8, 2, 32, 1, 2.446, 1e-4, 1e-3, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    if bias is not None:
        with torch.no_grad():
            layer.gate.e_score_correction_bias.copy_(bias)
    return layer


def _routing(layer, x, mask):
    """Each routed row's (chosen experts, weights) as the layer takes them."""
    flat = x.reshape(-1, x.shape[-1])
    scores = torch.sigmoid(flat @ layer.gate.weight.t())
    idx = (scores + layer.gate.e_score_correction_bias).topk(2, dim=-1).indices
    w = scores.gather(1, idx)
    return idx, w / w.sum(-1, keepdim=True) * 2.446, scores


@pytest.mark.parametrize("case", ["bias_chooses", "padded_rows", "empty_expert", "one_expert"])
def test_routing(case):
    x = torch.randn(L, B, 64, generator=torch.Generator().manual_seed(4))
    mask = torch.zeros(L, B, dtype=torch.bool)
    mask[:9, :2] = True
    bias = {"bias_chooses": torch.tensor([1.0] + [0.0] * 7), "padded_rows": None,
            "empty_expert": torch.tensor([0.0] * 7 + [-10.0]),
            "one_expert": torch.tensor([0.0, 0.0, 0.0, 10.0] + [0.0] * 4)}[case]
    layer = _layer(bias=bias)
    y = layer(x, mask)
    idx, w, scores = _routing(layer, x, mask)
    routed = mask.reshape(-1)
    load = layer.last_load
    assert int(load.sum()) == 2 * int(routed.sum())  # dropless, padded rows uncounted
    assert int(layer.routed_rows) == int(routed.sum())
    assert torch.allclose(w.sum(-1), torch.full((L * B,), 2.446))  # normalised and scaled
    if case == "bias_chooses":  # expert 0 chosen everywhere; its weight from the plain score
        assert (idx == 0).any(-1).all()
        assert not (scores.topk(2, dim=-1).indices == 0).any(-1).all()
        w0 = scores[:, 0] / scores.gather(1, idx).sum(-1) * 2.446
        assert torch.allclose(w[idx == 0], w0)
    if case == "padded_rows":  # a padded row takes the shared experts alone
        shared = layer.shared_experts(x.reshape(-1, 64)).view(L, B, 64)
        assert torch.allclose(y[~mask], shared[~mask])
        assert not torch.allclose(y[mask], shared[mask])
    if case == "empty_expert":
        assert load[7] == 0
        grads = torch.autograd.grad(y.sum(), [layer.experts.w_gate, layer.experts.w_down])
        assert all(g[7].abs().max() == 0 for g in grads)
        assert all(g[:7].abs().max() > 0 for g in grads)
    if case == "one_expert":
        assert int(load[3]) == int(routed.sum())


def test_balance_loss_and_bias_update_match_the_reference():
    layer = _layer(bias=torch.linspace(-0.01, 0.01, 8))
    x = torch.randn(L, B, 64, generator=torch.Generator().manual_seed(5))
    mask = torch.zeros(L, B, dtype=torch.bool)
    mask[:10, :2] = True
    mask[:4, 2] = True
    layer(x, mask)
    cfg = dict(CFG, hidden_size=64, n_routed_experts=8, num_experts_per_tok=2,
               num_hidden_layers=2, first_k_dense_replace=1)
    st = R.Moonlight(cfg, "cpu")
    st.bias[1] = layer.gate.e_score_correction_bias.detach().clone()
    W = {f"mlp.{k}": v for k, v in layer.state_dict().items()}
    _, balance, load = R.moe(W, "mlp.", x, mask, 1, st, True)
    assert torch.allclose(layer.balance_loss, balance, rtol=1e-6, atol=0.0)
    assert torch.equal(layer.last_load, load)
    before = layer.gate.e_score_correction_bias.clone()
    layer.update_bias()
    assert torch.allclose(layer.gate.e_score_correction_bias,
                          before - 1e-3 * torch.sign(load - load.mean()))


@pytest.mark.parametrize("groups", [1, 4])
def test_grouped_op_cpu_path_matches_a_masked_dense_loop(groups):
    g = torch.Generator().manual_seed(6)
    T, H, F_ = 40, 16, 24
    x = torch.randn(T, H, generator=g, requires_grad=True)
    ws = [torch.randn(groups, F_, H, generator=g).mul_(0.2).requires_grad_(True),
          torch.randn(groups, F_, H, generator=g).mul_(0.2).requires_grad_(True),
          torch.randn(groups, H, F_, generator=g).mul_(0.2).requires_grad_(True)]
    counts = [T] if groups == 1 else [9, 0, 20, 5]  # an empty group; 6 rows in none
    offsets = torch.tensor([0] + list(torch.tensor(counts).cumsum(0)), dtype=torch.int32)
    weights = None if groups == 1 else torch.rand(T, generator=g).requires_grad_(True)
    y = O.grouped_swiglu(x, *ws, offsets if groups > 1 else None, weights)
    want = torch.zeros(T, H)
    group = torch.searchsorted(offsets[1:], torch.arange(T), right=True)
    for e in range(groups):
        m = (group == e).float()[:, None]
        h = torch.nn.functional.silu(x @ ws[0][e].t()) * (x @ ws[1][e].t())
        if weights is not None:
            h = h * weights[:, None]
        want = want + m * (h @ ws[2][e].t())
    dy = torch.randn(T, H, generator=g)
    leaves = [x] + ws + ([weights] if weights is not None else [])
    got = torch.autograd.grad(y, leaves, dy)
    ref = torch.autograd.grad(want, leaves, dy)
    assert _close(y, want)
    assert all(_close(a, b) for a, b in zip(got, ref))


TINY_KEYS = ("hidden_size", "num_hidden_layers", "intermediate_size", "moe_intermediate_size",
             "n_routed_experts", "n_shared_experts", "num_experts_per_tok", "num_attention_heads",
             "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "d_head_hidden")


def test_three_graphed_stage_a_steps_match_the_reference():
    """The benchmark cell's check at the tiny size: three steps of
    make_gan_epoch_step (every dropout on) against the reference's
    stage_a_step, losses, Adam moments and parameter changes."""
    cell = harness.cell_of(harness.load_bench(), "gan_ffn_moonlight.stage_a.b32")
    cfg = dict(harness.config(cell["config"]), **TINY["config"], **{k: CFG[k] for k in TINY_KEYS})
    traf = dict(harness.traffic(cell["traffic"]), **dict(TINY["traffic"], pool_epochs=1,
                                                         utterances=48, length_max=6, buckets=[6]))
    entry = harness.entry_class(traf["entry"])(cfg, traf, 2147483999, "cpu")
    entry.setup()
    entry.free()
    checks = entry.readings()
    assert all(j["ok"] for j in judge(checks, cfg["limits"])), checks
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap"] < 1e-4, checks
    assert checks["choice_mismatch"] == 0


def test_checkpoint_round_trip_keeps_the_stack_and_its_biases(tmp_path):
    cfg = GANConfig(num_layers=1, text_generator="moonlight", moonlight=TINY_CFG)
    modules = create_gan_modules(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        modules["text_gen"].moe_layers()[1].gate.e_score_correction_bias.fill_(0.25)
    save_gan_state(str(tmp_path), GANState(modules, create_gan_optimizers(cfg, modules)))
    fresh = create_gan_modules(cfg, torch.Generator().manual_seed(1), "cpu")
    loaded = load_gan_state(str(tmp_path), fresh, create_gan_optimizers(cfg, fresh))
    for k, v in modules["text_gen"].state_dict().items():
        assert torch.equal(loaded.modules["text_gen"].state_dict()[k], v), k


def test_cli_trains_stage_a_and_b_and_resumes(tmp_path, monkeypatch):
    """Stage A and B with the Moonlight text generator, its six checkpoints,
    then stage B again from them (``--use-trained-GAN``, no more stage A)."""
    monkeypatch.chdir(tmp_path)
    # the tiny stack in place of the published widths that both stages build
    monkeypatch.setattr(cli_common, "MoonlightConfig", MoonlightConfig.tiny)
    monkeypatch.setattr(gan_ffn, "MoonlightConfig", MoonlightConfig.tiny)
    # short dialogues, written where --synthetic looks first
    write_synthetic_iemocap("data/iemocap/IEMOCAP_features.pkl", n_train=8, n_test=4, max_len=12)
    common = ["--synthetic", "--device", "cpu", "--num-layers", "1", "--epochs", "1",
              "--synthetic-train", "8", "--synthetic-test", "4", "--text-generator",
              "moonlight"]
    first = train_iemocap.main(common + ["--GAN-epochs", "1"])
    saved = (tmp_path / "GAN_save" / "text_gen.msgpack").read_bytes()
    second = train_iemocap.main(common + ["--use-trained-GAN", "--continue-train-GAN-step", "0",
                                          "--epoch-fused"])
    assert (tmp_path / "GAN_save" / "text_gen.msgpack").read_bytes() == saved
    assert first["checkpoint"] == second["checkpoint"]
    with pytest.raises(SystemExit):
        train_iemocap.main(common + ["--GAN-epochs", "1", "--bf16"])
