"""The epoch-fused path's CUDA graphs on the card (``train/graphs.py``).

Marked ``cuda_hardware``: every test skips where ``torch.cuda.is_available()``
is False, and runs wherever a CUDA card is present:

    python -m pytest --noconftest -q tests/test_torch_graphs_cuda.py

- One captured graph of attention and MLP calls (forward and backward,
  dropout on) replayed at other ``valid_len`` and seed bases equals the
  plain versions there, under the kernels' limits: attention forward max
  |diff| <= 1e-5, the rest <= 1e-4 * max(1, max |ref|).  A mask element
  drawn otherwise would move an output by ~1e-2.
- Each of the three steps (stage A, stage B, DialogueRNN), deterministic,
  small depth, 3 graphed steps against 3 eager ones from the same weights
  and batches, the lr scaled by 1, 0.5 and 0.25 between the steps (so
  between replays, through ``train.optim.set_lr_scale``): with the same
  capturable Adams at the trainers' eps 1e-8, so the graph is the only
  difference, the same bits; against the per-batch path's plain Adams,
  losses and every parameter within 1e-6 * max(1, max |ref|).  Adam's eps
  is 1e-3 there, as in the other step comparisons
  (tests/test_torch_train.py EPS): gradients that are 0 in exact
  arithmetic come out as noise of either sign, which the two Adams'
  arithmetic turns into different updates of lr's size at eps 1e-8.
- The capturable Adam (``train.optim.make_capturable``: its lr in a device
  tensor, decayed in place) against the CPU's float-lr Adam over four
  epochs of the 0.98**e schedule, within 1e-6.
"""

import numpy as np
import pytest
import torch
from tf32_emulation import away_from_relu_kink

from gan_ffn_tpu_torch.cli.common import IEMOCAP_LOSS_WEIGHTS, gan_batch_from
from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN
from gan_ffn_tpu_torch.ops import attention as A
from gan_ffn_tpu_torch.ops import dropout as D
from gan_ffn_tpu_torch.ops import mlp as M
from gan_ffn_tpu_torch.train.classifier import make_classifier_epoch_steps, make_classifier_steps
from gan_ffn_tpu_torch.train.gan import (GANConfig, init_gan_state, make_gan_epoch_step,
                                         make_gan_train_step)
from gan_ffn_tpu_torch.train.optim import make_capturable, set_lr_scale, torch_adam

pytestmark = pytest.mark.cuda_hardware

TOL = 1e-6
EPS = 1e-3  # Adam's eps in the step comparisons
FFN = dict(mid=("relu", "act_first", 0.1))
HEAD = dict(pre=("gelu", 0.2), mid=("gelu", "drop_first", 0.2), post=("gelu", "drop_first", 0.2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs and the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, scale, device):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


def _rel(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def test_one_graph_replays_at_other_valid_len_and_seeds(cuda):
    rng = np.random.default_rng(0)
    vl = torch.full((), 37, dtype=torch.int32, device=cuda)
    base = torch.zeros((), dtype=torch.int64, device=cuda)
    q, k, v, do = (_randn(rng, (3, 2, 37, 16), 1.0, cuda) for _ in range(4))
    mlps = []
    for K, H, N, cfg in ((64, 128, 48, FFN), (37, 100, 33, HEAD)):
        w1, b1 = _randn(rng, (K, H), K ** -0.5, cuda), _randn(rng, (H,), 0.05, cuda)
        x = away_from_relu_kink(_randn(rng, (150, K), 1.0, cuda), w1, b1,
                                lambda n, K=K: _randn(rng, (n, K), 1.0, cuda))
        args = (x, w1, b1, _randn(rng, (H, N), H ** -0.5, cuda), _randn(rng, (N,), 0.05, cuda))
        mlps.append((args, _randn(rng, (150, N), 1.0, cuda), cfg))

    def calls():
        seed = D.SeedRef(base, 0)
        outs = [(A.fused_attention(q, k, v, vl, 0.1, seed),
                 A.fused_attention_backward(q, k, v, do, vl, 0.1, seed))]
        for i, (args, dout, cfg) in enumerate(mlps, start=1):
            seed = D.SeedRef(base, i)
            outs.append((M.fused_mlp(*args, **cfg, dropout_seed=seed),
                         M.fused_mlp_backward(*args, dout, **cfg, dropout_seed=seed)))
        return outs

    calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for valid_len in (30, 1, 0):
        for seed_base in (3, 2**62 + 1, 987654321):
            vl.fill_(valid_len)
            base.fill_(seed_base)
            graph.replay()
            torch.cuda.synchronize()
            fwd, bwd = outs[0]
            seed = D.derive_seed(seed_base, 0)
            want = A.attention_plain(q, k, v, valid_len, 0.1, seed)
            assert (fwd - want).abs().max().item() <= 1e-5, (valid_len, seed_base)
            for g, w in zip(bwd, A.attention_backward_plain(q, k, v, do, valid_len, 0.1, seed)):
                assert _rel(g, w) <= 1e-4, (valid_len, seed_base)
            for i, ((args, dout, cfg), (fwd, bwd)) in enumerate(zip(mlps, outs[1:]), start=1):
                seed = D.derive_seed(seed_base, i)
                assert _rel(fwd, M.mlp_plain(*args, **cfg, dropout_seed=seed)) <= 1e-4
                for g, w in zip(bwd, M.mlp_backward_plain(*args, dout, **cfg, dropout_seed=seed)):
                    assert _rel(g, w) <= 1e-4, (i, seed_base)


def _batch(rng, B, L, device):
    lengths = rng.integers(L // 2, L + 1, B)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    host = {
        "audio": rng.standard_normal((L, B, 100)).astype(np.float32),
        "visual": rng.standard_normal((L, B, 512)).astype(np.float32),
        "text": rng.standard_normal((L, B, 100)).astype(np.float32),
        "umask": umask, "label": rng.integers(0, 6, (B, L)) * umask.astype(np.int64),
        "qmask": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (L, B))] * umask.T[:, :, None],
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    batch["valid_len"] = torch.tensor(int(lengths.max()), dtype=torch.int32, device=device)
    batch["n_real"] = torch.tensor(B - 1, dtype=torch.int32, device=device)
    return batch


LR_SCALES = (1.0, 0.5, 0.25)  # the lr's scale in each of the 3 compared steps


def _classifier(cls):
    def build(graphed, device, eps):
        kw = dict(D_g=16, D_p=16, D_e=8, D_a=7) if cls is GAN_FFN_DialogueRNN else {}
        model = cls(n_classes=6, gen_num_layers=2, generator=torch.Generator().manual_seed(1),
                    device=device, **kw)
        opt = torch_adam(model.parameters(), 1e-3, eps=eps, weight_decay=0.008)
        make = make_classifier_epoch_steps if graphed else make_classifier_steps
        step = make(model, opt, 6, torch.from_numpy(IEMOCAP_LOSS_WEIGHTS).to(device),
                    deterministic=True)[0]
        return step, lambda out: [out[0].item()], dict(model.named_parameters()), [opt]
    return build


def _stage_a(graphed, device, eps):
    state = init_gan_state(GANConfig(num_layers=2, seed=3), device=device)
    for opt in state.opts.values():
        for group in opt.param_groups:
            group["eps"] = eps
    make = make_gan_epoch_step if graphed else make_gan_train_step
    params = {f"{n}.{k}": p for n, m in state.modules.items() for k, p in m.named_parameters()}
    return (make(state.modules, state.opts, deterministic=True),
            lambda out: [out[f"duel_{i}"].item() for i in range(12)], params,
            list(state.opts.values()))


STEP_BUILDERS = [("stage_a", _stage_a), ("stage_b", _classifier(GAN_FFN)),
                 ("dialoguernn", _classifier(GAN_FFN_DialogueRNN))]


def _eager_and_graphed(name, build, device, eps, capturable):
    """Losses and parameters after 3 eager and after 3 graphed steps."""
    rng = np.random.default_rng(4)
    batches = [_batch(rng, 4, 32, device) for _ in LR_SCALES]
    if name == "stage_a":
        batches = [gan_batch_from(b) for b in batches]
    results = []
    for graphed in (False, True):
        step, losses_of, params, opts = build(graphed, device, eps)
        if capturable:
            for opt in opts:
                make_capturable(opt)
        losses = []
        for scale, batch in zip(LR_SCALES, batches):
            for opt in opts:
                set_lr_scale(opt, scale)
            losses.append(losses_of(step(batch)))
        if graphed:
            assert sum(s["replays"] for s in step.graphs.stats()) == 2
        results.append((losses, {k: p.detach().clone() for k, p in params.items()}))
    return results


@pytest.mark.parametrize("name,build", STEP_BUILDERS)
def test_graphed_steps_equal_eager(cuda, name, build):
    (want_losses, want), (got_losses, got) = _eager_and_graphed(name, build, cuda, 1e-8,
                                                                capturable=True)
    assert got_losses == want_losses
    for k, w in want.items():
        assert torch.equal(got[k], w), (k, _rel(got[k], w))


@pytest.mark.parametrize("name,build", STEP_BUILDERS)
def test_graphed_steps_near_plain_adam_steps(cuda, name, build):
    (want_losses, want), (got_losses, got) = _eager_and_graphed(name, build, cuda, EPS,
                                                                capturable=False)
    for lg, lw in zip(got_losses, want_losses):
        for a, b in zip(lg, lw):
            assert abs(a - b) <= TOL * max(1.0, abs(b))
    for k, w in want.items():
        assert _rel(got[k], w) <= TOL, k


def test_capturable_adam_follows_the_float_schedule(cuda):
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 4)).astype(np.float32)
    grads = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(8)]
    a = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    b = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(cuda))
    float_opt = torch_adam([a], 1e-2, weight_decay=0.008)
    card_opt = make_capturable(torch_adam([b], 1e-2, weight_decay=0.008))
    group = card_opt.param_groups[0]
    assert group["capturable"] and isinstance(group["lr"], torch.Tensor)
    for e in range(4):
        set_lr_scale(float_opt, 0.98**e)
        set_lr_scale(card_opt, 0.98**e)
        for g in grads[2 * e:2 * e + 2]:
            a.grad, b.grad = torch.from_numpy(g), torch.from_numpy(g).to(cuda)
            float_opt.step()
            card_opt.step()
    np.testing.assert_allclose(b.detach().cpu().numpy(), a.detach().numpy(), rtol=0, atol=1e-6)
