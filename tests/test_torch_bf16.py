"""The port's bfloat16 and int8-weight serving (gan_ffn_tpu_torch at
``dtype=bfloat16``, ``serving.bf16_variant``, ``quantize_weights_int8``,
``cli/export.py``, ``cli/predict.py``) against the JAX package.

On the CPU the kernel wrappers run their plain versions, which round where
the JAX kernels do at bf16; the JAX side runs its Pallas kernels in
interpret mode (as tests/test_torch_ops.py runs them).  Inputs are made by
numpy from a seed and rounded to bf16 once, so both sides see the same
values.  Limits:

- ops: max |diff| <= 2^-8 * max(1, max |ref|) (bf16's unit roundoff at the
  largest output) and at least 99% of the elements identical; JAX sums in
  f32 and the plain versions exactly (rounded to f32 once), so an
  intermediate a few f32 ulps apart can round to the other bf16 neighbour
  (and the JAX MLP kernel's erf is an approximation);
- the whole GAN_FFN at bf16: log-probs within 1e-2 of the JAX model's, its
  own limit (tests/test_serving.py:690), with float32 parameters cast at
  each use (the predict case) and with ``bf16_variant`` parameters (the
  export case);
- int8 quantization: the same int8 values and scales as JAX's, bit for
  bit; int8 artifacts within 1e-4 of the dequantized live model; artifact
  bytes under 0.75x (bf16) and 0.45x (int8) the float32 artifact's
  (tests/test_serving.py:679, :800).
"""

import copy
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import gan_ffn_tpu.ops.attention as JA
import gan_ffn_tpu.ops.mlp as JM
from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.ops.config import use_pallas_attention, use_pallas_mlp
from gan_ffn_tpu.serving import bf16_variant as jax_bf16_variant
from gan_ffn_tpu.serving import quantize_weights_int8 as jax_quantize_weights_int8
from gan_ffn_tpu_torch import serving as S
from gan_ffn_tpu_torch.cli import export as export_cli
from gan_ffn_tpu_torch.cli import predict as predict_cli
from gan_ffn_tpu_torch.cli import serve as serve_cli
from gan_ffn_tpu_torch.models import GAN_FFN
from gan_ffn_tpu_torch.ops import attention as TA
from gan_ffn_tpu_torch.ops import mlp as TM
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax, state_dict_from_jax

BF16_TOL = 2.0 ** -8  # relative to max(1, max |ref|)
SAME = 0.99
MODEL_TOL = 1e-2
INT8_TOL = 1e-4
L, B, VL = 8, 2, 6
MAX_LEN, BUCKETS, BATCH = 16, (8, 16), 4
HEAD = dict(pre=("gelu", 0.0), mid=("gelu", "drop_first", 0.0), post=("gelu", "drop_first", 0.0))
FFN = dict(mid=("relu", "act_first", 0.0))
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    """Run the JAX Pallas kernels in interpret mode on the CPU."""
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    mp = pytest.MonkeyPatch()
    JA._fwd_call.cache_clear()
    mp.setattr(JA.pl, "pallas_call", patched)
    mp.setattr(JM.pl, "pallas_call", patched)
    with use_pallas_attention(True), use_pallas_mlp(True):
        yield
    mp.undo()
    JA._fwd_call.cache_clear()


def _bf16(rng, shape, scale=1.0):
    """A bf16 tensor and the same values as a JAX bf16 array."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _close_bf16(got: torch.Tensor, want, what: str) -> None:
    assert got.dtype == torch.bfloat16, what
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert g.shape == w.shape, what
    tol = BF16_TOL * max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    same = float(np.mean(g == w))
    assert err <= tol and same >= SAME, (
        f"{what}: max |diff| {err} (limit {tol}), {same:.5f} identical (limit {SAME})")


def _xla_attention_bf16(q, k, v, valid_len):
    """The JAX encoder's XLA attention at bf16 (nn/transformer.py), which
    rounds where the Pallas kernel does."""
    Dh = q.shape[-1]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    scores = scores * (1.0 / jnp.sqrt(jnp.asarray(Dh, jnp.float32)))
    pos = jnp.arange(q.shape[2])
    attn = jax.nn.softmax(jnp.where(pos < valid_len, scores, -1e30), axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", attn.astype(jnp.bfloat16), v,
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)


# (a) the kernels' plain versions at bf16 against the JAX kernels at bf16


@pytest.mark.parametrize("H,Dh", [(10, 10), (8, 64)])
@pytest.mark.parametrize("valid", ["L", "partial", "1", "0"])
def test_attention_plain_matches_jax_bf16(H, Dh, valid):
    Lq = 37
    vl = {"L": Lq, "partial": 20, "1": 1, "0": 0}[valid]
    rng = np.random.default_rng(Dh + vl)
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, (2, H, Lq, Dh)) for _ in range(3))
    got = TA.fused_attention(q, k, v, valid_len=vl)
    _close_bf16(got, _xla_attention_bf16(jq, jk, jv, vl), f"XLA chain, valid_len={vl}")
    if vl > 0:  # at 0 the Pallas kernel spreads its uniform row over 128 padded keys
        _close_bf16(got, JA.fused_attention(jq, jk, jv, jnp.int32(vl)),
                    f"Pallas kernel, valid_len={vl}")


@pytest.mark.parametrize("K,H,N,cfg", [
    (100, 2048, 100, FFN),   # encoder FFN, d=100
    (512, 2048, 512, FFN),   # visual FFN
    (100, 512, 100, HEAD),   # acoustic/text head
    (512, 1024, 100, HEAD),  # visual head
])
def test_mlp_plain_matches_jax_bf16(K, H, N, cfg, monkeypatch):
    # The JAX guard sizes the row tile by the TPU's VMEM and refuses the
    # visual FFN; interpret mode has no VMEM, so its kernel runs here too.
    monkeypatch.setattr(JM, "_VMEM_BUDGET", 1 << 40)
    rng = np.random.default_rng(K + H + N)
    x, jx = _bf16(rng, (7, 3, K))
    (w1, jw1), (b1, jb1) = _bf16(rng, (K, H), K ** -0.5), _bf16(rng, (H,), 0.05)
    (w2, jw2), (b2, jb2) = _bf16(rng, (H, N), H ** -0.5), _bf16(rng, (N,), 0.05)
    got = TM.fused_mlp(x, w1, b1, w2, b2, **cfg)
    assert got.shape == (7, 3, N)
    _close_bf16(got, JM.fused_mlp(jx, jw1, jb1, jw2, jb2, **cfg), f"{K}->{H}->{N}")
    assert TM.fused_mlp_supported(K, H, N)  # the same answer at both dtypes


def test_bf16_plain_versions_round_at_the_kernels_points():
    """The plain MLP at bf16 is the f32 chain with t1, a1 and the output
    rounded to bf16 and the products' sums exact, rounded to f32; the plain
    attention rounds the weights and the output, with exact sums too."""
    rng = np.random.default_rng(3)
    (x, _), (w1, _), (b1, _) = _bf16(rng, (5, 100)), _bf16(rng, (100, 512), 0.1), \
        _bf16(rng, (512,), 0.05)
    (w2, _), (b2, _) = _bf16(rng, (512, 100), 0.05), _bf16(rng, (100,), 0.05)
    g = torch.nn.functional.gelu

    def exact(a, b):  # the products' sum exact, rounded to f32 once
        return (a.double() @ b.double()).float()

    t1 = g(x.float()).bfloat16()
    a1 = g(exact(t1, w1) + b1.float()).bfloat16()
    want = g(exact(a1, w2) + b2.float()).bfloat16()
    assert torch.equal(TM.fused_mlp(x, w1, b1, w2, b2, **HEAD), want)
    (q, _), (k, _), (v, _) = (_bf16(rng, (1, 2, 9, 16)) for _ in range(3))
    s = exact(q, k.transpose(-1, -2)) / 4.0
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.double().sum(-1, keepdim=True).float()).bfloat16()
    assert torch.equal(TA.fused_attention(q, k, v), exact(p, v).bfloat16())


# (i) a gradient at bf16: the calls that were refused before the bf16
# backward now return bf16 gradients (their values: tests/test_torch_bf16_train.py)


def test_bf16_refuses_a_gradient_in_both_ops():
    q = torch.zeros(1, 2, 4, 8, dtype=torch.bfloat16, requires_grad=True)
    TA.fused_attention(q, q, q).float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and q.grad.shape == q.shape
    x = torch.zeros(3, 8, dtype=torch.bfloat16, requires_grad=True)
    w1, w2 = torch.zeros(8, 16, dtype=torch.bfloat16), torch.zeros(16, 8, dtype=torch.bfloat16)
    b1, b2 = torch.zeros(16, dtype=torch.bfloat16), torch.zeros(8, dtype=torch.bfloat16)
    TM.fused_mlp(x, w1, b1, w2, b2).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape
    grads = TA.fused_attention_backward(q.detach(), q.detach(), q.detach(), q.detach(), 4)
    assert all(g.dtype == torch.bfloat16 and g.shape == q.shape for g in grads)
    grads = TM.fused_mlp_backward(x.detach(), w1, b1, w2, b2, torch.ones(3, 8, dtype=torch.bfloat16))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 5
    assert [g.shape for g in grads] == [t.shape for t in (x, w1, b1, w2, b2)]
    with torch.no_grad():  # without a gradient the forward runs as before
        assert TA.fused_attention(q, q, q).dtype == torch.bfloat16
        assert TM.fused_mlp(x, w1, b1, w2, b2).dtype == torch.bfloat16


# (b) the whole GAN_FFN at bf16 against the JAX model at bf16


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGAN_FFN(n_classes=6, gen_num_layers=1)
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((L, B, 100)),
                        jnp.zeros((L, B, 512)), jnp.zeros((L, B, 100)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu")
    model.load_state_dict(gan_ffn_state_dict_from_jax(jax_params))
    return model.eval()


def _inputs(Lr, Br, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((Lr, Br, d)).astype(np.float32) for d in (100, 512, 100)]


@pytest.mark.parametrize("case", ["predict", "export"])
def test_gan_ffn_bf16_matches_jax(jax_params, port_model, case):
    xs = _inputs(L, B, 1)
    if case == "predict":  # float32 parameters, cast at each use
        jm, jp = JaxGAN_FFN(n_classes=6, gen_num_layers=1, dtype=jnp.bfloat16), jax_params
        port = GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu", dtype=torch.bfloat16)
        port.load_state_dict(port_model.state_dict())
        port.eval()
        assert next(port.parameters()).dtype == torch.float32
    else:  # every parameter stored as bf16
        jm, jp = jax_bf16_variant(JaxGAN_FFN(n_classes=6, gen_num_layers=1), jax_params)
        port = S.bf16_variant(port_model)
        assert all(p.dtype == torch.bfloat16 for p in port.parameters())
        assert not port.training and port.dtype == torch.bfloat16
    want, *_ = jm.apply({"params": jp}, *(jnp.asarray(a) for a in xs),
                        valid_len=jnp.int32(VL), deterministic=True)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in xs), valid_len=VL)
    assert got.dtype == torch.float32 and got.shape == (L, B, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=MODEL_TOL)


# (c) int8 quantization against JAX's


def test_quantize_weights_int8_matches_jax(jax_params):
    params = jax.tree.map(np.copy, jax_params)
    params["fc"]["kernel"][:, 0] = 0.0  # an all-zero output channel: scale 1, q 0
    state = state_dict_from_jax(params)
    got = S.quantize_weights_int8(state)
    qflat, treedef, n = jax_quantize_weights_int8(params)
    want_q = state_dict_from_jax(jax.tree.unflatten(treedef, [np.asarray(q) for q, _ in qflat]))
    want_s = state_dict_from_jax(jax.tree.unflatten(
        treedef, [np.asarray(q if s is None else s, np.float32) for q, s in qflat]))
    scales = [k for k in got if k.endswith(S.SCALE)]
    assert len(scales) == n
    for name, x in state.items():
        if x.dim() >= 2:
            q, scale = got[name], got[name + S.SCALE]
            assert q.dtype == torch.int8 and scale.dtype == torch.float32, name
            assert scale.shape == (x.shape[0], 1), name  # one scale per row (output channel)
            assert torch.equal(q.float(), want_q[name]), name
            assert torch.equal(scale, want_s[name]), name
        else:  # biases and LayerNorm parameters pass through
            assert got[name] is x and name + S.SCALE not in got, name
    assert torch.equal(got["fc.weight:scale"][0], torch.ones(1))
    assert not got["fc.weight"][0].any()
    deq = S.dequantize_weights(got, state)
    for name, x in state.items():
        err = (deq[name] - x).abs()
        assert (err <= (got[name + S.SCALE] / 2 + 1e-7 if x.dim() >= 2 else 0)).all(), name


# (d), (e), (f): the artifacts


@pytest.fixture(scope="module")
def artifacts(port_model):
    """``{variant: bytes}`` of the four artifacts of ``port_model``."""
    out = {}
    for variant, model, int8 in (("f32", port_model, False), ("bf16", S.bf16_variant(port_model), False),
                                 ("int8", port_model, True),
                                 ("bf16+int8", S.bf16_variant(port_model), True)):
        buf = io.BytesIO()
        S.export_classifier(model, buf, max_len=MAX_LEN, batch_size=BATCH, buckets=BUCKETS,
                            weights_int8=int8)
        out[variant] = buf.getvalue()
    return out


def test_artifact_sizes_and_metadata(artifacts):
    f32 = len(artifacts["f32"])
    assert len(artifacts["bf16"]) < 0.75 * f32
    assert len(artifacts["int8"]) < 0.45 * f32
    assert len(artifacts["bf16+int8"]) < 0.45 * f32
    for variant, (dtype, weights) in {"f32": ("float32", "float32"),
                                      "bf16": ("bfloat16", "bfloat16"),
                                      "int8": ("float32", "int8"),
                                      "bf16+int8": ("bfloat16", "int8")}.items():
        clf = S.ServingClassifier.loads(artifacts[variant], device="cpu")
        assert (clf.dtype, clf.weights) == (dtype, weights), variant
        # built at the artifact's dtype before the weights are loaded
        assert {p.dtype for p in clf.model.parameters()} == {S.DTYPES[dtype]}, variant
        assert clf.log_probs(*_inputs(5, 3, 2)).dtype == np.float32


@pytest.mark.parametrize("variant", ["int8", "bf16+int8"])
def test_int8_artifact_matches_dequantized_live(port_model, artifacts, variant):
    clf = S.ServingClassifier.loads(artifacts[variant], device="cpu")
    live = copy.deepcopy(port_model if variant == "int8" else S.bf16_variant(port_model))
    state = live.state_dict()
    live.load_state_dict(S.dequantize_weights(S.quantize_weights_int8(state), state))
    for Lr, Br, seed in ((8, BATCH, 3), (5, 3, 4)):
        xs = _inputs(Lr, Br, seed)
        with torch.inference_mode():
            want = live(*(torch.from_numpy(a) for a in xs), valid_len=Lr).numpy()
        np.testing.assert_allclose(clf.log_probs(*xs), want, rtol=0, atol=INT8_TOL)


def test_loader_rejects_wrong_dtypes_and_orphan_scales(artifacts):
    art = torch.load(io.BytesIO(artifacts["int8"]), weights_only=True)
    meta, state = art["meta"], art["state_dict"]
    q, s = "fc.weight", "fc.weight:scale"
    bad = {
        "without its scale": (meta, {k: v for k, v in state.items() if k != s}),
        "without its int8": (meta, {k: v for k, v in state.items() if k != q}),
        "is torch.bfloat16": (meta, {**state, "fc.bias": state["fc.bias"].bfloat16()}),
        "expected float32": (meta, {**state, s: state[s].double()}),
        "weights 'bfloat16'": ({**meta, "weights": "bfloat16"}, state),
        "dtype 'float16'": ({**meta, "dtype": "float16"}, state),
    }
    f32 = torch.load(io.BytesIO(artifacts["f32"]), weights_only=True)
    bad["without its int8 tensor"] = (f32["meta"], {**f32["state_dict"], s: state[s]})
    bad["int8 tensor 'fc.weight' without"] = (f32["meta"], {**f32["state_dict"], q: state[q]})
    for match, (m, st) in bad.items():
        with pytest.raises(ValueError, match=match):
            S.ServingClassifier(m, st, device="cpu")


# (g) cli/export.py, and cli/serve.py on its artifacts


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 1-layer GAN_FFN trained by cli/train_iemocap on the CPU (stage B on
    the synthetic fixture): its directory, the fixture's path and the
    trainer's result line."""
    tmp = tmp_path_factory.mktemp("trained")
    # one intra-op thread: beside the other test workers, more oversubscribe the cores
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "gan_ffn_tpu_torch.cli.train_iemocap", "--synthetic",
         "--GAN-epochs", "0", "--epochs", "2", "--num-layers", "1", "--device", "cpu",
         "--synthetic-train", "16", "--synthetic-test", "6",
         "--output-dir", str(tmp / "output"), "--model-save-path", str(tmp / "GAN_save"),
         "--data-path", str(tmp / "iemocap.pkl")],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return tmp, res.stdout


@pytest.mark.parametrize("dtype,weights", [("f32", "native"), ("bf16", "native"),
                                           ("f32", "int8"), ("bf16", "int8")])
def test_export_cli_verifies_each_variant(trained, dtype, weights, capsys):
    tmp, _ = trained
    out = tmp / f"gan_ffn_{dtype}_{weights}.pt"
    res = export_cli.main(["--model-save-path", str(tmp / "GAN_save"), "--output", str(out),
                           "--num-layers", "1", "--batch-size", str(BATCH),
                           "--max-len", str(MAX_LEN), "--buckets", "8", "16",
                           "--dtype", dtype, "--weights", weights, "--verify",
                           "--device", "cpu"])
    assert "verify on cpu" in capsys.readouterr().out
    assert res["bytes"] == out.stat().st_size
    assert res["verify"]["max_abs_err"] <= (1e-4 if dtype == "f32" else 5e-2)
    assert res["verify"]["agree"] >= 0.98 * res["verify"]["total"]
    clf = S.ServingClassifier.load(out, device="cpu")
    assert clf.dtype == ("float32" if dtype == "f32" else "bfloat16")
    assert clf.weights == ("int8" if weights == "int8" else clf.dtype)
    # cli/serve.py serves it, printing its dtype and weights at start
    class FakeServer:
        def __init__(self, addr, handler):
            self.server_port = addr[1]

        def serve_forever(self):
            raise KeyboardInterrupt

        def shutdown(self):
            pass

    mp = pytest.MonkeyPatch()
    mp.setattr(serve_cli, "ThreadingHTTPServer", FakeServer)
    try:
        serve_cli.main(["--artifact", str(out), "--device", "cpu", "--port", "0"])
    finally:
        mp.undo()
    assert f"dtype {clf.dtype}, weights {clf.weights}" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["dialoguernn", "meld"])
def test_export_cli_refuses_later_families(family, tmp_path, capsys):
    """Neither of the other two families is refused: ``--model dialoguernn``
    and ``--model meld`` export their trainer's checkpoint (here one of
    seeded weights) and verify it in float32 on the CPU.  The variants and
    the JAX comparisons are in tests/test_torch_serving_families.py."""
    from gan_ffn_tpu_torch.models import GAN_FFN_DialogueRNN, MELDLSTMModel

    gen = torch.Generator().manual_seed(0)
    if family == "dialoguernn":
        model = GAN_FFN_DialogueRNN(n_classes=6, gen_num_layers=1, generator=gen, device="cpu")
        ckpt, served = "dialoguernn_classifier_best.pt", "gan_ffn_dialoguernn"
    else:
        model = MELDLSTMModel(D_m=600, D_e=300, D_h=600, n_classes=7, generator=gen, device="cpu")
        ckpt, served = "meld_classifier_best.pt", "meld_lstm"
    (tmp_path / "GAN_save").mkdir()
    torch.save(model.state_dict(), tmp_path / "GAN_save" / ckpt)
    out = tmp_path / f"{family}.pt"
    res = export_cli.main(["--model", family, "--model-save-path", str(tmp_path / "GAN_save"),
                           "--output", str(out), "--num-layers", "1", "--batch-size", "4",
                           "--max-len", "16", "--buckets", "8", "16", "--verify",
                           "--device", "cpu"])
    assert "verify on cpu" in capsys.readouterr().out
    assert res["family"] == served and res["bytes"] == out.stat().st_size
    assert res["verify"]["max_abs_err"] <= 1e-4
    assert res["verify"]["agree"] == res["verify"]["total"]
    assert S.ServingClassifier.load(out, device="cpu").family == served


# (h) cli/predict.py reproduces the trainer's best-epoch test F1


def test_predict_cli_reproduces_the_trainers_best_f1(trained, capsys):
    tmp, log = trained
    report = next((tmp / "output").glob("test_out_GAN-epochs=0_F1-score=*.txt"))
    best_f1 = float(report.name.split("F1-score=")[1][:-len(".txt")])
    argv = ["--data-path", str(tmp / "iemocap.pkl"), "--model-save-path", str(tmp / "GAN_save"),
            "--num-layers", "1", "--device", "cpu"]  # the trainer's batch size, 32
    out_json = tmp / "predictions.json"
    res = predict_cli.main(argv + ["--output", str(out_json)])
    printed = capsys.readouterr().out
    assert f"weighted F1 on test: {best_f1}" in printed, (best_f1, printed[:500])
    assert res["f1"] == best_f1 and res["n_dialogues"] == 6
    rows = json.loads(out_json.read_text())
    assert len(rows) == 6 and all(set(r) == {"vid", "predictions"} for r in rows)
    bf16 = predict_cli.main(argv + ["--bf16"])
    assert 0.0 <= bf16["f1"] <= 100.0 and bf16["n_dialogues"] == 6


def test_predict_cli_defaults_to_the_card():
    args = predict_cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.batch_size == 32 and not args.bf16
