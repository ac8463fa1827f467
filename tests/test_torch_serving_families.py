"""Serving of the ``gan_ffn_dialoguernn`` and ``meld_lstm`` families
(gan_ffn_tpu_torch.serving, cli/export.py, cli/serve.py) against the JAX
package's, on the CPU.

A 1-layer ``GAN_FFN_DialogueRNN`` with small recurrent widths and a small
``MELDLSTMModel`` (D_m 24, D_e 8) are exported by the JAX package
(StableHLO for the CPU) and, with the same weights carried across by the
bridge, by the port, as float32, bf16 and bf16 with int8 weights; both are
served on the CPU and must agree on the grid and off it (1e-4; 5e-2 at
bf16, ``cli/export.py``'s limits).  The padding policy is held to what each
family allows: the DialogueRNN family pads time and batch without changing
a real row, the MELD family pads only the batch, because padding time
changes the real rows (its reverse LSTM reads the whole padded sequence),
and its ``warmup()`` refuses to guess lengths.  The file runs torch on one
intra-op thread.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_ffn_tpu import serving as JS
from gan_ffn_tpu.models import GAN_FFN_DialogueRNN as JaxGAN_FFN_DialogueRNN
from gan_ffn_tpu.models import MELDLSTMModel as JaxMELDLSTMModel
from gan_ffn_tpu_torch import serving as S
from gan_ffn_tpu_torch.cli import export as export_cli
from gan_ffn_tpu_torch.cli import serve as serve_cli
from gan_ffn_tpu_torch.cli import train_meld as meld_cli
from gan_ffn_tpu_torch.data import write_synthetic_meld
from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN, MELDLSTMModel
from gan_ffn_tpu_torch.utils.weights import state_dict_from_jax

MAX_LEN, BUCKETS, BATCH = 16, (8, 16), 4
DRNN_KW = dict(D_g=24, D_p=24, D_e=8, D_a=8)  # small recurrent widths
MELD_KW = dict(D_m=24, D_e=8, D_h=16)
TOL = {"f32": 1e-4, "bf16": 5e-2, "bf16+int8": 5e-2}
FAMILY = {"dialoguernn": "gan_ffn_dialoguernn", "meld": "meld_lstm"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(family, L, B, seed=0, lengths=None):
    """The family's request: normal features, one-hot speakers and a umask
    of ``lengths`` (all L by default), both zero past each dialogue."""
    rng = np.random.default_rng(seed)
    lengths = np.full(B, L) if lengths is None else np.asarray(lengths)
    um = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    P, dims = (2, (100, 512, 100)) if family == "dialoguernn" else (9, (MELD_KW["D_m"],))
    feats = [rng.standard_normal((L, B, d)).astype(np.float32) for d in dims]
    qm = np.eye(P, dtype=np.float32)[rng.integers(0, P, (L, B))] * um.T[:, :, None]
    return feats + [qm, um]


@pytest.fixture(scope="module")
def jax_models():
    """{family: (JAX model, float32 params)}."""
    out = {}
    jm = JaxGAN_FFN_DialogueRNN(n_classes=6, gen_num_layers=1, **DRNN_KW)
    xs = _inputs("dialoguernn", 8, BATCH)
    out["dialoguernn"] = (jm, jax.jit(lambda k: jm.init({"params": k}, *xs)["params"])(
        jax.random.PRNGKey(0)))
    jm = JaxMELDLSTMModel(**MELD_KW, n_classes=7)
    xs = _inputs("meld", 8, BATCH)
    out["meld"] = (jm, jax.jit(lambda k: jm.init({"params": k}, *xs)["params"])(
        jax.random.PRNGKey(1)))
    return {k: (m, jax.tree.map(np.asarray, p)) for k, (m, p) in out.items()}


def _port_model(family, params):
    if family == "dialoguernn":
        model = GAN_FFN_DialogueRNN(n_classes=6, gen_num_layers=1, device="cpu", **DRNN_KW)
    else:
        model = MELDLSTMModel(**MELD_KW, n_classes=7, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model.eval()


def _port_blob(family, model, variant):
    if variant != "f32":
        model = S.bf16_variant(model)
    buf = io.BytesIO()
    kw = dict(batch_size=BATCH, max_len=MAX_LEN, weights_int8=variant == "bf16+int8")
    if family == "dialoguernn":
        S.export_dialoguernn_classifier(model, buf, buckets=BUCKETS, **kw)
    else:
        S.export_meld_classifier(model, buf, **kw)
    return buf.getvalue()


def _jax_blob(family, model, params, variant):
    if variant != "f32":
        model, params = JS.bf16_variant(model, params)
    kw = dict(batch_size=BATCH, max_len=MAX_LEN, platforms=("cpu",),
              weights_int8=variant == "bf16+int8")
    if family == "dialoguernn":
        return JS.export_dialoguernn_classifier(model, params, buckets=BUCKETS, **kw)
    return JS.export_meld_classifier(model, params, **kw)


@pytest.fixture(scope="module")
def blobs(jax_models):
    """(family, variant) -> (port artifact, JAX artifact), made on first use."""
    cache = {}

    def get(family, variant):
        if (family, variant) not in cache:
            jm, params = jax_models[family]
            cache[family, variant] = (_port_blob(family, _port_model(family, params), variant),
                                      _jax_blob(family, jm, params, variant))
        return cache[family, variant]

    return get


# (a) the artifacts against the JAX package's


@pytest.mark.parametrize("variant", ["f32", "bf16", "bf16+int8"])
@pytest.mark.parametrize("family", ["dialoguernn", "meld"])
def test_artifact_matches_jax_artifact(blobs, family, variant):
    """On the grid (L 8, B 4) and off it (L 5, B 3: the DialogueRNN family
    pads both to (8, 4); the MELD family keeps L 5 and pads B)."""
    port_blob, jax_blob = blobs(family, variant)
    port = S.ServingClassifier.loads(port_blob, device="cpu")
    ref = JS.ServingClassifier.loads(jax_blob)
    assert port.family == ref.family == FAMILY[family]
    assert (port.dtype, port.weights) == (ref.dtype, ref.weights)
    n_classes = 6 if family == "dialoguernn" else 7
    for L, B in ((8, BATCH), (5, 3)):
        assert port._quantized_shape(L, B) == ref._quantized_shape(L, B)
        xs = _inputs(family, L, B, seed=L + B)
        got = port.log_probs(*xs)
        assert got.shape == (L, B, n_classes) and got.dtype == np.float32
        err = np.abs(got - ref.log_probs(*xs)).max()
        assert err <= TOL[variant], (L, B, err)


@pytest.mark.parametrize("family", ["dialoguernn", "meld"])
def test_metadata_keeps_the_jax_keys(blobs, family):
    port_blob, jax_blob = blobs(family, "f32")
    port = torch.load(io.BytesIO(port_blob), weights_only=True)["meta"]
    ref = JS.ServingClassifier.loads(jax_blob).meta
    assert set(port) == set(ref) - {"jax_version", "platforms"} | {"config"}
    for k in set(port) - {"config"}:
        assert port[k] == ref[k], k
    if family == "dialoguernn":
        assert port["inputs"][3:] == [{"name": "qmask", "kind": "qmask", "dim": 2},
                                      {"name": "umask", "kind": "umask", "dim": None}]
        assert port["has_valid_len"] and port["time_quantize"]
        assert port["config"] == dict(D_m=100, **DRNN_KW, D_h=100, n_classes=6,
                                      listener_state=False, context_attention="general",
                                      gen_num_layers=1)
    else:
        assert [s["name"] for s in port["inputs"]] == ["text", "qmask", "umask"]
        assert not port["has_valid_len"] and not port["time_quantize"]
        assert port["buckets"] == [] and port["label_names"][1] == "surprise"
        assert port["config"] == dict(**MELD_KW, n_classes=7, att2=True)


def test_exporters_take_their_family_only():
    meld = MELDLSTMModel(**MELD_KW, device="cpu")
    for export in (S.export_classifier, S.export_dialoguernn_classifier):
        with pytest.raises(TypeError, match="takes a"):
            export(meld, io.BytesIO())
    with pytest.raises(TypeError, match="takes a MELDLSTMModel"):
        S.export_meld_classifier(GAN_FFN(gen_num_layers=1, device="cpu"), io.BytesIO())


@pytest.mark.parametrize("family", ["dialoguernn", "meld"])
def test_bf16_variant_keeps_the_model(jax_models, family):
    model = _port_model(family, jax_models[family][1]).train()
    variant = S.bf16_variant(model)
    assert type(variant) is type(model) and variant.training
    assert variant.dtype == torch.bfloat16
    assert S.model_config(variant) == S.model_config(model)
    for k in type(model).DROPOUTS:
        assert getattr(variant, k) == getattr(model, k)
    assert all(p.dtype == torch.bfloat16 for p in variant.parameters())


# (b) padding


def test_dialoguernn_time_and_batch_padding_is_output_preserving(blobs):
    """A request of (L 5, B 3) with dialogues of 5, 2 and 4 utterances runs
    padded to (8, 4) with zero umask and qmask, and gives the exact shape's
    log-probs on every row."""
    blob = blobs("dialoguernn", "f32")[0]
    padded = S.ServingClassifier.loads(blob, device="cpu")
    exact = S.ServingClassifier.loads(blob, device="cpu", quantize=False)
    assert padded._quantized_shape(5, 3) == (8, BATCH)
    xs = _inputs("dialoguernn", 5, 3, seed=4, lengths=[5, 2, 4])
    np.testing.assert_allclose(padded.log_probs(*xs), exact.log_probs(*xs), rtol=0, atol=1e-5)


def test_meld_time_padding_would_change_real_rows(jax_models, blobs):
    """Padding time with zero features and a zero umask moves the real
    rows' log-probs (the reverse LSTM reads the padded tail first), so the
    artifact runs the exact request length and pads only the batch, which
    changes no row."""
    model = _port_model("meld", jax_models["meld"][1])
    xs = _inputs("meld", 5, 3, seed=5)
    padded = [np.pad(xs[0], ((0, 3), (0, 0), (0, 0))), np.pad(xs[1], ((0, 3), (0, 0), (0, 0))),
              np.pad(xs[2], ((0, 0), (0, 3)))]
    with torch.no_grad():
        exact_lp = model(*map(torch.from_numpy, xs))[0].numpy()
        padded_lp = model(*map(torch.from_numpy, padded))[0][:5].numpy()
    assert np.abs(padded_lp - exact_lp).max() > 1e-3
    clf = S.ServingClassifier.loads(blobs("meld", "f32")[0], device="cpu")
    assert clf._quantized_shape(5, 3) == (5, BATCH)
    np.testing.assert_allclose(clf.log_probs(*xs), exact_lp, rtol=0, atol=1e-5)


def test_meld_warmup_needs_lengths(blobs):
    clf = S.ServingClassifier.loads(blobs("meld", "f32")[0], device="cpu", batch_grid=(1, 4))
    with pytest.raises(ValueError, match="exact time lengths"):
        clf.warmup()
    assert [(L, B) for L, B, _ in clf.warmup(lengths=(5, 9))] == [(5, 1), (5, 4), (9, 1), (9, 4)]


def test_requests_are_checked_by_kind(blobs):
    clf = S.ServingClassifier.loads(blobs("dialoguernn", "f32")[0], device="cpu")
    a, v, t, qm, um = _inputs("dialoguernn", 8, 2)
    with pytest.raises(ValueError, match="takes 5 tensors"):
        clf.log_probs(a, v, t)
    with pytest.raises(ValueError, match="must agree"):
        clf.log_probs(a, v, t, qm, um.T)  # (L, B) instead of (B, L)
    with pytest.raises(ValueError, match="rank-2"):
        clf.log_probs(a, v, t, qm, um[None])
    with pytest.raises(ValueError, match="qmask last dim must be 2"):
        clf.log_probs(a, v, t, qm[..., :1], um)


def test_int8_weights_match_jax_on_the_lstm(jax_models):
    """``quantize_weights_int8`` on the LSTM's sixteen weights: the JAX
    package's int8 values and scales bit for bit, transposed (a port row is
    a JAX column)."""
    lstm = jax_models["meld"][1]["lstm"]
    names = sorted(k for k in lstm if k.startswith("w_"))
    assert len(names) == 16
    qflat, _, n = JS.quantize_weights_int8({k: lstm[k] for k in names})
    assert n == 16
    port = S.quantize_weights_int8({k: torch.from_numpy(lstm[k].T.copy()) for k in names})
    for k, (q, scale) in zip(names, qflat):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(q).T, err_msg=k)
        np.testing.assert_array_equal(port[k + S.SCALE].numpy()[:, 0], np.asarray(scale)[0],
                                      err_msg=k)


# (c) the CLIs


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A GAN_save/ with a MELD classifier trained by cli/train_meld (2
    epochs, published widths) and a depth-1 DialogueRNN classifier of
    seeded weights."""
    tmp = tmp_path_factory.mktemp("families")
    data = write_synthetic_meld(str(tmp / "meld.pkl"), n_train=24, n_test=8, max_len=16, seed=3)
    meld_cli.main(["--data-path", data, "--device", "cpu", "--epochs", "2",
                   "--model-save-path", str(tmp / "GAN_save")])
    model = GAN_FFN_DialogueRNN(n_classes=6, gen_num_layers=1,
                                generator=torch.Generator().manual_seed(0), device="cpu")
    torch.save(model.state_dict(), tmp / "GAN_save" / "dialoguernn_classifier_best.pt")
    return tmp


@pytest.mark.parametrize("dtype,weights", [("f32", "native"), ("bf16", "native"),
                                           ("bf16", "int8")])
@pytest.mark.parametrize("family", ["dialoguernn", "meld"])
def test_export_cli_verifies_each_variant(checkpoints, family, dtype, weights, capsys):
    out = checkpoints / f"{family}_{dtype}_{weights}.pt"
    res = export_cli.main(["--model", family, "--model-save-path", str(checkpoints / "GAN_save"),
                           "--output", str(out), "--num-layers", "1", "--batch-size", str(BATCH),
                           "--max-len", str(MAX_LEN), "--buckets", "8", "16", "--dtype", dtype,
                           "--weights", weights, "--verify", "--device", "cpu"])
    assert "verify on cpu" in capsys.readouterr().out
    assert res["family"] == FAMILY[family] and res["bytes"] == out.stat().st_size
    assert res["verify"]["max_abs_err"] <= (1e-4 if dtype == "f32" else 5e-2)
    assert res["verify"]["agree"] >= 0.98 * res["verify"]["total"]
    clf = S.ServingClassifier.load(out, device="cpu")
    assert clf.weights == ("int8" if weights == "int8" else clf.dtype)
    assert clf.meta["n_classes"] == (6 if family == "dialoguernn" else 7)


class _FakeServer:
    def __init__(self, addr, handler):
        self.server_port = addr[1]

    def serve_forever(self):
        raise KeyboardInterrupt

    def shutdown(self):
        pass


def test_serve_cli_warmup_lengths(blobs, tmp_path, monkeypatch, capsys):
    path = tmp_path / "meld.pt"
    path.write_bytes(blobs("meld", "f32")[0])
    monkeypatch.setattr(serve_cli, "ThreadingHTTPServer", _FakeServer)
    argv = ["--artifact", str(path), "--device", "cpu", "--port", "0", "--warmup"]
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(argv)
    assert exc.value.code == 2 and "exact time lengths" in capsys.readouterr().err
    serve_cli.main(argv + ["--warmup-lengths", "5,9"])
    out = capsys.readouterr().out
    assert "family meld_lstm" in out
    assert f"warmup L=5 B={BATCH}" in out and f"warmup L=9 B={BATCH}" in out


@pytest.mark.parametrize("family", ["dialoguernn", "meld"])
def test_http_handler_serves_the_family(blobs, family):
    from http.server import ThreadingHTTPServer

    clf = S.ServingClassifier.loads(blobs(family, "f32")[0], device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve_cli.make_handler(clf))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.load(resp)
        assert health["family"] == FAMILY[family]
        assert health["inputs"] == list(clf.input_names)
        xs = _inputs(family, 6, 2, seed=7)
        body = {name: x.tolist() for name, x in zip(clf.input_names, xs)}
        req = urllib.request.Request(f"{base}/predict", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.load(resp)
        assert got["classes"] == clf.predict(*xs).T.tolist()
        assert got["class_names"] == clf.predict_names(*xs)
        del body["umask"]  # a family's input missing: 400
        req = urllib.request.Request(f"{base}/predict", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        assert exc.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
