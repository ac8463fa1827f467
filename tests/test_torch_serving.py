"""The port's serving path (gan_ffn_tpu_torch.serving, .cli.serve) against
the JAX package's.

A tiny 1-layer ``GAN_FFN`` is exported by the JAX package (StableHLO
artifact for the CPU) and, with the same weights carried across by the
bridge, by the port.  Both are served on the CPU and must agree on the grid,
off it and under ``batch_grid`` (atol 1e-4, as in test_torch_models.py), and
reject the same malformed requests.
"""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.serving import ServingClassifier as JaxServingClassifier
from gan_ffn_tpu.serving import export_classifier as jax_export_classifier
from gan_ffn_tpu_torch.cli.serve import make_handler
from gan_ffn_tpu_torch.models import GAN_FFN
from gan_ffn_tpu_torch.serving import ServingClassifier, export_classifier
from gan_ffn_tpu_torch.utils.weights import gan_ffn_state_dict_from_jax

MAX_LEN, BUCKETS, BATCH = 16, (8, 16), 4
ATOL = 1e-4
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGAN_FFN(n_classes=6, gen_num_layers=1)
    return model, model.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((8, BATCH, 100)), jnp.zeros((8, BATCH, 512)), jnp.zeros((8, BATCH, 100)),
    )["params"]


@pytest.fixture(scope="module")
def jax_blob(jax_params):
    model, params = jax_params
    return jax_export_classifier(
        model, params, max_len=MAX_LEN, batch_size=BATCH, buckets=BUCKETS, platforms=("cpu",)
    )


@pytest.fixture(scope="module")
def blob(jax_params, tmp_path_factory):
    port = GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu")
    port.load_state_dict(gan_ffn_state_dict_from_jax(jax_params[1]))
    path = tmp_path_factory.mktemp("artifact") / "gan_ffn.pt"
    export_classifier(port, path, max_len=MAX_LEN, batch_size=BATCH, buckets=BUCKETS)
    return path.read_bytes()


@pytest.fixture(scope="module")
def clf(blob):
    return ServingClassifier.loads(blob, device="cpu")


def _inputs(L, B, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((L, B, d)).astype(np.float32) for d in (100, 512, 100))


@pytest.mark.parametrize(
    "L,B,valid_len,grid",
    [
        (8, 4, None, None),     # on the grid
        (16, 8, None, None),    # on the grid, two batch multiples
        (5, 3, None, None),     # off the grid: padded and sliced back
        (11, 2, 7, None),       # off the grid, explicit valid_len
        (1, 1, None, (1, 2, 4)),  # batch_grid: B=1 runs a B=1 batch
        (9, 3, None, (1, 2, 4)),
        (13, 6, None, (1, 2, 4)),  # beyond the grid: batch_size multiples
    ],
)
def test_log_probs_match_jax_artifact(blob, jax_blob, L, B, valid_len, grid):
    port = ServingClassifier.loads(blob, device="cpu", batch_grid=grid)
    ref = JaxServingClassifier.loads(jax_blob, batch_grid=grid)
    assert port._quantized_shape(L, B) == ref._quantized_shape(L, B)
    xs = _inputs(L, B, seed=L + B)
    got = port.log_probs(*xs, valid_len=valid_len)
    want = ref.log_probs(*xs, valid_len=valid_len)
    assert got.shape == (L, B, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(port.predict(*xs, valid_len=valid_len),
                                  ref.predict(*xs, valid_len=valid_len))


def test_unquantized_exact_shapes_match(blob, jax_blob):
    port = ServingClassifier.loads(blob, device="cpu", quantize=False)
    ref = JaxServingClassifier.loads(jax_blob, quantize=False)
    xs = _inputs(7, 3, seed=5)
    np.testing.assert_allclose(port.log_probs(*xs), ref.log_probs(*xs), rtol=0, atol=ATOL)


def test_quantization_policy_matches_jax(blob, jax_blob):
    for grid in (None, (1, 4, 8, 32)):
        port = ServingClassifier.loads(blob, device="cpu", batch_grid=grid)
        ref = JaxServingClassifier.loads(jax_blob, batch_grid=grid)
        for L in (1, 8, 9, 16):
            for B in (1, 3, 4, 5, 33):
                assert port._quantized_shape(L, B) == ref._quantized_shape(L, B)


def test_metadata_keeps_the_jax_keys(clf, jax_blob):
    ref = JaxServingClassifier.loads(jax_blob)
    want = set(ref.meta) - {"jax_version", "platforms"}
    assert want <= set(clf.meta)
    for k in want:
        assert clf.meta[k] == ref.meta[k], k
    assert clf.meta["config"] == {"n_classes": 6, "D_h": 100, "gen_num_layers": 1}


def test_rejects_what_the_jax_classifier_rejects(clf, jax_blob):
    ref = JaxServingClassifier.loads(jax_blob)
    a, v, t = _inputs(8, 2)
    bad = {
        "max_len": _inputs(MAX_LEN + 1, 2),
        "must agree": (a, v[:, :1], t),
        "rank-3": (a[0], v, t),
        "last dim": (a, v[..., :500], t),
        "takes 3 tensors": (a, v),
    }
    for match, xs in bad.items():
        for c in (clf, ref):
            with pytest.raises(ValueError, match=match):
                c.log_probs(*xs)
    for grid in ((0, 4), ()):
        with pytest.raises(ValueError, match="batch_grid"):
            ServingClassifier(clf.meta, clf.model.state_dict(), device="cpu", batch_grid=grid)


def test_loader_rejects_bad_artifacts(clf, blob):
    with pytest.raises(ValueError, match="version"):
        ServingClassifier({**clf.meta, "version": 999}, clf.model.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="unknown serving family 'bogus'"):
        ServingClassifier({**clf.meta, "family": "bogus"}, clf.model.state_dict(), device="cpu")
    for junk in (b"NOT_AN_ARTIFACT", blob[: len(blob) // 2]):
        with pytest.raises(ValueError, match="serving artifact"):
            ServingClassifier.loads(junk, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            ServingClassifier.loads(blob)


def test_loader_rejects_truncation_at_every_boundary(blob):
    """An artifact cut at any boundary of its archive raises ValueError and
    nothing else (as tests/test_serving.py holds the JAX loader): the
    start, inside and end of every record's local header and data, the
    central directory and its end record."""
    import io
    import struct
    import zipfile

    cuts = {0, 1, len(blob) - 1}
    for info in zipfile.ZipFile(io.BytesIO(blob)).infolist():
        start = info.header_offset
        name_len, extra_len = struct.unpack("<HH", blob[start + 26:start + 30])
        data = start + 30 + name_len + extra_len
        end = data + info.compress_size
        cuts |= {start, start + 1, start + 29, data, data + 1, (data + end) // 2, end - 1, end}
    eocd = blob.rfind(b"PK\x05\x06")
    directory = struct.unpack("<I", blob[eocd + 16:eocd + 20])[0]
    cuts |= {directory, directory + 1, eocd, eocd + 1, eocd + 21}
    cuts = sorted(c for c in cuts if 0 <= c < len(blob))
    assert len(cuts) > 100
    for cut in cuts:
        with pytest.raises(ValueError, match="serving artifact"):
            ServingClassifier.loads(blob[:cut], device="cpu")


def test_predict_names_and_warmup(clf):
    xs = _inputs(6, 2, seed=9)
    ids = clf.predict(*xs)
    assert ids.shape == (6, 2) and ids.dtype == np.int32
    names = clf.predict_names(*xs)
    assert names == clf.names_for(ids) and len(names) == 2 and len(names[0]) == 6
    assert all(n in clf.label_names for row in names for n in row)
    grid = ServingClassifier(clf.meta, clf.model.state_dict(), device="cpu", batch_grid=(1, BATCH))
    assert [(L, B) for L, B, _ in grid.warmup()] == [(8, 1), (8, 4), (16, 1), (16, 4)]
    assert [(L, B) for L, B, _ in clf.warmup(lengths=(3, 8))] == [(8, 4)]
    with pytest.raises(ValueError, match="nothing to warm"):
        clf.warmup(lengths=())


def test_http_round_trip(clf):
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(clf))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"
    try:
        health = json.load(urllib.request.urlopen(f"{url}/healthz", timeout=30))
        assert health["status"] == "ok" and health["inputs"] == ["audio", "visual", "text"]
        assert health["device"] == "cpu"
        a, v, t = _inputs(5, 2, seed=3)
        body = json.dumps({"audio": a.tolist(), "visual": v.tolist(), "text": t.tolist(),
                           "valid_len": 4}).encode()
        req = urllib.request.Request(f"{url}/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        resp = json.load(urllib.request.urlopen(req, timeout=60))
        ids = clf.predict(a, v, t, valid_len=4)
        assert resp["classes"] == ids.T.tolist()
        assert resp["class_names"] == clf.names_for(ids)
        for payload, path in ((b"[1, 2]", "/predict"), (b"{}", "/predict"), (b"{}", "/nope")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(f"{url}{path}", data=payload), timeout=30)
            assert ei.value.code == (404 if path == "/nope" else 400)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_port_imports_nothing_of_jax():
    """Every module of gan_ffn_tpu_torch, and chip_smoke, import without
    pulling in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gan_ffn_tpu_torch\n"
        "for m in pkgutil.walk_packages(gan_ffn_tpu_torch.__path__, 'gan_ffn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'gan_ffn_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('gan_ffn_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
