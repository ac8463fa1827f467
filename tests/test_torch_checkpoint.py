"""The port's checkpoints in the JAX package's format, held against
``flax.serialization`` and the JAX package on the CPU.

- ``utils/msgpack.py`` against flax's bytes, both ways, in bits (f32, int32
  scalars, bf16, complex, numpy scalars, an empty map, chunked leaves), and
  ``ValueError`` on truncated and malformed input;
- ``utils/weights.jax_params_from_state_dict`` and ``utils/checkpoint.py``
  for every family (``GAN_FFN``, ``GAN_FFN_DialogueRNN``,
  ``MELDLSTMModel``) at depth 1, in both encoder layouts: the JAX forward
  from the port's file and the port's forward from the JAX file agree within
  the bridge tests' tolerance (tests/test_torch_models.py ATOL 1e-4, here
  1e-5);
- the six stage-A networks and their Adams after two deterministic steps,
  both ways: weights and moments in bits, counts equal, and the third step's
  12 losses within 1e-5 relative of the other package's (the stage-A
  bridge's tolerance, tests/test_torch_gan.py), in bits within the port;
- the trainers across packages (a JAX trainer's directory feeds the port's
  ``--use-trained-GAN`` and ``cli/predict.py``, a port trainer's
  ``--scan-layers`` directory feeds the JAX's);
- ``--tensorboard`` (both cadences; ``make_grad_fn`` against JAX's within
  the stage-B gradient tolerance, rtol 1e-4, atol 1e-6) and ``--profile``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import flax.serialization as FS
import jax
import jax.numpy as jnp
import msgpack as msgpack_pkg
import numpy as np
import pytest
import torch

from gan_ffn_tpu.cli.common import IEMOCAP_LOSS_WEIGHTS, make_gan_ffn_apply_fns
from gan_ffn_tpu.models import GAN_FFN as JaxGAN_FFN
from gan_ffn_tpu.models import GAN_FFN_DialogueRNN as JaxGAN_FFN_DialogueRNN
from gan_ffn_tpu.models import MELDLSTMModel as JaxMELDLSTMModel
from gan_ffn_tpu.nn.transformer import stack_layer_params as jax_stack_layer_params
from gan_ffn_tpu.train import gan as JG
from gan_ffn_tpu.train.classifier import make_grad_fn as jax_make_grad_fn
from gan_ffn_tpu.train.loop import batch_to_arrays
from gan_ffn_tpu.utils import checkpoint as JC
from gan_ffn_tpu_torch.cli import predict as PREDICT
from gan_ffn_tpu_torch.cli import train_iemocap as CLI
from gan_ffn_tpu_torch.data import get_iemocap_loaders, write_synthetic_iemocap
from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN, MELDLSTMModel
from gan_ffn_tpu_torch.nn.core import set_dropout_generator
from gan_ffn_tpu_torch.train import gan as TG
from gan_ffn_tpu_torch.train.classifier import make_grad_fn
from gan_ffn_tpu_torch.train.loop import batch_to_tensors
from gan_ffn_tpu_torch.utils import checkpoint as TC
from gan_ffn_tpu_torch.utils import msgpack as M
from gan_ffn_tpu_torch.utils.weights import gan_state_dicts_from_jax, state_dict_from_jax
from test_torch_gan import EPS, _batch, _jax_deterministic_step, _port_state

REPO = Path(__file__).resolve().parents[1]
FWD_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the depth-1 steps and trainers here are small,
    and more threads beside the other test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _bits(leaf):
    """A leaf as (dtype name, shape, raw bytes); Python scalars as themselves."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        return str(t.dtype).replace("torch.", ""), tuple(t.shape), raw
    if isinstance(leaf, (complex, float, int)):
        return leaf
    a = np.asarray(leaf)
    return a.dtype.name, a.shape, a.tobytes()


def _same_tree(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert list(g) == list(w)
    for k in w:
        assert _bits(g[k]) == _bits(w[k]), k


def _jax_tree():
    rng = np.random.default_rng(0)
    return {
        "net": {"kernel": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
                "bias": np.asarray(rng.standard_normal(5), np.float32)},
        "count": jnp.asarray(7, jnp.int32),
        "half": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
        "complex": np.asarray(rng.standard_normal(3) + 1j * rng.standard_normal(3), np.complex64),
        "z": 1.5 - 2.25j,
        "scalar": np.float32(0.125),
        "ids": np.arange(24, dtype=np.int64).reshape(2, 3, 4),
        "empty": {},
    }


def _port_tree(tree):
    """The same leaves as the port writes them: numpy arrays, bf16 as a tensor."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _port_tree(v)
        elif getattr(v, "dtype", None) == jnp.bfloat16:
            out[k] = torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(torch.bfloat16)
        elif isinstance(v, jax.Array):
            out[k] = np.asarray(v)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_codec_reads_flax_bytes_in_bits(chunked, monkeypatch):
    """``flax.serialization.to_bytes`` read by the port: every leaf in bits,
    bf16 as a torch bfloat16 tensor, chunked leaves (flax's
    ``MAX_CHUNK_SIZE`` cut to 64 bytes here) joined; and the port writes
    the same bytes from the same leaves."""
    if chunked:
        monkeypatch.setattr(FS, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
    tree = _jax_tree()
    data = FS.to_bytes(tree)
    assert (M.CHUNKED.encode() in data) == chunked
    got = M.from_bytes(data)
    assert isinstance(got["half"], torch.Tensor) and got["half"].dtype == torch.bfloat16
    assert isinstance(got["scalar"], np.float32) and isinstance(got["z"], complex)
    _same_tree(got, _port_tree(tree))
    assert M.to_bytes(_port_tree(tree)) == data


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_flax_reads_port_bytes_in_bits(chunked, monkeypatch):
    """The port's bytes read by ``flax.serialization.from_bytes`` against the
    JAX template: every leaf in bits (bf16 from a torch tensor)."""
    if chunked:
        monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
    tree = _jax_tree()
    data = M.to_bytes(_port_tree(tree))
    assert (M.CHUNKED.encode() in data) == chunked
    got = FS.from_bytes(tree, data)
    assert np.asarray(got["half"]).dtype == jnp.bfloat16
    assert _bits(np.asarray(got["half"]).view(np.int16)) == _bits(
        np.asarray(tree["half"]).view(np.int16))
    _same_tree({k: v for k, v in got.items() if k != "half"},
               {k: v for k, v in tree.items() if k != "half"})


def _seeded_gan_ffn():
    return GAN_FFN(n_classes=6, gen_num_layers=1, generator=torch.Generator().manual_seed(0),
                   device="cpu")


def test_truncated_classifier_checkpoint_raises_value_error(tmp_path):
    """A ``classifier_best.msgpack`` written by the port, cut at 240 offsets
    spread over the file (and its first and last bytes): ``ValueError`` at
    each; the whole file loads back in bits."""
    model = _seeded_gan_ffn()
    path = TC.save_params(str(tmp_path / "classifier_best.msgpack"), model)
    data = Path(path).read_bytes()
    cuts = set(np.linspace(0, len(data) - 1, 240).astype(int).tolist()) | {1, 2, len(data) - 1}
    assert len(cuts) >= 200
    for cut in sorted(cuts):
        with pytest.raises(ValueError):
            M.from_bytes(data[:cut])
    loaded = TC.load_params_any_layout(path, GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _ext(code, payload):
    return msgpack_pkg.packb(msgpack_pkg.ExtType(code, payload))


@pytest.mark.parametrize("data", [
    b"",
    b"\xc1",
    M.packb({}) + b"\x00",
    b"\xdf\xff\xff\xff\xff",
    b"\x81\x90\x01",
    b"\xa2\xff\xfe",
    _ext(1, msgpack_pkg.packb([[2], "float32", b"\x00" * 4])),
    _ext(1, msgpack_pkg.packb([[1], "no_such_dtype", b"\x00" * 4])),
    _ext(1, msgpack_pkg.packb([[1], "object", b"\x00" * 8])),
    _ext(1, msgpack_pkg.packb([[-1], "float32", b""])),
    _ext(1, b"\x93\x91\x01"),
    _ext(2, msgpack_pkg.packb(["a", 1.0])),
    _ext(9, b"\x00"),
    b"\x91" * 600 + b"\xc0",
    M.packb({M.CHUNKED: True, "shape": {"0": 3}, "chunks": {"0": np.zeros(2, np.float32)}}),
], ids=["empty", "never-used", "trailing", "map-count", "list-key", "not-utf8",
        "ndarray-size", "dtype-name", "object-dtype", "negative-dim", "cut-payload",
        "complex-payload", "ext-code", "depth", "chunk-shape"])
def test_malformed_input_raises_value_error(data):
    with pytest.raises(ValueError):
        M.from_bytes(data)


# ---- every family's weights, both ways, both layouts ----

L, B = 8, 4
DRNN_KW = dict(D_m=100, D_g=16, D_p=16, D_e=8, D_h=100, D_a=7, n_classes=6)
MELD_KW = dict(D_m=24, D_e=8, D_h=24, n_classes=7)


def _inputs(family):
    rng = np.random.default_rng(1)
    feats = lambda d: rng.standard_normal((L, B, d)).astype(np.float32)  # noqa: E731
    umask = (np.arange(L)[None, :] < np.array([8, 6, 3, 1])[:, None]).astype(np.float32)
    if family == "gan_ffn":
        return [feats(100), feats(512), feats(100)]
    if family == "dialoguernn":
        qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (L, B))]
        return [feats(100), feats(512), feats(100), qmask, umask]
    return [feats(MELD_KW["D_m"]), np.eye(9, dtype=np.float32)[rng.integers(0, 9, (L, B))], umask]


def _models(family):
    if family == "gan_ffn":
        return (JaxGAN_FFN(n_classes=6, gen_num_layers=1),
                lambda g=None: GAN_FFN(n_classes=6, gen_num_layers=1, generator=g, device="cpu"))
    if family == "dialoguernn":
        return (JaxGAN_FFN_DialogueRNN(**DRNN_KW, gen_num_layers=1),
                lambda g=None: GAN_FFN_DialogueRNN(**DRNN_KW, gen_num_layers=1, generator=g,
                                                   device="cpu"))
    return (JaxMELDLSTMModel(**MELD_KW),
            lambda g=None: MELDLSTMModel(**MELD_KW, generator=g, device="cpu"))


def _forwards(family, jm, xs):
    kw = {"gan_ffn": {"valid_len": jnp.int32(L), "deterministic": True},
          "dialoguernn": {"valid_len": jnp.int32(L)}, "meld": {"deterministic": True}}[family]

    @jax.jit
    def apply(params):
        out = jm.apply({"params": params}, *map(jnp.asarray, xs), **kw)
        return out[0] if isinstance(out, tuple) else out

    def jax_fwd(params):
        return np.asarray(apply(jax.tree.map(jnp.asarray, params)))

    def port_fwd(model):
        with torch.no_grad():
            out = model.eval()(*map(torch.from_numpy, xs), valid_len=L)
        return (out[0] if isinstance(out, tuple) else out).numpy()

    return jax_fwd, port_fwd


@pytest.mark.parametrize("family,scan", [
    ("gan_ffn", False), ("gan_ffn", True), ("dialoguernn", False), ("dialoguernn", True),
    ("meld", False),  # no encoder layers to stack
], ids=["gan_ffn-unrolled", "gan_ffn-scanned", "dialoguernn-unrolled", "dialoguernn-scanned",
        "meld"])
def test_classifier_weights_cross_both_ways(family, scan, tmp_path):
    """JAX init -> the JAX ``save_params`` (stacked with ``scan``, as its
    trainers write under ``--scan-layers``) -> the port's
    ``load_params_any_layout``: the port's forward is the JAX one.  A seeded
    port module -> the port's ``save_params(scan_layers=scan)`` -> the JAX
    ``load_params_any_layout`` against its unrolled template: the JAX
    forward is the port's, and the weights come back in bits."""
    jm, make = _models(family)
    xs = _inputs(family)
    jax_fwd, port_fwd = _forwards(family, jm, xs)
    template = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), *map(jnp.asarray, xs))
                            ["params"])
    jfile = JC.save_params(str(tmp_path / "jax.msgpack"),
                           jax_stack_layer_params(template) if scan else template)
    model = TC.load_params_any_layout(jfile, make())
    np.testing.assert_allclose(port_fwd(model), jax_fwd(template), rtol=0, atol=FWD_ATOL)

    model = make(torch.Generator().manual_seed(3))
    pfile = TC.save_params(str(tmp_path / "port.msgpack"), model, scan_layers=scan)
    if scan:
        enc = TC.load_params(pfile)["text_generator"]["net"]["transformer_encoder"]
        assert list(enc) == ["layers"] and enc["layers"]["linear1"]["kernel"].shape[0] == 1
    jparams = JC.load_params_any_layout(pfile, template)
    np.testing.assert_allclose(jax_fwd(jparams), port_fwd(model), rtol=0, atol=FWD_ATOL)
    for k, v in state_dict_from_jax(jax.tree.map(np.asarray, jparams)).items():
        assert torch.equal(v, model.state_dict()[k]), k


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_leaves_keep_their_parameters_dtype(scan, tmp_path):
    """Each leaf is written in its parameter's dtype, as flax writes each
    leaf in its own: float32 parameters give float32 leaves (``all_float32``,
    the check that a ``--bf16`` trainer kept float32 parameters, holds),
    bfloat16 ones give bfloat16 leaves (it does not), which flax reads as
    bfloat16 and the port reads back in bits."""
    model = GAN_FFN(n_classes=6, gen_num_layers=1, generator=torch.Generator().manual_seed(3),
                    device="cpu")
    assert TC.all_float32(TC.save_params(str(tmp_path / "f32.msgpack"), model, scan_layers=scan))
    model = model.to(torch.bfloat16)
    path = TC.save_params(str(tmp_path / "bf16.msgpack"), model, scan_layers=scan)
    assert not TC.all_float32(path)
    with open(path, "rb") as f:
        leaves = jax.tree.leaves(FS.msgpack_restore(f.read()))
    assert leaves and all(np.asarray(v).dtype == jnp.bfloat16 for v in leaves)
    got = TC.read_state_dict(path)
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v.float()), k


# ---- the six stage-A networks and their Adams, after two steps ----

@pytest.fixture(scope="module")
def stage_a():
    """JAX depth-1 stage A: its weights, its deterministic step (eval-mode
    nets, Adam eps EPS), the batch, and the JAX state after two steps with
    the third step's losses."""
    cfg = JG.GANConfig(num_layers=1, aot_cache=False)
    params = jax.tree.map(np.asarray, JG.init_gan_state(cfg, jax.random.PRNGKey(5))["params"])
    jstep, jinit = _jax_deterministic_step(cfg)
    host, batch = _batch()
    jbatch = {**{k: jnp.asarray(v) for k, v in host.items()},
              "valid_len": jnp.asarray(batch["valid_len"], jnp.int32),
              "n_real": jnp.asarray(batch["n_real"], jnp.int32)}
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = {n: jinit[n](jparams[n]) for n in jparams}
    for _ in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, jbatch)
    _, _, third = jstep(jparams, jopt, jbatch)
    return {"params": params, "jstep": jstep, "jinit": jinit, "batch": batch, "jbatch": jbatch,
            "jstate": {"params": jparams, "opt": jopt}, "third": third}


def _port_losses(losses):
    return [losses[f"duel_{i}"].item() for i in range(12)]


def _assert_adam_equal(opt, module, jax_opt):
    """The port Adam's moments and steps against the JAX chain state."""
    mu, nu = (state_dict_from_jax(jax.tree.map(np.asarray, getattr(jax_opt[0], k)))
              for k in ("mu", "nu"))
    for name, p in module.named_parameters():
        state = opt.state[p]
        assert float(state["step"]) == int(jax_opt[0].count), name
        assert torch.equal(state["exp_avg"], mu[name]), name
        assert torch.equal(state["exp_avg_sq"], nu[name]), name


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_jax_gan_state_restores_into_the_port(stage_a, scan, tmp_path):
    """The JAX state after two steps, written by the JAX ``save_gan_state``
    (stacked with ``scan``), restored by the port's ``load_gan_state(...,
    reset_opt=False)``: weights, moments and counts in bits; the port's
    third step gives the JAX third step's 12 losses (1e-5 relative)."""
    jstate = stage_a["jstate"]
    if scan:
        jstate = {"params": jax_stack_layer_params(jstate["params"]),
                  "opt": jax_stack_layer_params(jstate["opt"])}
    JC.save_gan_state(str(tmp_path), jstate)
    state = _port_state(1, stage_a["params"])
    TC.load_gan_state(str(tmp_path), *state, reset_opt=False)
    want = gan_state_dicts_from_jax(jax.tree.map(np.asarray, stage_a["jstate"]["params"]))
    for name, module in state.modules.items():
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[name][k]), (name, k)
        _assert_adam_equal(state.opts[name], module, stage_a["jstate"]["opt"][name])
    losses = TG.make_gan_train_step(state.modules, state.opts, deterministic=True)(stage_a["batch"])
    np.testing.assert_allclose(_port_losses(losses), stage_a["third"], rtol=1e-5)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_port_gan_state_restores_into_jax_and_the_port(stage_a, scan, tmp_path):
    """The port's state after two steps, written by the port's
    ``save_gan_state(scan_layers=scan)``: the JAX ``load_gan_state(...,
    reset_opt=False)`` against its unrolled template restores the weights,
    moments and counts in bits and its third step gives the port's 12 losses
    (1e-5 relative); the port's own ``load_gan_state`` into fresh modules
    gives the third step without the round trip in bits."""
    state = _port_state(1, stage_a["params"])
    step = TG.make_gan_train_step(state.modules, state.opts, deterministic=True)
    for _ in range(2):
        step(stage_a["batch"])
    TC.save_gan_state(str(tmp_path), state, scan_layers=scan)
    if scan:
        enc = TC.load_params(str(tmp_path / "acoustic_gen.msgpack"))["net"]["transformer_encoder"]
        assert list(enc) == ["layers"]
    jparams = jax.tree.map(jnp.asarray, stage_a["params"])
    template = {"params": jparams, "opt": {n: stage_a["jinit"][n](p) for n, p in jparams.items()}}
    jstate = JC.load_gan_state(str(tmp_path), template, reset_opt=False)
    for name, module in state.modules.items():
        got = state_dict_from_jax(jax.tree.map(np.asarray, jstate["params"][name]))
        for k, v in module.state_dict().items():
            assert torch.equal(got[k], v), (name, k)
        _assert_adam_equal(state.opts[name], module, jstate["opt"][name])
    _, _, jax_third = stage_a["jstep"](jstate["params"], jstate["opt"], stage_a["jbatch"])

    fresh = _port_state(1, stage_a["params"])
    TC.load_gan_state(str(tmp_path), *fresh, reset_opt=False)
    again = TG.make_gan_train_step(fresh.modules, fresh.opts, deterministic=True)(stage_a["batch"])
    third = step(stage_a["batch"])
    assert _port_losses(again) == _port_losses(third)
    np.testing.assert_allclose(jax_third, _port_losses(third), rtol=1e-5)


# ---- --tensorboard and --profile ----

@pytest.fixture(scope="module")
def tb_runs(tmp_path_factory):
    """The flagship trainer, stage B only (2 epochs at depth 1), with
    ``--tensorboard`` at each cadence, ``--profile`` on the epoch cadence's
    run; each in its own working directory, with what it printed."""
    pytest.importorskip("tensorboard")
    root = tmp_path_factory.mktemp("tb")
    data = write_synthetic_iemocap(str(root / "iemocap.pkl"), n_train=12, n_test=4, min_len=4,
                                   max_len=20, seed=4)
    runs, printed = {}, {}
    for cadence in ("epoch", "batch"):
        cwd = root / cadence
        cwd.mkdir()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(io.StringIO()) as out:
            mp.chdir(cwd)
            CLI.main(["--data-path", data, "--GAN-epochs", "0", "--epochs", "2", "--num-layers",
                      "1", "--batch-size", "4", "--device", "cpu", "--tensorboard",
                      "--tb-grad-histograms", cadence]
                     + (["--profile", "prof"] if cadence == "epoch" else []))
        runs[cadence], printed[cadence] = cwd, out.getvalue()
    return data, runs, printed


@pytest.mark.parametrize("cadence", ["epoch", "batch"])
def test_tensorboard_logs_scalars_and_a_histogram_per_parameter(tb_runs, cadence):
    """``test: accuracy/loss`` and ``train: accuracy/loss`` at epochs 0 and
    1; one histogram per named parameter of ``GAN_FFN``, once per epoch
    (``epoch``) or once per train batch, tagged with the epoch (``batch``)."""
    from tb_events import read_events

    data, runs, _ = tb_runs
    scalars, hists = read_events(runs[cadence] / "tensorboard")
    assert scalars == {"test: accuracy/loss": [0, 1], "train: accuracy/loss": [0, 1]}
    n = 1 if cadence == "epoch" else len(get_iemocap_loaders(data, batch_size=4, valid=0.1,
                                                              seed=3407)[0])
    names = [k for k, _ in GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu").named_parameters()]
    assert hists == {k: [0] * n + [1] * n for k in names}


def test_profile_writes_a_trace_only_when_asked(tb_runs):
    """``--profile prof``: one torch.profiler trace of stage B's epoch 1 in
    ``prof``, naming the train step's ops and the port's ``gan_ffn.`` spans,
    and one printed line of the epoch's regions: a step, forward, backward
    and optimizer per train batch.  Without it, no trace file and no line,
    and tracing is off after either run."""
    from gan_ffn_tpu_torch.utils import profiling

    data, runs, printed = tb_runs
    (trace,) = (runs["epoch"] / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    names = {e.get("name", "") for e in events}
    assert {"gan_ffn.step", "gan_ffn.forward", "gan_ffn.backward", "gan_ffn.optimizer",
            "gan_ffn.batch_to_tensors", "gan_ffn.fetch"} <= names
    assert not list(runs["batch"].rglob("*.pt.trace.json"))
    (line,) = [json.loads(s) for s in printed["epoch"].splitlines() if s.startswith('{"profile"')]
    n = len(get_iemocap_loaders(data, batch_size=4, valid=0.1, seed=3407)[0])
    regions = line["profile"]["regions"]
    assert {k: v["count"] for k, v in regions.items()} == {
        "gan_ffn.step": n, "gan_ffn.forward": n, "gan_ffn.backward": n, "gan_ffn.optimizer": n}
    assert all(v["ms"] > 0 for v in regions.values())
    assert line["profile"]["entries"] == 8 * n and line["profile"]["dropped"] == 0
    assert '{"profile"' not in printed["batch"] and not profiling.enabled()


def test_grad_fn_matches_jax_and_leaves_the_training_draws(tmp_path):
    """With dropout off, the port's ``make_grad_fn`` gives the JAX
    ``make_grad_fn``'s gradients through the weight bridge (rtol 1e-4, atol
    1e-6), keyed by ``named_parameters()``, without touching ``.grad``;
    with dropout on it leaves torch's RNG and the model's seed generator
    where they were."""
    data = write_synthetic_iemocap(str(tmp_path / "iemocap.pkl"), n_train=8, n_test=2,
                                   min_len=4, max_len=12, seed=5)
    batch = next(iter(get_iemocap_loaders(data, batch_size=4, valid=0.0, seed=0)[0]))
    arrays = batch_to_arrays(batch)
    jm = JaxGAN_FFN(n_classes=6, gen_num_layers=1)
    params = jm.init(jax.random.PRNGKey(0), arrays["audio"], arrays["visual"],
                     arrays["text"])["params"]
    _, apply_eval = make_gan_ffn_apply_fns(jm)
    weights = jnp.asarray(IEMOCAP_LOSS_WEIGHTS)
    want = jax_make_grad_fn(lambda p, rng, b: apply_eval(p, b), 6, weights)(
        params, jax.random.PRNGKey(1), arrays)
    want = state_dict_from_jax(jax.tree.map(np.asarray, want))
    model = GAN_FFN(n_classes=6, gen_num_layers=1, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    tensors = batch_to_tensors(batch, "cpu")
    loss_weights = torch.from_numpy(IEMOCAP_LOSS_WEIGHTS)
    got = make_grad_fn(model, 6, loss_weights, deterministic=True)(tensors)
    assert list(got) == [k for k, _ in model.named_parameters()] and set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    assert all(p.grad is None for p in model.parameters())

    generator = torch.Generator().manual_seed(9)
    set_dropout_generator(model, generator)
    torch.manual_seed(10)
    rng, seeds = torch.get_rng_state(), generator.get_state()
    make_grad_fn(model, 6, loss_weights, seed=3)(tensors)
    assert torch.equal(torch.get_rng_state(), rng) and torch.equal(generator.get_state(), seeds)


# ---- the trainers across the packages ----

JAX_RUNS = r"""
import importlib, json, os, sys
out = {}
for name, module, cwd, argv in json.loads(sys.argv[1]):
    os.chdir(cwd)
    res = importlib.import_module(module).main(argv)
    out[name] = {k: v for k, v in res.items() if isinstance(v, (int, float, str))}
print("RESULT " + json.dumps(out))
"""


def _start_jax_runs(runs):
    """Start the JAX CLIs ``runs`` ((name, module, cwd, argv), ...), one
    after another in one subprocess, on one thread, their executables
    cached on disk (``GANFFN_EXEC_CACHE_CPU``: a later run of the same
    shapes compiles nothing)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "GANFFN_EXEC_CACHE_CPU": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    return subprocess.Popen([sys.executable, "-c", JAX_RUNS, json.dumps(runs)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


TINY = ["--num-layers", "1", "--batch-size", "4", "--epochs", "1"]


@pytest.fixture(scope="module", autouse=True)
def _jax_trainers(tmp_path_factory):
    """Started before this file's first test, so that the JAX subprocess
    runs beside the others: the port's trainer writes its directory with
    ``--scan-layers``, then one JAX subprocess runs the JAX trainer into a
    directory of its own (stage A of 1 epoch, stage B of 1), the JAX
    ``cli/predict.py`` on the port's classifier, and the JAX trainer's
    ``--use-trained-GAN`` from a copy of the port's directory."""
    root = tmp_path_factory.mktemp("crossed")
    data = write_synthetic_iemocap(str(root / "iemocap.pkl"), n_train=10, n_test=4,
                                   min_len=4, max_len=20, seed=0)
    dirs = {name: root / name for name in ("jax", "port", "jax_from_port", "port_from_jax")}

    def argv(d, *extra):
        return ["--data-path", data, "--output-dir", str(d / "output"),
                "--model-save-path", str(d / "GAN_save"), *TINY, *extra]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = CLI.main(argv(dirs["port"], "--GAN-epochs", "1", "--device", "cpu",
                             "--scan-layers"))
    finally:
        torch.set_num_threads(threads)
    shutil.copytree(dirs["port"], dirs["jax_from_port"])
    dirs["jax"].mkdir()
    predict = ["--data-path", data, "--num-layers", "1", "--batch-size", "4"]
    proc = _start_jax_runs([
        ["trainer", "gan_ffn_tpu.cli.train_iemocap", str(dirs["jax"]),
         argv(dirs["jax"], "--GAN-epochs", "1")],
        ["predict", "gan_ffn_tpu.cli.predict", str(dirs["port"]),
         predict + ["--model-save-path", str(dirs["port"] / "GAN_save")]],
        ["trainer_from_port", "gan_ffn_tpu.cli.train_iemocap", str(dirs["jax_from_port"]),
         argv(dirs["jax_from_port"], "--use-trained-GAN", "--continue-train-GAN-step", "0")]])
    try:
        yield {"proc": proc, "argv": argv, "predict": predict, "port_result": port, **dirs}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def crossed(_jax_trainers):
    """The JAX subprocess's results; then the port's trainer runs
    ``--use-trained-GAN`` from a copy of the JAX trainer's directory and
    the port's ``cli/predict.py`` reads the JAX's classifier."""
    run = _jax_trainers
    log = run["proc"].communicate(timeout=900)[0]
    assert run["proc"].returncode == 0, log[-5000:]
    jax_runs = json.loads(next(l for l in log.splitlines() if l.startswith("RESULT "))[7:])
    shutil.copytree(run["jax"], run["port_from_jax"])
    grafted = {}
    make_steps = CLI.make_classifier_steps

    def capture(model, *args, **kw):
        grafted.update({k: v.clone() for k, v in model.state_dict().items()})
        return make_steps(model, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CLI, "make_classifier_steps", capture)
        port_from = CLI.main(run["argv"](run["port_from_jax"], "--use-trained-GAN",
                                         "--continue-train-GAN-step", "0", "--device", "cpu"))
    port_predict = PREDICT.main(run["predict"] + ["--model-save-path",
                                                  str(run["jax"] / "GAN_save"), "--device", "cpu"])
    return {**run, "jax_runs": jax_runs, "port_from_jax_result": port_from, "grafted": grafted,
            "port_predict": port_predict}


def _report_f1(directory):
    (report,) = (directory / "output").glob("test_out_GAN-epochs=*_F1-score=*.txt")
    return float(report.name.split("F1-score=")[1][:-4])


def test_port_trainer_trains_stage_b_from_a_jax_stage_a(crossed):
    """The port's flagship trainer with ``--use-trained-GAN`` on the JAX
    trainer's directory: its ``GAN_FFN`` starts from the JAX stage A's three
    generators in bits and trains stage B to a report; the port's
    ``cli/predict.py`` on the JAX's ``classifier_best.msgpack`` gives the JAX
    trainer's best-epoch F1."""
    assert np.isfinite(crossed["port_from_jax_result"]["best_loss"])
    for clf_key, gan_key in (("acoustic_generator", "acoustic_gen"),
                             ("visual_generator", "visual_gen"), ("text_generator", "text_gen")):
        for k, v in TC.read_state_dict(crossed["jax"] / "GAN_save" / f"{gan_key}.msgpack").items():
            assert torch.equal(crossed["grafted"][f"{clf_key}.{k}"], v), (gan_key, k)
    assert crossed["port_predict"]["f1"] == _report_f1(crossed["jax"])
    assert crossed["jax_runs"]["trainer"]["f1"] == _report_f1(crossed["jax"])


def test_jax_trainer_and_predict_read_the_port_files(crossed):
    """The port trainer's ``--scan-layers`` directory (stacked encoders):
    the JAX ``cli/predict.py`` reads its ``classifier_best.msgpack`` and
    gives the port trainer's best-epoch F1; the JAX trainer's
    ``--use-trained-GAN`` loads its six networks (and their Adams' files)
    and trains stage B to a report."""
    save = crossed["port"] / "GAN_save"
    assert list(TC.load_params(save / "classifier_best.msgpack")["text_generator"]["net"][
        "transformer_encoder"]) == ["layers"]
    assert crossed["jax_runs"]["predict"]["f1"] == crossed["port_result"]["f1"]
    assert np.isfinite(crossed["jax_runs"]["trainer_from_port"]["best_loss"])
    assert len(list((crossed["jax_from_port"] / "output").glob("test_out_*.txt"))) == 2


