"""The port's tracing (``gan_ffn_tpu_torch/utils/profiling.py``): the switch,
the host spans, the regions and their logs.

On the CPU a region's stamps are ``time.perf_counter_ns()`` in a host log of
the same kind as a card's:

- off, a step leaves nothing to collect, no stamp is made and the stamp
  library is not loaded;
- on, a classifier train step (``GAN_FFN`` and ``GAN_FFN_DialogueRNN``, per
  batch and epoch-fused) gives one ``gan_ffn.step`` holding forward, backward
  and optimizer in turn, the optimizer region around the Adam step; an eval
  step gives its ``gan_ffn.step`` alone; a stage-A step (per batch and
  epoch-fused) gives one ``gan_ffn.step`` and nothing inside it;
- a step's losses and updates are the same bits with tracing on and off;
- a full log drops and counts; the decoder nests regions by name.

The tests marked ``cuda_hardware`` skip here and run on a card
(``python -m pytest --noconftest -q tests/test_torch_tracing.py``): three
replays of a captured step append three times the entries of one, and the
stamp kernels of a torch.profiler trace pair one to one with the log's
entries, on one line from ``%globaltimer`` to the trace's clock within 10 us.
"""

import numpy as np
import pytest
import torch

from gan_ffn_tpu_torch.cli.common import gan_batch_from
from gan_ffn_tpu_torch.data.loaders import Batch
from gan_ffn_tpu_torch.models import GAN_FFN, GAN_FFN_DialogueRNN
from gan_ffn_tpu_torch.nn.core import set_dropout_generator
from gan_ffn_tpu_torch.ops import _build
from gan_ffn_tpu_torch.ops.dropout import StepSeeds
from gan_ffn_tpu_torch.train.classifier import make_classifier_epoch_steps, make_classifier_steps
from gan_ffn_tpu_torch.train.gan import (GANConfig, init_gan_state, make_gan_epoch_step,
                                         make_gan_train_step)
from gan_ffn_tpu_torch.train.graphs import ShapeGraphs
from gan_ffn_tpu_torch.train.loop import batch_to_tensors
from gan_ffn_tpu_torch.train.optim import torch_adam
from gan_ffn_tpu_torch.utils import profiling as P

L, B, C = 12, 3, 6
DRNN_KW = dict(D_m=100, D_g=16, D_p=16, D_e=8, D_h=100, D_a=7, n_classes=C)
STEPS = {"stage_a": (make_gan_train_step, make_gan_epoch_step),
         "dialoguernn": (make_classifier_steps, make_classifier_epoch_steps)}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and the logs empty."""
    P.enable(False)
    P.collect()
    yield
    P.enable(False)
    P.collect()


def _host_batch(seed: int) -> Batch:
    rng = np.random.default_rng(seed)
    umask = (np.arange(L)[None, :] < np.array([L, 7, 4])[:, None]).astype(np.float32)
    feats = {k: (rng.standard_normal((L, B, d)) * umask.T[:, :, None]).astype(np.float32)
             for k, d in (("text", 100), ("audio", 100), ("visual", 512))}
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (L, B))] * umask.T[:, :, None]
    label = (rng.integers(0, C, (B, L)) * umask).astype(np.int32)
    return Batch(feats["text"], feats["audio"], qmask, umask, label, ["a", "b", "c"],
                 feats["visual"], n_real=B)


def _stage_a(graphed: bool, seed: int = 0):
    """A depth-1 stage-A step with every dropout on, its state and a batch."""
    state = init_gan_state(GANConfig(num_layers=1), device="cpu")
    seeds = StepSeeds(torch.Generator().manual_seed(seed))
    for module in state.modules.values():
        set_dropout_generator(module, seeds)
    step = STEPS["stage_a"][graphed](state.modules, state.opts)
    params = [p for m in state.modules.values() for p in m.parameters()]
    return step, state.opts, params, gan_batch_from(batch_to_tensors(_host_batch(1), "cpu"))


def _classifier(graphed: bool, seed: int = 0, model_cls=GAN_FFN_DialogueRNN):
    """A depth-1 classifier (``GAN_FFN_DialogueRNN`` or ``GAN_FFN``) train
    step with every dropout on, its optimizer, parameters and a batch; and
    its eval step."""
    kw = DRNN_KW if model_cls is GAN_FFN_DialogueRNN else {"n_classes": C}
    model = model_cls(**kw, gen_num_layers=1, generator=torch.Generator().manual_seed(2),
                      device="cpu")
    set_dropout_generator(model, torch.Generator().manual_seed(seed))
    opt = torch_adam(model.parameters(), 1e-3)
    train, evaluate = STEPS["dialoguernn"][graphed](model, opt, C)
    step = train
    step.eval_step = evaluate
    return step, {"model": opt}, list(model.parameters()), batch_to_tensors(_host_batch(1), "cpu")


def _run(kind: str, graphed: bool):
    torch.manual_seed(3)  # torch's own dropout draws
    step, opts, params, batch = (_stage_a if kind == "stage_a" else _classifier)(graphed)
    out = step(batch)
    return step, opts, params, batch, out


def _outputs(out) -> list:
    return list(out.values()) if isinstance(out, dict) else list(out)


@pytest.mark.parametrize("kind", ["stage_a", "dialoguernn"])
def test_off_leaves_no_trace(kind, monkeypatch):
    """Off: a step through ``ShapeGraphs`` leaves nothing to collect, makes
    no stamp and leaves the stamp library unloaded."""
    stamps = []
    monkeypatch.setattr(P, "_stamp", lambda tag, device: stamps.append(tag))
    _run(kind, graphed=True)
    got = P.collect()
    assert got.entries == {} and got.regions == [] and got.dropped == 0
    assert stamps == []
    assert P._stamp_fn is None and ("trace_stamp", "gan_trace_stamp") not in _build._functions


def _inside(inner: P.Region, outer: P.Region) -> bool:
    return outer.begin_ns <= inner.begin_ns <= inner.end_ns <= outer.end_ns


@pytest.mark.parametrize("model_cls", [GAN_FFN, GAN_FFN_DialogueRNN],
                         ids=["gan_ffn", "dialoguernn"])
@pytest.mark.parametrize("graphed", [False, True], ids=["per_batch", "epoch_fused"])
def test_classifier_step_holds_forward_backward_optimizer(graphed, model_cls):
    """A train step: forward, backward and optimizer in turn inside one
    ``gan_ffn.step``, the optimizer region around the Adam step; an eval
    step: its ``gan_ffn.step`` alone."""
    P.enable()
    step, opts, _, batch = _classifier(graphed, model_cls=model_cls)
    updates = []
    inner = opts["model"].step

    def stepper(*args, **kw):
        updates.append(P.time.perf_counter_ns())
        return inner(*args, **kw)

    opts["model"].step = stepper
    step(batch)
    got = P.collect()
    assert got.dropped == 0 and list(got.entries) == ["cpu"]
    regions = got.regions
    assert [(r.name, r.inside) for r in regions] == [
        (P.STEP, ()), (P.FORWARD, (P.STEP,)), (P.BACKWARD, (P.STEP,)),
        (P.OPTIMIZER, (P.STEP,))]
    outer, parts = regions[0], regions[1:]
    assert all(_inside(r, outer) for r in parts)
    assert all(a.end_ns <= b.begin_ns for a, b in zip(parts, parts[1:]))
    (t,) = updates
    assert parts[2].begin_ns <= t <= parts[2].end_ns
    report = P.report(got)
    assert report["entries"] == 8 and report["dropped"] == 0
    assert {k: v["count"] for k, v in report["regions"].items()} == {
        P.STEP: 1, P.FORWARD: 1, P.BACKWARD: 1, P.OPTIMIZER: 1}
    step.eval_step(batch)
    assert [(r.name, r.inside) for r in P.collect().regions] == [(P.STEP, ())]


@pytest.mark.parametrize("graphed", [False, True], ids=["per_batch", "epoch_fused"])
def test_stage_a_step_is_one_step_region(graphed):
    """A stage-A step lies in one ``gan_ffn.step`` with no region inside it."""
    P.enable()
    step, _, _, batch = _stage_a(graphed)
    step(batch)
    got = P.collect()
    assert got.dropped == 0 and len(got.entries["cpu"]) == 2
    assert [(r.name, r.inside) for r in got.regions] == [(P.STEP, ())]


@pytest.mark.parametrize("kind", ["stage_a", "dialoguernn"])
@pytest.mark.parametrize("graphed", [False, True], ids=["per_batch", "epoch_fused"])
def test_tracing_changes_no_bit(kind, graphed):
    """The step's outputs and every parameter after it are the same bits
    with tracing on as off (every dropout on, the same seeds)."""
    runs = []
    for on in (False, True):
        P.enable(on)
        _, _, params, _, out = _run(kind, graphed)
        runs.append((_outputs(out), [p.detach().clone() for p in params]))
    assert P.collect().regions  # the second run traced
    (out_off, params_off), (out_on, params_on) = runs
    assert len(out_off) == len(out_on) and len(params_off) == len(params_on)
    assert all(torch.equal(a, b) for a, b in zip(out_off, out_on))
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))


def test_a_full_log_drops_and_counts(monkeypatch):
    """Entries past the capacity are dropped and counted; the regions whose
    two stamps were kept decode; collecting empties the log."""
    monkeypatch.setattr(P, "_host", P._HostLog(5))
    P.enable()
    for _ in range(4):
        with P.region(P.FORWARD, "cpu"):
            pass
    got = P.collect()
    assert len(got.entries["cpu"]) == 5 and got.dropped == 3
    assert [r.name for r in got.regions] == [P.FORWARD, P.FORWARD]
    assert P.report(got)["dropped"] == 3
    again = P.collect()
    assert again.entries == {} and again.dropped == 0


def test_decode_nests_by_name():
    """An end closes the innermost open region of its name; a begin or an
    end without its twin makes no region."""
    entries = [("s", 0, 0), ("f", 0, 1), ("x", 1, 2), ("b", 0, 3), ("f", 1, 4),
               ("sb", 0, 5), ("sb", 1, 6), ("b", 1, 7), ("o", 0, 8), ("s", 1, 9)]
    regions = P.decode(entries)
    assert [(r.name, r.begin_ns, r.end_ns, r.inside) for r in regions] == [
        ("s", 0, 9, ()), ("f", 1, 4, ("s",)), ("b", 3, 7, ("s",)), ("sb", 5, 6, ("s", "b"))]
    assert regions[1].ms == 3e-6


def test_spans_follow_the_switch():
    """``span`` and ``region`` are host spans in a torch.profiler trace
    while tracing is on, and no-ops while it is off."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("gan_ffn.off"), P.region("gan_ffn.off_region", "cpu"):
            pass
        P.enable()
        with P.span("gan_ffn.on"), P.region("gan_ffn.on_region", "cpu"):
            pass
    names = {e.name for e in prof.events()}
    assert {"gan_ffn.on", "gan_ffn.on_region"} <= names
    assert not {"gan_ffn.off", "gan_ffn.off_region"} & names


# ---- on a card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the trace stamp is a CUDA kernel and runs only on the card")
    return torch.device("cuda")


def _captured_step(device):
    """A ShapeGraphs step of one region around one op, run once (captured)."""
    def fn(batch):
        with P.region(P.FORWARD, device):
            return batch["x"] * 2.0

    step = ShapeGraphs(fn, "trace")
    batch = {"x": torch.ones(64, device=device)}
    step(batch)
    return step, batch


@pytest.mark.cuda_hardware
def test_replays_append_their_entries(cuda):
    """One replay appends the step's and its forward's stamps (4 entries);
    three replays append three times that, as three steps."""
    P.enable()
    step, batch = _captured_step(cuda)
    P.collect()
    step(batch)
    one = P.collect()
    for _ in range(3):
        step(batch)
    three = P.collect()
    assert one.dropped == three.dropped == 0
    assert len(one.entries["cuda:0"]) == 4
    assert len(three.entries["cuda:0"]) == 3 * len(one.entries["cuda:0"])
    assert [(r.name, r.inside) for r in three.regions] == [
        (P.STEP, ()), (P.FORWARD, (P.STEP,))] * 3


@pytest.mark.cuda_hardware
def test_stamps_pair_with_the_trace_kernels(cuda):
    """The stamp kernels of a torch.profiler trace of replays are the log's
    entries, one to one in order, and one line (an offset and a rate) maps
    the log's ``%globaltimer`` ns onto the trace's clock within 10 us.  The
    trace's clock runs up to ~1.2% off ``%globaltimer`` on an H100, so the
    rate is held only near 1, where a mispairing or a unit fault is not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    P.enable()
    step, batch = _captured_step(cuda)
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    P.collect()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(batch)
        torch.cuda.synchronize()
    entries = P.collect().entries["cuda:0"]
    starts = sorted(e.time_range.start * 1e3 for e in prof.events()
                    if e.device_type == DeviceType.CUDA and P.STAMP_KERNEL in e.name)
    assert len(starts) == len(entries) == 20
    x = np.array([ns - entries[0][2] for _, _, ns in entries], dtype=np.float64)
    y = np.array(starts) - starts[0]
    rate, offset = np.polyfit(x, y, 1)
    assert abs(rate - 1.0) < 0.05 and np.abs(y - (offset + rate * x)).max() <= 10e3
