"""The harness's own arithmetic and guards: the dialogue lengths, the traced
window's clock, the launch guard, and a cell whose entry reads no value of a
listed end-to-end metric."""

import numpy as np
import pytest

from portbench.lib import RunError, datagen, harness, trace

from .tiny import CELLS, run_tiny


@pytest.mark.parametrize("name", ["stage_a.b32", "train.b30"])
def test_lengths_match_the_iemocap_train_split(name):
    traffic = harness.traffic(name)
    lengths = [np.sort(datagen.make_split(traffic, seed).lengths) for seed in (1, 2**33 + 5)]
    assert np.array_equal(lengths[0], lengths[1])  # every seed the same multiset
    assert (len(lengths[0]), int(lengths[0].sum()), int(lengths[0].max())) == (120, 5810, 110)
    assert int(lengths[0].min()) == traffic["length_min"]


@pytest.mark.parametrize("n,total,lo,hi", [(120, 5810, 8, 110), (12, 72, 3, 10), (5, 20, 2, 6)])
def test_fixed_lengths_hit_their_total_and_ends(n, total, lo, hi):
    out = datagen.fixed_lengths(n, total, lo, hi)
    assert (len(out), int(out.sum()), int(out.min()), int(out.max())) == (n, total, lo, hi)
    assert np.all(np.diff(out) >= 0)


def test_fixed_lengths_refuse_an_impossible_total():
    with pytest.raises(ValueError):
        datagen.fixed_lengths(10, 20, 3, 10)


def test_traced_window_is_the_device_span():
    tr = trace.Trace(device=[("a", 1.0, 1.5), ("b", 2.0, 2.25), ("Memcpy", 1.25, 1.75)],
                     spans=[])
    assert tr.span_s() == pytest.approx(1.25)
    assert tr.busy_s() == pytest.approx(1.0)
    assert trace.Trace(device=[], spans=[]).span_s() == 0.0


def test_launch_guard_refuses_a_missing_or_extra_call():
    counted = {"attention_fwd": 480, "mlp_fwd": 504, "mlp_bwd": 0}
    trace.check_calls({"attention_fwd": 480, "mlp_fwd": 504}, counted)
    with pytest.raises(RunError):
        trace.check_calls({"attention_fwd": 480, "mlp_fwd": 503}, counted)
    with pytest.raises(RunError):
        trace.check_calls({"attention_fwd": 480, "mlp_fwd": 504, "mlp_bwd": 2}, counted)


def test_a_listed_metric_that_no_entry_reads_fails_the_run(monkeypatch):
    bench = harness.load_bench()
    extra = {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock"}
    monkeypatch.setattr(harness, "load_bench",
                        lambda: dict(bench, end_to_end=bench["end_to_end"] + [extra]))
    with pytest.raises(RunError, match="serve_p95_ms"):
        run_tiny(CELLS[0])
