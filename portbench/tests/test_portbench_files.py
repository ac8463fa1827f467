"""Every file the benchmark finds by name loads, and every name keeps to the
contract's characters."""

import importlib
import json
import re

import pytest

from .tiny import CHECKOUT

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_one_line_fields(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_loads_and_names_itself(entry):
    cfg = json.loads((CHECKOUT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert set(cfg["limits"]) <= {"loss_gap", "first_loss_gap", "grad_gap", "grad_gap_median",
                                  "delta_gap", "delta_gap_median", "pred_mismatch"}
    assert importlib.import_module(f"portbench.reference.{entry['name']}")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_finds_its_configuration_traffic_and_entry(cell):
    from portbench.lib import harness

    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert cell["chips"] == 1 and NAME.match(cell["traffic"])
    traffic = harness.traffic(cell["traffic"])
    assert harness.entry_class(traffic["entry"]).kind == traffic["entry"]
    assert harness.config(cell["config"])["name"] == cell["config"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_reader_loads_and_reads_nothing_from_nothing(metric):
    from portbench.lib import flops, harness

    read = harness.metric_reader(metric["name"])
    empty = {"window_s": 0.0, "steps": 0, "busy_s": 0.0, "layer_s": {},
             "bound_s": {"attention": 0.0, "mlp": 0.0}, "flops": 0.0, "peaks": flops.PEAKS}
    assert read(empty) is None
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_every_end_to_end_metric_has_a_bound_in_range():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
