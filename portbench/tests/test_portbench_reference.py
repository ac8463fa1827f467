"""The plain reference against the port on the CPU, through a whole run of
each cell at a test's size, and the control computed a step lower (TF32
products) against the reference."""

import pytest

from portbench.lib import checks, harness

from .tiny import CELLS, TINY, bench_run, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference_on_cpu(cell):
    result = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    for name, check in result["checks"].items():
        if check["limit"] is not None:
            assert check["value"] < check["limit"] / 10, (name, check)


def _cell(cell, seed):
    bench = harness.load_bench()
    entry = harness.cell_of(bench, cell)
    cfg = bench_run._merge(harness.config(entry["config"]), TINY["config"])
    traf = bench_run._merge(harness.traffic(entry["traffic"]), TINY["traffic"])
    c = harness.entry_class(traf["entry"])(cfg, traf, seed, "cpu")
    c.setup()
    c.free()
    return c, cfg


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_the_check(cell):
    c, cfg = _cell(cell, 2147483001)
    ref = c.reference_readings()
    control = c.reference_readings(precision="tf32")
    judged = checks.judge(checks.readings(control, ref), cfg["limits"])
    assert not all(j["ok"] for j in judged), judged
