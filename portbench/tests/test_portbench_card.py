"""Each cell end to end on a CUDA card, briefly: the result line's keys, the
card's name, and ``correct``.  Skips where torch sees no card."""

import json
import subprocess
import sys

import pytest

from .tiny import CELLS, CHECKOUT


@pytest.mark.cuda_hardware
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "3000000007", "--seconds", "2", "--trace", trace],
                         capture_output=True, text=True, timeout=900, cwd=str(CHECKOUT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"], result
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
