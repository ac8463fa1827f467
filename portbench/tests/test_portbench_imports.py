"""A run loads no module of JAX or of the JAX package, compared by whole
top-level name (the port's own name begins with the JAX package's)."""

import subprocess
import sys

from portbench import run as bench_run

from .tiny import CHECKOUT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
from portbench.tests.tiny import CELLS, run_tiny
for cell in CELLS:
    assert run_tiny(cell)["correct"]
import portbench.readings, portbench.lib.trace
from portbench import run
print(run.forbidden_modules())
"""


def test_whole_top_level_names():
    assert bench_run.FORBIDDEN == ("jax", "jaxlib", "flax", "gan_ffn_tpu")
    import gan_ffn_tpu_torch  # noqa: F401

    found = bench_run.forbidden_modules()
    assert "gan_ffn_tpu_torch" not in found


def test_a_run_imports_none_of_them():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(CHECKOUT))],
                         capture_output=True, text=True, timeout=600, cwd=str(CHECKOUT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
