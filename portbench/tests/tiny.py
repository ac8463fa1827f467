"""A cell's run on the CPU at a size a test holds: one encoder layer, short
dialogues, small batches; every width as published."""

import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import run as bench_run  # noqa: E402

CELLS = ("gan_ffn.stage_a.b32", "gan_ffn_dialoguernn.train.b30")
TINY = {"config": {"num_layers": 1},
        "traffic": {"dialogues": 12, "utterances": 72, "length_min": 3, "length_max": 10,
                    "batch_size": 4,
                    "buckets": [6, 12], "pool_epochs": 3}}


def run_tiny(cell, seed=2147483999, fault_run=None, overrides=TINY):
    return bench_run.run(["--workload", cell, "--seed", str(seed), "--seconds", "0",
                          "--trace", "0"], device="cpu", overrides=overrides,
                         fault_run=fault_run, log=lambda *a, **k: None)
