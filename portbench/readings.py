#!/usr/bin/env python3
"""The readings that the check's limits are set from, for one cell.

    python3 portbench/readings.py --workload NAME --seeds 12 --controls 3 [--first-seed N]

For each seed, the port's set-up as a run makes it (the probed steps through
the window's own feed and call) against the float32 reference: the lower
readings.  For the first ``--controls`` seeds, also the control (the
reference computed with TF32 products, put in the port's place) and the
planted faults (``half_batch``: the loss over half of the batch's dialogues,
in the reference put in the port's place; ``altered``: the step's first loss
changed by 1e-3 of itself; ``unchanged``: the state left as it was), each
against the float32 reference: the upper readings.  One JSON line per
reading on standard output.
"""

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    args = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from gan_ffn_tpu_torch.utils.runtime import configure_cuda_runtime
    from portbench.lib import checks, harness

    configure_cuda_runtime()
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell_of(harness.load_bench(), args.workload)
    cfg, traf = harness.config(cell["config"]), harness.traffic(cell["traffic"])
    entry_cls = harness.entry_class(traf["entry"])
    for i in range(args.seeds):
        seed = (args.first_seed + 7919 * i) % 2**62
        c = entry_cls(cfg, traf, seed, "cuda:0")
        c.setup()
        prog = c.program_readings()
        c.free()
        ref = c.reference_readings()
        print(json.dumps({"seed": seed, "side": "program", **checks.readings(prog, ref)}),
              flush=True)
        if i >= args.controls:
            continue
        for side, kw in (("control_tf32", {"precision": "tf32"}),
                         ("fault_half_batch", {"fault": "half_batch"})):
            print(json.dumps({"seed": seed, "side": side,
                              **checks.readings(c.reference_readings(**kw), ref)}), flush=True)
        altered = dict(prog, losses=[list(x) for x in prog["losses"]])
        altered["losses"][0][0] *= 1.0 + 1e-3
        unchanged = dict(prog, grad=[0.0] * len(prog["grad"]), delta=[0.0] * len(prog["delta"]))
        for side, readings in (("fault_altered", altered), ("fault_unchanged", unchanged)):
            print(json.dumps({"seed": seed, "side": side, **checks.readings(readings, ref)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
