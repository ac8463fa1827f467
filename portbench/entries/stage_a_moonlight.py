"""Graphed stage A with Moonlight-16B-A3B's decoder stack as the text
generator: ``cli.common.make_stage_a_step(cfg, state, epoch_fused=True)``
over ``train.gan.create_gan_modules`` of ``GANConfig(text_generator=
"moonlight")``, fed as ``entries/stage_a.py`` feeds it.

Beyond ``entries/stage_a.py``:

- the port's tracing is on from the start, so every captured step holds the
  MoE and MLA regions' stamps (``utils/profiling.py``); a traced window
  reads the route regions by their own stamps (end - begin, the device's
  clock), and sums the grouped expert kernels' device time and launches
  (``lib/moe_counts.py``), which must equal the count;
- the RMSNorm scales start at 1 (``lib/weights.py`` draws every leaf
  whose name lacks ``.norm``), on both sides;
- each MoE layer records its chosen experts of every text-generator pass
  (``nn.moe.MoE.record_slots``), and the probed steps' records go to the
  reference, which takes the program's choice in a tie
  (``reference/gan_ffn_moonlight.py``); the rows so taken (``tie_rows``) and
  those whose choices part with a wider gap (``choice_mismatch``) are
  readings of the check.
"""

from __future__ import annotations

from typing import Dict

import torch
from gan_ffn_tpu_torch.models.moonlight import MoonlightConfig
from gan_ffn_tpu_torch.nn import moe as port_moe
from gan_ffn_tpu_torch.train.gan import (GANConfig, create_gan_modules, create_gan_optimizers)
from gan_ffn_tpu_torch.utils import profiling

from .. import lib
from ..lib import moe_counts, trace
from ..lib import weights as wmod
from ..reference import gan_ffn as ref_gan
from ..reference import gan_ffn_moonlight as ref
from . import base, stage_a

PASSES = 4  # text-generator calls a stage-A step: two disc duels' fakes, two gen duels


def _is_scale(name: str) -> bool:
    """An RMSNorm's scale, which starts at 1."""
    return name.endswith(("layernorm.weight", ".norm.weight"))


class _Redraw:
    """The starting weights (``lib/weights.draw`` of the same seed, RMSNorm
    scales 1), drawn at the first read."""

    def __init__(self, leaves, seed: int, device):
        self.leaves, self.seed, self.device, self.drawn = leaves, seed, device, None

    def __getitem__(self, name: str) -> torch.Tensor:
        if self.drawn is None:
            self.drawn = wmod.draw(self.leaves, self.seed, self.device)
            for n, w in self.drawn.items():
                if _is_scale(n):
                    w.fill_(1.0)
        return self.drawn[name]


class Entry(stage_a.Entry):
    work = staticmethod(moe_counts.stage_a_moonlight)
    kind = "stage_a_moonlight"

    def make_state(self) -> None:
        cfg, device = self.cfg, self.device
        g = cfg["gan"]
        profiling.enable()  # before any capture: the regions' stamps ride in the graphs
        self.gcfg = GANConfig(D_h=cfg["D_h"], dropout=cfg["dropout"],
                              num_layers=cfg["num_layers"], lr=g["lr"], b1=g["b1"], b2=g["b2"],
                              text_generator="moonlight",
                              moonlight=MoonlightConfig.from_dict(cfg))
        self.modules = create_gan_modules(self.gcfg, None, device)
        self.named = [(f"{net}.{k}", p) for net, m in self.modules.items()
                      for k, p in m.named_parameters() if p.requires_grad]
        self.leaves = [(n, tuple(p.shape)) for n, p in self.named]
        self.groups = [n.split(".", 1)[0] for n, _ in self.named]
        self.moe = self.modules["text_gen"].moe_layers()
        for m in self.moe:
            m.record_slots = PASSES
        self.choices = []  # the probed steps' records: [step][MoE layer] (PASSES, rows, k)
        self.opts = create_gan_optimizers(self.gcfg, self.modules)
        self.step = None

    def build(self) -> None:
        with torch.no_grad():
            for (name, _), p in zip(self.leaves, self.params()):
                if _is_scale(name):
                    p.fill_(1.0)
        # the probe's starting weights drawn again where it reads them, not held
        # through the first captures (9.7 GB at the published widths)
        self.weights = _Redraw(self.leaves, self.seed, self.device)
        super().build()

    def run(self, tensors):
        out = self.step(tensors)
        if len(self.choices) < int(self.traffic["probe_steps"]):
            rows = tensors["text"].shape[0] * tensors["text"].shape[1]
            self.choices.append([m.records[rows].clone() for m in self.moe])
        return out

    def free_state(self) -> None:
        self.moe = None
        super().free_state()
        profiling.collect()  # the logs emptied, and tracing off as the process found it
        profiling.enable(False)

    # ---- the window ---------------------------------------------------------
    def window(self, seconds: float, traced: bool = False, fault_run=None) -> dict:
        profiling.collect()  # the regions before the window
        out = super().window(seconds, traced, fault_run)
        collected = profiling.collect()
        if not traced:
            return out
        ctx, tr = out["ctx"], out["trace"]
        epochs = [self.epochs[e % len(self.epochs)]
                  for e in range(2, 2 + int(self.traffic["trace_epochs"]))]
        steps = [{"n_real": b.n_real, "valid_len": b.valid_len} for epoch in epochs
                 for b in epoch]
        counted = moe_counts.moe_totals(self.cfg, steps)
        seen: Dict[str, int] = {}
        spent = 0.0
        for name, s, e in tr.kernels:
            short = trace.short_name(name)
            if short in moe_counts.GROUPED_KERNELS:
                seen[short] = seen.get(short, 0) + 1
                spent += e - s
        out["guards"].append({"guard": "grouped_launches_per_step",
                              "traced": {k: v / len(steps) for k, v in seen.items()},
                              "counted": {k: v / len(steps) for k, v in counted["calls"].items()},
                              "steps": len(steps)})
        if seen != counted["calls"]:
            raise lib.RunError(f"the traced grouped-expert launches {seen} differ from the "
                               f"steps' count {counted['calls']}")
        route = [r for r in collected.regions
                 if r.name in (port_moe.ROUTE, port_moe.ROUTE_BACKWARD) and r.name not in r.inside]
        ctx.update(moe_s=spent, moe_bound_s=counted["bound_s"],
                   moe_route_s=sum(r.ms for r in route) / 1e3 if route else None,
                   regions_dropped=collected.dropped)
        return out

    # ---- the reference ----------------------------------------------------
    def ref_begin(self, weights) -> None:
        for name in weights:
            if _is_scale(name):
                weights[name].fill_(1.0)
        self.ref_params = self.ref_adams = None
        self.ref_params = ref_gan.split_weights(weights)
        self.ref_adams = ref_gan.make_adams(self.ref_params, self.cfg)
        self.ref_state = ref.Moonlight(self.cfg, self.device)
        self.ref_k = 0

    def ref_step(self, hb, fault: str = ""):
        st = self.ref_state
        st.port_choices = {layer: c for layer, c in zip(sorted(st.bias), self.choices[self.ref_k])}
        self.ref_k += 1
        batch = base.reference_batch(hb, self.device)
        return torch.stack(ref.stage_a_step(self.ref_params, self.ref_adams, batch, self.cfg, st,
                                            fault)), None

    def readings(self) -> Dict[str, float]:
        values = super().readings()
        values.update(tie_rows=self.ref_state.tie_rows,
                      choice_mismatch=self.ref_state.choice_mismatch,
                      tie_gap=self.ref_state.tie_gap)
        return values
