"""What every training entry shares: its data, the probe, the window, its
end-to-end reading and its traced context, and the check against the
reference.  A subclass gives the port's state and the plain reference of one
kind of train step (see :class:`TrainEntry`).

Set-up builds the port's state once, with weights drawn on the device from
the seed, and runs the pool's first epoch through the window's own feed and
call: the first steps are the probe that the check follows (their losses, the
gradients the optimizer took in the first, the parameters' change after the
last), and each shape's first batch captures its graph.  Every other shape
of the pool is captured next, and one more epoch replays them all.  The
window then runs whole epochs of the pool, in turn, until ``seconds`` have
passed.  Each epoch runs as the port's trainers run one
(``cli.common.train_gan``, ``train.loop.run_epoch_fused``): the batches in
the port's epoch-fused order, each fed through ``batch_to_tensors``, and the
epoch's losses fetched in one copy at its end, so the pause that the fetch
costs a trainer is in the window.  After the window, the port's state is
freed and the reference repeats the probed steps from the same weights,
batches and generator states.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from .. import lib
from ..lib import checks, datagen, flops, trace
from ..lib import weights as wmod
from . import base

SPAN = "portbench."


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rng_state(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_rng_state(state, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


class TrainEntry:
    """A training cell over one configuration and traffic file.

    A subclass sets ``work`` (a step's model FLOPs and kernel launches, from
    ``lib/flops.py``) and gives: ``make_state`` (the port's modules and
    optimizers; sets ``named``, ``leaves``, ``groups``), ``build`` (the
    step), ``feed``, ``run``, ``losses``, ``preds``, ``grad_norms``,
    ``params``, ``graphs``, ``free_state``, and the reference's
    ``ref_begin``, ``ref_step``, ``ref_grad_norms``, ``ref_values``."""

    work = None

    def __init__(self, cfg: dict, traf: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traf, seed, device
        parts, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            _sync(device)
            parts[name], t = time.perf_counter() - t, time.perf_counter()

        torch.empty(1, device=device)
        lap("device_context")
        self.make_state()
        lap("modules")
        split = datagen.make_split(traf, seed)
        self.epochs = datagen.make_epochs(split, traf, seed, int(traf["pool_epochs"]))
        lap("data")
        self.weights = wmod.draw(self.leaves, seed, device)
        wmod.load(self.named, self.weights)
        torch.manual_seed(seed)  # torch's own dropout draws
        self.build()
        lap("weights_and_step")
        self.setup_parts = parts
        self.probe: Dict[str, list] = {"rng": [], "batches": [], "losses": [], "preds": []}

    def order(self, batches) -> List[int]:
        """The port's epoch-fused order: batches grouped by shape."""
        from gan_ffn_tpu_torch.train.loop import fused_order

        return fused_order([base.port_batch(b) for b in batches], None)[0]

    def _run(self, fault_run):
        """The step: the port's, or ``fault_run(port's)`` where a test plants a fault."""
        return self.run if fault_run is None else fault_run(self.run)

    def captures(self) -> int:
        return sum(len(g.graphs) for g in self.graphs())

    # ---- set-up ------------------------------------------------------------
    def setup(self, fault_run=None) -> None:
        n_probe = int(self.traffic["probe_steps"])
        first = self.epochs[0]
        t0 = time.perf_counter()
        seen = set()
        for i, idx in enumerate(self.order(first)):
            hb = first[idx]
            if i < n_probe:
                self.probe["rng"].append(_rng_state(self.device))
            out = self._run(fault_run)(self.feed(hb))
            seen.add(hb.shape)
            if i < n_probe:
                self.probe["batches"].append(hb)
                self.probe["losses"].append(self.losses(out).detach().clone())
                p = self.preds(out)
                self.probe["preds"].append(None if p is None else p.detach().clone())
            if i == 0:
                self.probe["grad"] = self.grad_norms().detach().clone()
                _sync(self.device)
                self.setup_parts["first_step_and_capture"] = time.perf_counter() - t0
            if i == n_probe - 1:
                with torch.no_grad():  # no graph may hold the parameters' grad accumulators
                    self.probe["delta"] = torch.stack(
                        [(p - self.weights[n]).norm()
                         for (n, _), p in zip(self.leaves, self.params())])
                self.weights = None
        _sync(self.device)
        t1 = time.perf_counter()
        self.setup_parts["first_epoch_rest"] = t1 - t0 - self.setup_parts["first_step_and_capture"]
        firsts = {}
        for epoch in self.epochs[1:]:  # every other shape of the pool: captured, then replayed
            for hb in epoch:
                if hb.shape not in seen:
                    seen.add(hb.shape)
                    firsts[hb.shape] = hb
                    self._run(fault_run)(self.feed(hb))
        for hb in firsts.values():
            self._run(fault_run)(self.feed(hb))
        _sync(self.device)
        t2 = time.perf_counter()
        self.setup_parts["other_shapes"] = t2 - t1
        self.run_epoch(self.epochs[1 % len(self.epochs)], fault_run=fault_run)  # warm replays
        _sync(self.device)
        self.setup_parts["warm_epoch"] = time.perf_counter() - t2

    # ---- the window ----------------------------------------------------------
    def run_epoch(self, batches, spans: bool = False, fault_run=None) -> int:
        """One epoch as the port's trainers run it: the steps in epoch-fused
        order, then the epoch's losses to the host in one copy; returns the
        steps whose losses are not finite."""
        span = torch.profiler.record_function if spans else (lambda _: contextlib.nullcontext())
        losses = []
        for idx in self.order(batches):
            with span(SPAN + "batch_copy"):
                tensors = self.feed(batches[idx])
            with span(SPAN + "step"):
                losses.append(self.losses(self._run(fault_run)(tensors)))
        with span(SPAN + "loss_fetch"):
            fetched = torch.cat(losses).cpu()
        return int((~torch.isfinite(fetched.reshape(len(batches), -1))).any(dim=1).sum())

    def window(self, seconds: float, traced: bool = False, fault_run=None) -> dict:
        """Whole epochs of the pool after the set-up's two: for ``seconds``,
        or the traffic's ``trace_epochs`` of them under the profiler.  Returns
        the steps attempted and failed, the end-to-end readings by name, the
        guards' lines, and in a traced window its trace and the per-layer
        metrics' context.  A graph captured inside the window, or traced
        kernel launches other than the steps' count, raise ``RunError``."""
        before = self.captures()
        steps = utterances = failed = 0
        batches: List[dict] = []
        epoch_s: List[float] = []
        prof = trace.start(torch) if traced else None
        _sync(self.device)
        t0 = time.perf_counter()
        e = 2
        while True:
            epoch = self.epochs[e % len(self.epochs)]
            failed += self.run_epoch(epoch, traced, fault_run)
            steps += len(epoch)
            utterances += sum(b.utterances for b in epoch)
            batches += [{"n_real": b.n_real, "valid_len": b.valid_len} for b in epoch]
            epoch_s.append(time.perf_counter() - t0 - sum(epoch_s))
            e += 1
            if (e - 2 >= int(self.traffic["trace_epochs"]) if traced
                    else time.perf_counter() - t0 >= seconds):
                break
        _sync(self.device)
        window_s = time.perf_counter() - t0
        after = self.captures()
        if after != before:
            raise lib.RunError(f"the window captured {after - before} graph(s)")
        out = {"attempted": steps, "failed": failed,
               "e2e": {"train_utt_per_s": utterances / window_s},
               "guards": [{"guard": "graphs", "captured_before_window": before,
                           "captured_after_window": after,
                           "stats": [s for g in self.graphs() for s in g.stats()]},
                          {"guard": "epochs", "host_window_s": window_s, "epoch_s": epoch_s}]}
        if prof is not None:
            tr = trace.stop(prof, SPAN)
            counts = flops.totals(self.work, self.cfg, batches)
            seen = tr.calls()
            out["guards"].append({"guard": "launches_per_step",
                                  "traced": {k: v / steps for k, v in seen.items()},
                                  "counted": {k: v / steps for k, v in counts["calls"].items()},
                                  "steps": steps})
            trace.check_calls(seen, counts["calls"])
            out["trace"] = tr
            out["ctx"] = {"window_s": tr.span_s(), "steps": steps, "busy_s": tr.busy_s(),
                          "layer_s": tr.layer_s(), "bound_s": counts["bound_s"],
                          "flops": counts["flops"], "peaks": flops.PEAKS}
        return out

    # ---- the check ---------------------------------------------------------
    def free(self) -> None:
        self.free_state()
        base.release(self.device)

    def program_readings(self) -> dict:
        p = self.probe
        return {"losses": [x.double().cpu().tolist() for x in p["losses"]],
                "grad": p["grad"].double().cpu().tolist(),
                "delta": p["delta"].double().cpu().tolist(),
                "preds": None if p["preds"][0] is None else [x.cpu().tolist() for x in p["preds"]]}

    def reference_readings(self, fault: str = "", precision: str = "f32") -> dict:
        """The reference's readings of the probed steps, from the same weights,
        batches and generator states (``precision="tf32"``: the control)."""
        from ..reference import common

        weights = wmod.draw(self.leaves, self.seed, self.device)
        self.ref_begin(weights)
        out = {"losses": [], "preds": [], "pred_masks": [], "groups": list(self.groups)}
        with common.tf32_products() if precision == "tf32" else contextlib.nullcontext():
            for k, hb in enumerate(self.probe["batches"]):
                _set_rng_state(self.probe["rng"][k], self.device)
                losses, preds = self.ref_step(hb, fault)
                out["losses"].append(losses.double().cpu().tolist())
                out["preds"].append(None if preds is None else preds.cpu().tolist())
                out["pred_masks"].append(hb.umask.reshape(-1).astype(bool).tolist())
                if k == 0:
                    out["grad"] = self.ref_grad_norms().double().cpu().tolist()
        with torch.no_grad():
            out["delta"] = [(v - weights[n]).norm().item()
                            for (n, _), v in zip(self.leaves, self.ref_values())]
        if out["preds"][0] is None:
            out["preds"] = None
        return out

    def readings(self) -> Dict[str, float]:
        """The numbers compared: the probed steps against the reference's.
        Call after :meth:`free`."""
        prog = self.program_readings()
        return checks.readings(prog, self.reference_readings())

