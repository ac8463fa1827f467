"""One CUDA graph per batch shape of a train or eval step (the port's
counterpart of ``gan_ffn_tpu/utils/aot.py::ShapeDispatchingAOT``, without its
disk cache): the epoch-fused stages' dispatcher.

:class:`ShapeGraphs` wraps a step function ``fn(batch) -> outputs`` over a
dict of tensors.  Its key is the mode (train, eval, stage A) and the batch
tensors' names, shapes and dtypes; the batch's host values never reach
``fn``, so nothing host-side is baked into a graph.  Per key:

- the first batch of the shape runs ``fn`` eagerly, on the dispatcher's side
  stream, as that batch's real step.  It is the warm-up that capture needs
  (Adam's states, cuBLAS's workspace, the kernels' libraries), so no
  throwaway step touches the parameters, the optimizer or a generator;
- then ``fn`` is captured on the same stream into a graph with its own
  memory pool, over static copies of that batch (capture records and runs
  nothing);
- every later batch of the shape is copied into the static inputs
  (``copy_(..., non_blocking=True)``), the graph replays, and the static
  outputs are cloned, so a later replay does not overwrite them.

Where the port's tracing is on (``utils/profiling.py``), every step of
``fn`` (on the CPU, eager, or captured) lies in the region ``gan_ffn.step``,
so its stamps are a graph's first and last nodes and every replay records
the step on the device's clock; the host spans ``gan_ffn.graph.copy_in``,
``gan_ffn.graph.replay`` (the ``CUDAGraph.replay()`` call alone) and
``gan_ffn.graph.clone_out`` name a replay's three parts, and
``gan_ffn.graph.capture`` a shape's eager first step and its capture.
:func:`in_step_region` gives a step that runs without graphs the same
region.

The step reads ``valid_len``, ``n_real``, the dropout seed base and the lr
from device memory (``ops``, ``train/optim.py``), so a replay is the step of
the batch copied in.  torch's own RNG (``F.dropout``) is graph-safe: each
replay draws fresh values.  On CPU tensors ``fn`` runs eagerly every time:
there is no graph on the CPU.  On the card there is no eager fallback: a
failed capture or replay raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional

import torch

from ..utils import profiling


def tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tree of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def in_step_region(fn: Callable[[Mapping[str, object]], object]):
    """``fn(batch)`` in the region ``gan_ffn.step``, on the batch's device."""
    def step(batch: Mapping[str, object]):
        if not profiling.enabled():
            return fn(batch)
        device = next(v.device for v in batch.values() if isinstance(v, torch.Tensor))
        with profiling.region(profiling.STEP, device):
            return fn(batch)

    return step


def _pool_bytes(pool, device) -> int:
    """Bytes of the device memory segments that belong to ``pool``."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool)
               and s.get("device") == device.index)


@dataclasses.dataclass
class CapturedStep:
    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]
    outputs: object
    capture_seconds: float
    pool_bytes: int
    replays: int = 0


class ShapeGraphs:
    """``fn`` captured once per batch shape and replayed (see the module
    docstring).  ``graphs`` maps each key to its :class:`CapturedStep`."""

    def __init__(self, fn: Callable[[Dict[str, torch.Tensor]], object], mode: str):
        self.fn, self.mode = fn, mode
        self._step = in_step_region(fn)
        self.graphs: Dict[tuple, CapturedStep] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def key(self, tensors: Mapping[str, torch.Tensor]) -> tuple:
        return (self.mode,) + tuple((k, tuple(v.shape), str(v.dtype))
                                    for k, v in sorted(tensors.items()))

    def __call__(self, batch: Mapping[str, object]):
        tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
        devices = {v.device for v in tensors.values()}
        if len(devices) != 1:
            raise ValueError(f"a step's batch lies on one device, got {sorted(map(str, devices))}")
        device = devices.pop()
        if device.type != "cuda":
            return self._step(tensors)
        captured = self.graphs.get(self.key(tensors))
        if captured is None:
            with profiling.span("gan_ffn.graph.capture"):
                return self._run_and_capture(tensors, device)
        with profiling.span("gan_ffn.graph.copy_in"):
            for k, buf in captured.inputs.items():
                buf.copy_(tensors[k], non_blocking=True)
        with profiling.span("gan_ffn.graph.replay"):
            captured.graph.replay()
        captured.replays += 1
        with profiling.span("gan_ffn.graph.clone_out"):
            return tree_map(torch.clone, captured.outputs)

    def _run_and_capture(self, tensors: Dict[str, torch.Tensor], device: torch.device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream, current = self._stream, torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = self._step(tensors)  # this batch's real step, and the warm-up
            static = {k: v.clone() for k, v in tensors.items()}
        current.wait_stream(stream)
        graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            outputs = self._step(static)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        self.graphs[self.key(tensors)] = CapturedStep(graph, static, outputs, seconds,
                                                      _pool_bytes(pool, device))
        return out

    def stats(self) -> List[dict]:
        """Per captured shape: its key, capture seconds, pool bytes, replays."""
        return [{"key": [list(k) if isinstance(k, tuple) else k for k in key],
                 "capture_seconds": c.capture_seconds, "pool_bytes": c.pool_bytes,
                 "replays": c.replays} for key, c in self.graphs.items()]
