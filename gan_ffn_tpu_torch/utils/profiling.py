"""Profiling and tracing (counterpart of ``gan_ffn_tpu/utils/profiling.py``;
the reference's only tracing is a per-epoch wall-clock print,
train_IEMOCAP.py:673,717).

``trace(logdir, cuda)`` wraps a region in ``torch.profiler.profile``:
CPU activity, plus CUDA activity where ``cuda`` (the run is on a card);
on a card, the region is preceded by a warm-up (:func:`_warm_up`), and
on leaving the card is synchronized, so every kernel of the region
finishes inside the trace; then ``torch.profiler.tensorboard_trace_handler``
writes the trace into ``logdir`` as ``{host}_{pid}.{ns}.pt.trace.json``
(Chrome trace format, readable by TensorBoard's profiler plugin or
``chrome://tracing``; writing it needs no ``tensorboard`` package).
``trace(None, cuda)`` is a no-op.  The flagship trainer's ``--profile LOGDIR``
traces stage B's train epoch 1, as the JAX trainer does: by then epoch 0
has built the kernels and, with ``--epoch-fused``, captured the graphs.

The port's own tracing, off by default (:func:`enable`, :func:`enabled`):

- :func:`span` is a host span, ``torch.profiler.record_function``, named
  ``gan_ffn.*``: the loop's and the graphs' boundaries (``train/loop.py``,
  ``train/graphs.py``).  A replay runs no Python of the step, so no span
  inside the step fires there.
- :func:`region` is a host span of the same kind and, on a card, a stamp at
  its entry and at its exit: a one-thread kernel (``csrc/trace_stamp.cu``)
  on the current stream that appends (region, begin or end, ``%globaltimer``
  ns) to a fixed-size log in device memory.  A stamp that a CUDA graph
  captures is a node of the graph, so every replay appends its entries.  On
  the CPU a region appends ``time.perf_counter_ns()`` to a host log of the
  same kind.  Entries past a log's capacity are dropped and counted.
- :func:`collect` copies the logs to the host (call it where the caller
  synchronizes anyway), empties them, and decodes the regions by nesting.

Tracing must be on before a step's graph is captured: a graph captured
while it was off holds no stamps, and one captured while it was on stamps
at every replay, on or off.  Off, each instrumented point costs the host one
flag test, and the stamp library is neither built nor loaded.  The regions:
``gan_ffn.step`` (every step that ``train/graphs.ShapeGraphs`` runs, eager or
captured, and the classifier's per-batch steps), and ``gan_ffn.forward``,
``gan_ffn.backward`` and ``gan_ffn.optimizer`` (the classifier's train step,
``train/classifier.py``): what the flagship trainer's ``--profile`` reports;
and the Moonlight text generator's ``gan_ffn.mla``, ``gan_ffn.moe.route``,
``gan_ffn.moe.experts`` (``nn/mla.py``, ``nn/moe.py``).  A region of a
backward pass is marked by two identity autograd functions
(:func:`backward_begins` where a gradient arrives, :func:`backward_ends`
where one leaves): ``gan_ffn.moe.route_backward`` and
``gan_ffn.moe.experts_backward``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

STEP, FORWARD, BACKWARD, OPTIMIZER = ("gan_ffn.step", "gan_ffn.forward", "gan_ffn.backward",
                                      "gan_ffn.optimizer")
CAPACITY = 1 << 16  # entries a log holds (16 bytes each on a card)
STAMP_KERNEL = "trace_stamp_kernel"  # the stamp's name in a device trace


@contextlib.contextmanager
def trace(logdir: Optional[str], cuda: bool):
    """Profile the enclosed region into ``logdir`` (no-op when it is None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        if cuda:
            _warm_up()
        yield
        if cuda:
            torch.cuda.synchronize()


WARMUP = "profiler warm-up"  # the record_function span of the warm-up's launches
WARMUP_KERNELS = 256


def _warm_up() -> None:
    """Launch ``WARMUP_KERNELS`` one-element kernels under the span
    ``WARMUP`` and wait for them.  On an H100 (torch 2.11, CUDA 12.8), a
    profiler session opened after several others in the same process can
    lose the kernel records of its first launches (their runtime API
    records stay), however far apart those launches are in time; a wait or
    an empty warm-up step of ``torch.profiler.schedule`` does not prevent
    it.  These launches take that loss instead of the region's
    (``chip_smoke.py`` phase 12 prints how many of their records it lost)."""
    with torch.profiler.record_function(WARMUP):
        x = torch.zeros(1, device="cuda")
        for _ in range(WARMUP_KERNELS):
            x.add_(1)
        torch.cuda.synchronize()


# ---- the port's tracing ------------------------------------------------------

_on = False
_OFF = contextlib.nullcontext()
_ids: Dict[str, int] = {}
_names: List[str] = []


class _HostLog:
    def __init__(self, capacity: int):
        self.capacity, self.count, self.words = capacity, 0, []

    def append(self, tag: int) -> None:
        if self.count < self.capacity:
            self.words.append((tag, time.perf_counter_ns()))
        self.count += 1

    def take(self) -> Tuple[List[Tuple[int, int]], int]:
        words, dropped = self.words, self.count - len(self.words)
        self.count, self.words = 0, []
        return words, dropped


class _DeviceLog:
    """``words`` (capacity, 2) int64 and ``cursor`` on one card, allocated
    once: the graphs that captured a stamp hold their addresses."""

    def __init__(self, device: torch.device, capacity: int):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a card's trace log is allocated at its first stamp, which must "
                               "run outside a CUDA graph capture: run the step once eagerly")
        self.capacity = capacity
        self.words = torch.zeros(capacity, 2, dtype=torch.int64, device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        torch.cuda.synchronize(device)

    def take(self) -> Tuple[List[Tuple[int, int]], int]:
        torch.cuda.synchronize(self.cursor.device)
        n = int(self.cursor.item())
        kept = min(n, self.capacity)
        words = [tuple(w) for w in self.words[:kept].cpu().tolist()]
        self.cursor.zero_()
        return words, n - kept


_host = _HostLog(CAPACITY)
_device_logs: Dict[int, _DeviceLog] = {}
_stamp_fn = None
_STAMP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                   ctypes.c_void_p]


def enable(on: bool = True) -> None:
    """Turn the port's tracing on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A host span ``name`` where tracing is on; else a no-op."""
    return torch.profiler.record_function(name) if _on else _OFF


def region(name: str, device):
    """A host span ``name`` bracketed, on ``device``, by two stamps where
    tracing is on; else a no-op."""
    return _Region(name, device) if _on else _OFF


class _Region:
    __slots__ = ("tag", "device", "host")

    def __init__(self, name: str, device):
        self.tag, self.device = 2 * _id(name), torch.device(device)
        self.host = torch.profiler.record_function(name)

    def __enter__(self):
        self.host.__enter__()
        _stamp(self.tag, self.device)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            _stamp(self.tag + 1, self.device)
        self.host.__exit__(exc_type, exc, tb)


def _id(name: str) -> int:
    if name not in _ids:
        _ids[name] = len(_names)
        _names.append(name)
    return _ids[name]


def _stamp(tag: int, device: torch.device) -> None:
    if device.type != "cuda":
        _host.append(tag)
        return
    global _stamp_fn
    from ..ops import _build

    index = device.index if device.index is not None else torch.cuda.current_device()
    log = _device_logs.get(index)
    if log is None:
        log = _device_logs[index] = _DeviceLog(torch.device("cuda", index), CAPACITY)
    if _stamp_fn is None:
        _stamp_fn = _build.function("trace_stamp", "gan_trace_stamp", _STAMP_ARGTYPES)
    code = _stamp_fn(log.words.data_ptr(), log.cursor.data_ptr(), log.capacity, tag,
                     torch.cuda.current_stream(index).cuda_stream)
    _build.check(code, "trace_stamp")


# ---- reading the logs --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Region:
    """One region: its name, begin and end in ns of its log's clock (a
    card's ``%globaltimer``, or the host's ``perf_counter_ns``), and the
    names of the regions it lies in, outermost first."""

    name: str
    begin_ns: int
    end_ns: int
    inside: Tuple[str, ...]

    @property
    def ms(self) -> float:
        return (self.end_ns - self.begin_ns) / 1e6


@dataclasses.dataclass
class Collected:
    """What :func:`collect` read: each log's entries ``(name, end, ns)`` in
    log order (``end`` is 1 for a region's end), by device (``"cpu"``,
    ``"cuda:0"``, ...), the regions they decode to, and the entries dropped
    because a log was full."""

    entries: Dict[str, List[Tuple[str, int, int]]]
    regions: List[Region]
    dropped: int


def decode(entries: List[Tuple[str, int, int]]) -> List[Region]:
    """The regions of one log's entries, by nesting, sorted by begin.  An
    end closes the innermost open region of its name; a begin or an end
    without its twin (a full log) makes no region."""
    open_: List[Tuple[str, int]] = []
    out = []
    for name, end, ns in entries:
        if not end:
            open_.append((name, ns))
            continue
        for i in range(len(open_) - 1, -1, -1):
            if open_[i][0] == name:
                out.append(Region(name, open_[i][1], ns, tuple(n for n, _ in open_[:i])))
                del open_[i]
                break
    return sorted(out, key=lambda r: r.begin_ns)


def collect() -> Collected:
    """Every log's entries, decoded, and the logs emptied.  On a card this
    waits for the device (the copy to the host)."""
    entries, regions, dropped = {}, [], 0
    logs = [("cpu", _host)] + [(f"cuda:{i}", log) for i, log in sorted(_device_logs.items())]
    for device, log in logs:
        words, lost = log.take()
        dropped += lost
        if words:
            entries[device] = [(_names[tag >> 1], tag & 1, ns) for tag, ns in words]
            regions += decode(entries[device])
    return Collected(entries, regions, dropped)


def report(collected: Collected) -> dict:
    """Per region name, its count and ms (a region inside one of its own
    name is in that one's ms), the entries and the dropped: the line that
    ``--profile`` prints."""
    out: Dict[str, dict] = {}
    for r in collected.regions:
        if r.name not in r.inside:
            row = out.setdefault(r.name, {"count": 0, "ms": 0.0})
            row["count"] += 1
            row["ms"] += r.ms
    return {"regions": out, "entries": sum(map(len, collected.entries.values())),
            "dropped": collected.dropped}


# ---- regions of a backward pass ----------------------------------------------

_open_spans: Dict[str, object] = {}  # the host spans of open backward regions, by name


class _BackwardMark(torch.autograd.Function):
    """The identity; its backward stamps the begin or the end of a region."""

    @staticmethod
    def forward(ctx, x, name, end):
        ctx.name, ctx.end = name, end
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        tag = 2 * _id(ctx.name)
        if ctx.end:
            _stamp(tag + 1, grad.device)
            host = _open_spans.pop(ctx.name, None)
            if host is not None:
                host.__exit__(None, None, None)
        else:
            host = _open_spans[ctx.name] = torch.profiler.record_function(ctx.name)
            host.__enter__()
            _stamp(tag, grad.device)
        return grad, None, None


def backward_begins(y: torch.Tensor, name: str) -> torch.Tensor:
    """``y``, marked where tracing is on and it takes a gradient: region
    ``name`` begins when the gradient of ``y`` arrives."""
    if not (_on and torch.is_grad_enabled() and y.requires_grad):
        return y
    return _BackwardMark.apply(y, name, False)


def backward_ends(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, marked where tracing is on and it takes a gradient: region
    ``name`` ends when the gradient of ``x`` leaves."""
    if not (_on and torch.is_grad_enabled() and x.requires_grad):
        return x
    return _BackwardMark.apply(x, name, True)
