"""Reduction of a torch.profiler trace of the window to the numbers the
per-layer metrics read (the arithmetic of the port's ``cli/step_profile.py``,
copied: the union of device intervals, kernel names without namespace,
template arguments and parameters).

The port's kernels are known by name: the attention kernels, and the MLP
kernels with their reduction kernels and the shared ``pre_kernel``.  Every
other kernel (cuBLAS, LayerNorm, elementwise ops, the scan's) is torch's.
Calls are counted as the port's smoke run counts them: one launch of each
wrapper's main kernel per call.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

from . import RunError

PORT_KERNELS = {
    "attention_fwd_kernel": "attention", "attention_bwd_kernel": "attention",
    "mlp_fwd_kernel": "mlp", "mlp_fwd_reduce_kernel": "mlp", "gemm_kernel": "mlp",
    "reduce_kernel": "mlp", "mlp::pre_kernel": "mlp",
}
# a call of each wrapper: one launch of its main kernel (flattened name)
CALL_PATTERNS = (
    ("attention_fwd", "attention_fwd_kernel"),
    ("attention_bwd", "attention_bwd_kernel"),
    ("mlp_fwd", "mlp_fwd_kernel"),
    ("mlp_bwd", "gemm_kernel<false,true,3>"),
    ("mlp_bwd", "gemm_kernel<false,true,kEpiDx>"),
)
WARMUP_SPAN = "portbench.profiler_warmup"
WARMUP_KERNELS = 256


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0]


def layer_of(name: str) -> str:
    return PORT_KERNELS.get(short_name(name), "torch")


def call_of(name: str) -> Optional[str]:
    flat = re.sub(r"\(anonymous namespace\)::|<unnamed>::|mlp::|\(Epi\)|Epi\)|\(|\s", "", name)
    for call, pattern in CALL_PATTERNS:
        if pattern in flat:
            return call
    return None


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


@dataclasses.dataclass
class Trace:
    """Device activities (name, start s, end s) and host spans of a traced window."""

    device: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]

    @property
    def kernels(self):
        return [a for a in self.device if not a[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return union_s((s, e) for _, s, e in self.device)

    def span_s(self) -> float:
        """The traced window by the device's clock: from the first device
        activity's start to the last one's end."""
        if not self.device:
            return 0.0
        return max(e for _, _, e in self.device) - min(s for _, s, _ in self.device)

    def layer_s(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for name, s, e in self.kernels:
            out[layer_of(name)] += e - s
        return dict(out)

    def calls(self) -> Dict[str, int]:
        out = collections.Counter(call_of(name) for name, _, _ in self.kernels)
        out.pop(None, None)
        return dict(out)

    def top_ops(self, k: int = 10) -> List[list]:
        by = collections.Counter()
        for name, s, e in self.device:
            by[short_name(name)[:80]] += e - s
        return [[n, v] for n, v in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest gaps between device activities, each named by the
        host span it began in."""
        gaps, end = [], None
        for _, s, e in sorted(self.device, key=lambda a: a[1]):
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        return [[self.span_at(t), g] for g, t in gaps[:k]]

    def span_at(self, t: float) -> str:
        inside = [(s, name) for name, s, e in self.spans if s <= t <= e]
        return max(inside)[1] if inside else "host outside the harness's spans"


def check_calls(seen: Dict[str, int], expected: Dict[str, int]) -> None:
    """Raise :class:`RunError` unless the traced launches of each kernel
    equal the count of the steps' work, which the roofline bounds sum."""
    if {k: v for k, v in seen.items() if v} != {k: v for k, v in expected.items() if v}:
        raise RunError(f"the traced kernel launches {seen} differ from the steps' count "
                       f"{expected}: the roofline bounds would not match the work traced")


def start(torch):
    """A running ``torch.profiler.profile`` of host and device, past its warm-up."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    warm_up(torch)
    return prof


def stop(prof, span_prefix: str) -> Trace:
    prof.__exit__(None, None, None)
    return from_profiler(prof, span_prefix)


def from_profiler(prof, span_prefix: str) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``: its device
    activities (not user annotations), without the warm-up's, and the host
    spans named ``span_prefix*``."""
    from torch.autograd import DeviceType

    device, spans = [], []
    warm_end = float("-inf")
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(span_prefix):
                device.append((e.name, start, end))
        elif e.name == WARMUP_SPAN:
            warm_end = max(warm_end, end)
        elif e.name.startswith(span_prefix):
            spans.append((e.name, start, end))
    device = [a for a in device if a[1] > warm_end]
    return Trace(device, spans)


def warm_up(torch) -> None:
    """``WARMUP_KERNELS`` one-element kernels at the start of a profiled
    region (the port's ``utils/profiling._warm_up``): a later profiler session
    in a process can lose the records of its first launches, and these take
    that loss."""
    with torch.profiler.record_function(WARMUP_SPAN):
        x = torch.zeros(1, device="cuda")
        for _ in range(WARMUP_KERNELS):
            x.add_(1)
        torch.cuda.synchronize()
