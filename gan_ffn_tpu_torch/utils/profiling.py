"""Profiling hook (counterpart of ``gan_ffn_tpu/utils/profiling.py``; the
reference's only tracing is a per-epoch wall-clock print,
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
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


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
