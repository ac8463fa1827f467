"""The CUDA runtime's settings and the wait for the card (counterpart of
``gan_ffn_tpu/utils/runtime.py``).

:func:`configure_cuda_runtime` is the one place the port sets torch's
float32 flags, process-wide:

- TF32 off in cuBLAS's float32 matmuls and in cuDNN's convolutions (the
  baselines' ``Conv1d`` and ``Conv2d``), so that float32 stays float32 on
  the card and meets the card-against-CPU limits;
- reduced-precision reductions off in cuBLAS's bf16 matmuls (the JAX
  package sums bf16 products in float32).

It also takes the counterpart of the JAX compile cache: the directory the
kernels are built into and reused from across runs (``ops/_build.BUILD_DIR``),
from ``kernel_build_dir`` or the ``GANFFN_KERNEL_BUILD_DIR`` environment
variable; with neither it stays ``build/kernels`` in the checkout.  The
JAX function's RBG PRNG switch has no counterpart: the kernels' dropout
masks come from the port's one fixed Philox stream (``ops/dropout.py``).

:func:`wait_for_device` initialises CUDA on the card, retrying where the
initialisation raises (a card still held by a previous process), with the
JAX function's watchdog: a daemon thread that reports every
``hang_warn_s`` seconds on stderr while the wait goes on, saying whether
the initialisation is blocking or the retries are firing.  It returns the
card's ``torch.device`` or raises the last error: it never falls back to
the CPU.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from pathlib import Path
from typing import Optional, Union

import torch

from ..ops import _build


def configure_cuda_runtime(kernel_build_dir: Union[str, Path, None] = None) -> None:
    """Pin float32 matmuls and convolutions to float32 and bf16 matmuls'
    sums to float32, and point the kernel builds at ``kernel_build_dir``
    (or ``GANFFN_KERNEL_BUILD_DIR``) where one is given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    build_dir = kernel_build_dir or os.environ.get("GANFFN_KERNEL_BUILD_DIR")
    if build_dir:
        _build.BUILD_DIR = Path(build_dir).expanduser().resolve()


def _probe(device: torch.device) -> torch.device:
    """Initialise CUDA and make one allocation on ``device``."""
    torch.cuda.init()
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    return device


def wait_for_device(device: Union[str, torch.device] = "cuda", attempts: int = 6,
                    delay_s: float = 10.0, hang_warn_s: float = 120.0) -> torch.device:
    """Initialise CUDA on ``device`` (a card), up to ``attempts`` times,
    ``delay_s`` seconds apart, while a watchdog reports every
    ``hang_warn_s`` seconds (0: no watchdog).  Returns the device, or
    raises the last attempt's ``RuntimeError``; ``ValueError`` for
    ``attempts < 1`` or a device that is not a card."""
    if attempts < 1:
        raise ValueError(f"wait_for_device: attempts must be >= 1, got {attempts}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"wait_for_device waits for a CUDA card, not {device}")

    done = threading.Event()
    t0 = time.monotonic()
    # the attempt under way, and whether it is inside the initialisation (a
    # blocking call) or between attempts (a retry's sleep)
    progress = {"attempt": 0, "in_call": False}

    def _watchdog():
        while not done.wait(hang_warn_s):
            if progress["in_call"]:
                detail = (f"CUDA initialisation is blocking on attempt "
                          f"{progress['attempt'] + 1}/{attempts} (retries cannot fire "
                          "until it returns)")
            else:
                detail = (f"attempt {progress['attempt'] + 1}/{attempts} raised; "
                          "retrying after the backoff sleep")
            print(f"[gan_ffn_tpu_torch] device init still pending after "
                  f"{time.monotonic() - t0:.0f}s: {detail}. Waiting...",
                  file=sys.stderr, flush=True)

    if hang_warn_s > 0:
        threading.Thread(target=_watchdog, daemon=True).start()
    last: Optional[RuntimeError] = None
    try:
        for attempt in range(attempts):
            progress["attempt"] = attempt
            try:
                progress["in_call"] = True
                return _probe(device)
            except RuntimeError as e:
                progress["in_call"] = False
                last = e
                if attempt + 1 < attempts:
                    time.sleep(delay_s)
        raise last
    finally:
        done.set()
