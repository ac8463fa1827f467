"""Fused two-layer MLP forward (counterpart of ``gan_ffn_tpu/ops/mlp.py``):
``post(mid(pre(x) @ W1 + b1) @ W2 + b2)`` with the ``(M, d_ff)``
intermediate kept on chip.

The elementwise chains take the JAX package's static description::

  pre  = None | (act, rate)                 # act THEN dropout, on the input
  mid  = (act, order, rate)                 # between the matmuls
  post = None | (act, "drop_first", rate)   # after the second matmul

with ``act`` in {"relu", "gelu"} (gelu is exact-erf) and ``order`` in
{"drop_first", "act_first"}.  Two configurations are on the serving path:
the encoder FFN ``mid=("relu", "act_first", 0)`` and the generator head
``pre=("gelu", 0), mid=("gelu", "drop_first", 0), post=("gelu",
"drop_first", 0)``.  Every rate must be 0 here: dropout arrives with the
training slice, and at rate 0 the two orders are the same function.

:func:`fused_mlp` dispatches on the device: CPU tensors go through
:func:`mlp_plain`, CUDA tensors through ``csrc/mlp_fwd.cu``, which launches
or raises.  Weights use the kernel layout ``w1 (K, H)``, ``w2 (H, N)``.

Which geometries the kernel takes (:func:`fused_mlp_supported`) is derived
for Hopper, not copied from the TPU guard: that one is sized by the TPU
*backward* kernel's VMEM and refuses the visual FFN 512->2048->512.  The
forward kernel streams d_ff in 128-column chunks and keeps only a
``(32, N)`` float32 accumulator on chip (in registers), so d_ff is
unbounded; what bounds it is ``N <= 512`` (accumulator columns per thread)
and the shared memory for one block's ``pre(x)`` rows plus double-buffered
weight slices, at most 227 KB.  All four serving geometries fit:
100->2048->100, 512->2048->512, 100->512->100 and 512->1024->100.  A guard
sized by the backward kernel comes back with that kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .attention import _check_cuda_operands

ACTS = {None: 0, "relu": 1, "gelu": 2}  # the csrc Act codes
ORDERS = ("drop_first", "act_first")
MAX_OUT = 512  # csrc kMaxColGroups * kColGroup
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
# csrc tile constants: kRows, kSliceK, kChunk, kSliceH, kColGroup, kPad
_ROWS, _SLICE_K, _CHUNK, _SLICE_H, _COL_GROUP, _PAD = 32, 32, 128, 16, 128, 4

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _smem_bytes(K: int, N: int) -> int:
    """Shared memory of one block (csrc ``gan_mlp_fwd_smem_bytes``)."""
    Kp = -(-K // _SLICE_K) * _SLICE_K + _PAD
    Np = -(-N // _COL_GROUP) * _COL_GROUP
    return 4 * (_ROWS * Kp + 2 * _SLICE_K * _CHUNK + _ROWS * (_CHUNK + _PAD) + 2 * _SLICE_H * Np)


def fused_mlp_supported(K: int, H: int, N: int) -> bool:
    """True iff the CUDA kernel takes the ``K -> H -> N`` geometry."""
    return min(K, H, N) >= 1 and N <= MAX_OUT and _smem_bytes(K, N) <= SMEM_LIMIT


def _act(name: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "gelu":
        return F.gelu(x)  # exact erf
    raise ValueError(f"unknown activation {name!r}")


def _parse_chain(pre, mid, post) -> Tuple[Optional[str], str, Optional[str]]:
    """Validate the chain description; return the three activations."""
    if pre is not None and (len(pre) != 2 or pre[0] not in ("relu", "gelu")):
        raise ValueError(f"pre must be None or (act, rate), got {pre!r}")
    if len(mid) != 3 or mid[0] not in ("relu", "gelu") or mid[1] not in ORDERS:
        raise ValueError(f"mid must be (act, order, rate), got {mid!r}")
    if post is not None and (
        len(post) != 3 or post[0] not in ("relu", "gelu") or post[1] != "drop_first"
    ):
        raise ValueError(f"post must be None or (act, 'drop_first', rate), got {post!r}")
    if any(c is not None and c[-1] > 0.0 for c in (pre, mid, post)):
        raise NotImplementedError("mlp dropout lands with the training slice")
    return (pre[0] if pre else None), mid[0], (post[0] if post else None)


def mlp_plain(x, w1, b1, w2, b2, pre=None, mid=("relu", "act_first", 0.0), post=None):
    """The same function in plain PyTorch: the CPU path, and the reference
    the kernel is held against on the card."""
    a_pre, a_mid, a_post = _parse_chain(pre, mid, post)
    h = _act(a_mid, torch.matmul(_act(a_pre, x), w1) + b1)
    return _act(a_post, torch.matmul(h, w2) + b2)


def fused_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    pre: Optional[Tuple] = None,
    mid: Tuple = ("relu", "act_first", 0.0),
    post: Optional[Tuple] = None,
) -> torch.Tensor:
    """Fused MLP over ``(..., K)`` inputs; returns ``(..., N)``.

    ``w1 (K, H)``, ``b1 (H,)``, ``w2 (H, N)``, ``b2 (N,)``.  On CUDA tensors
    the kernel takes float32, contiguous operands in a geometry that
    :func:`fused_mlp_supported` accepts, and raises on anything else.
    """
    acts = _parse_chain(pre, mid, post)
    K, H = w1.shape
    N = w2.shape[1]
    if x.shape[-1] != K or w2.shape[0] != H or b1.shape != (H,) or b2.shape != (N,):
        raise ValueError(
            f"fused_mlp shapes disagree: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}"
        )
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2, pre, mid, post)
    _check_cuda_operands("fused_mlp", (x, w1, b1, w2, b2), x.device)
    if not fused_mlp_supported(K, H, N):
        raise ValueError(
            f"fused_mlp kernel does not take K={K} H={H} N={N} "
            f"(N <= {MAX_OUT} and one block's shared memory <= {SMEM_LIMIT} bytes)"
        )
    lead = x.shape[:-1]
    M = x.numel() // K
    out = torch.empty((*lead, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    fn = _build.function("mlp_fwd", "gan_mlp_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), M, K, H, N, *(ACTS[a] for a in acts),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "mlp_fwd")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0  # kernel launches since the caller last reset it
