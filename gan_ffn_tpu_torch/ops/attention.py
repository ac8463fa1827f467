"""Fused masked multi-head attention forward (counterpart of
``gan_ffn_tpu/ops/attention.py``).

Semantics, over ``(B, H, L, Dh)`` operands:

- scores ``Q K^T / sqrt(Dh)`` in float32;
- keys at positions ``>= valid_len`` set to ``-1e30`` (not ``-inf``): with
  ``valid_len == 0`` every row is a uniform softmax over the ``L`` keys,
  never NaN;
- softmax over the key axis in float32; output ``P V``.

:func:`fused_attention` dispatches on the tensors' device: CPU tensors go
through :func:`attention_plain`, CUDA tensors through the hand-written
kernel in ``csrc/attention_fwd.cu`` -- it launches or raises, with no
fallback.  The TPU kernel's padding (L to 128 lanes, Dh to the sublane tile)
is a TPU layout and is not carried over.  Attention-weight dropout (the TPU
kernel's in-kernel PRNG) arrives with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
MAX_LEN = 128  # one thread per query row, one block per (b, h) (csrc kMaxLen)
MAX_HEAD_DIM = 64  # q and output row in registers (csrc 4 * kMaxDim4)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """The same function in plain PyTorch: the CPU path, and the reference the
    kernel is held against on the card."""
    L, Dh = q.shape[-2], q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    key_pos = torch.arange(L, device=q.device)
    scores = scores.masked_fill(key_pos >= valid_len, NEG_INF)
    return torch.matmul(torch.softmax(scores, dim=-1), v.float()).to(q.dtype)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: Optional[int] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Masked attention over ``(B, H, L, Dh)`` tensors; returns ``(B, H, L, Dh)``.

    ``valid_len`` (a host int, default ``L``) is clamped to ``min(valid_len,
    L)``.  On a CUDA tensor the kernel takes float32, contiguous operands
    with ``L <= 128`` and ``Dh <= 64`` and raises on anything else.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout lands with the training slice")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, L, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, L, Dh = q.shape
    valid_len = L if valid_len is None else min(int(valid_len), L)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, valid_len)
    _check_cuda_operands("fused_attention", (q, k, v), q.device)
    if L > MAX_LEN or Dh > MAX_HEAD_DIM:
        raise ValueError(
            f"fused_attention kernel takes L <= {MAX_LEN} and Dh <= {MAX_HEAD_DIM}, "
            f"got L={L}, Dh={Dh}"
        )
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.function("attention_fwd", "gan_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, L, Dh, valid_len, 1.0 / math.sqrt(Dh),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention_fwd")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0  # kernel launches since the caller last reset it


def _check_cuda_operands(op: str, tensors, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{op}: tensors on {device}; the port runs on cpu or cuda")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{op}: operands on {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: the CUDA kernel takes contiguous operands")
