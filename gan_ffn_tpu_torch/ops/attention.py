"""Fused masked multi-head attention, forward and backward (counterpart of
``gan_ffn_tpu/ops/attention.py``).

Semantics, over ``(B, H, L, Dh)`` operands:

- scores ``Q K^T / sqrt(Dh)`` in float32;
- keys at positions ``>= valid_len`` set to ``-1e30`` (not ``-inf``): with
  ``valid_len == 0`` every row is a uniform softmax over the ``L`` keys,
  never NaN;
- softmax over the key axis in float32;
- optional attention-weight dropout: the weights are multiplied by the mask
  of ``ops.dropout`` stream ``STREAM_ATTENTION`` at flat index
  ``((b * H + h) * L + i) * L + j``, drawn from ``dropout_seed``;
- output ``P_drop V``.

``valid_len`` is a host int or a 0-d int32 tensor on the operands' device,
and ``dropout_seed`` a host int or an ``ops.dropout.SeedRef``.  The kernels
read both from device memory (a host value is first written there), so a
CUDA graph that records a call replays it at whatever ``valid_len`` and seed
base hold at replay time.

:func:`fused_attention` dispatches on the tensors' device.  CPU tensors go
through :func:`attention_plain`, and autograd of it is the backward.  CUDA
tensors go through :class:`_FusedAttention`: its forward launches
``csrc/attention_fwd.cu``, its backward :func:`fused_attention_backward`,
which launches ``csrc/attention_bwd.cu`` -- each launches or raises, with
no fallback.  The backward recomputes the softmax and the mask: the
function saves q, k and v only, never the ``(B, H, L, L)`` weights.  The
plain backward, :func:`attention_backward_plain`, is autograd of
:func:`attention_plain`; the kernel is held to it on the card within
max |diff| <= 1e-4 * max(1, max |ref|) (five f32 products over <= 128 keys,
summed in another order).  Both kernels run their products on the tensor
cores as TF32 ``mma.sync`` in the 3xTF32 split (``csrc/mma_tf32.cuh``),
which keeps them f32-accurate to ~2^-21 per product; one TF32 pass would
miss both limits (``tests/test_torch_attention_tf32.py``).

The TPU kernel's padding (L to 128 lanes, Dh to the sublane tile) is a TPU
layout and is not carried over.  At ``valid_len == 0`` the port follows the
XLA chain and its plain version: dQ = dK = 0 (the Pallas backward does not
zero the masked scores' gradient there; ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .dropout import STREAM_ATTENTION, Seed, SeedRef, keep_scale, threshold_and_scale

NEG_INF = -1e30
MAX_LEN = 128  # keys a block holds in 16 mma tiles of 8, one block per (b, h) (csrc kMaxLen)
MAX_HEAD_DIM = 64  # the widest of the kernels' head widths 16, 32, 64 (csrc kWidths)

# dropout on, seed base pointer, seed index, threshold, scale
_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float]
# operands, B H L Dh, valid_len pointer, scale, dropout, stream
_FWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_float]
                 + _DROP_ARGTYPES + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_float]
                 + _DROP_ARGTYPES + [ctypes.c_void_p])


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    dropout_rate: float = 0.0,
    dropout_seed: Seed = 0,
) -> torch.Tensor:
    """The same function in plain PyTorch: the CPU path, and the reference the
    kernel is held against on the card.  ``valid_len`` an int or a 0-d
    tensor: keys at positions ``>=`` it are masked, so any value ``<= 0``
    masks every key and any ``>= L`` none.  Differentiable."""
    B, H, L, Dh = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    key_pos = torch.arange(L, device=q.device)
    scores = scores.masked_fill(key_pos >= valid_len, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        attn = attn * keep_scale(dropout_seed, STREAM_ATTENTION, attn.shape, dropout_rate,
                                 q.device)
    return torch.matmul(attn, v.float()).to(q.dtype)


def attention_backward_plain(q, k, v, dout, valid_len, dropout_rate=0.0, dropout_seed=0):
    """(dq, dk, dv): autograd of :func:`attention_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_plain(*leaves, valid_len, dropout_rate, dropout_seed)
        return torch.autograd.grad(out, leaves, dout)


def _check_shapes(q, k, v) -> Tuple[int, int, int, int]:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, L, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    return tuple(q.shape)


def _check_kernel_geometry(op: str, L: int, Dh: int) -> None:
    if L > MAX_LEN or Dh > MAX_HEAD_DIM:
        raise ValueError(
            f"{op} kernel takes L <= {MAX_LEN} and Dh <= {MAX_HEAD_DIM}, got L={L}, Dh={Dh}"
        )


def _device_valid_len(valid_len, device) -> torch.Tensor:
    """``valid_len`` as the 0-d int32 tensor on ``device`` that the kernels read."""
    if isinstance(valid_len, torch.Tensor):
        if valid_len.dim() != 0 or valid_len.dtype != torch.int32 or valid_len.device != device:
            raise ValueError(f"valid_len must be a 0-d int32 tensor on {device}, got "
                             f"{tuple(valid_len.shape)} {valid_len.dtype} on {valid_len.device}")
        return valid_len
    return torch.full((), int(valid_len), dtype=torch.int32, device=device)


def device_seed(seed: Seed, device) -> SeedRef:
    """``seed`` as the :class:`~.dropout.SeedRef` on ``device`` that a kernel
    reads: a host int is written to the device and taken as the seed."""
    if not isinstance(seed, SeedRef):
        if isinstance(seed, torch.Tensor):
            return device_seed(SeedRef(seed, -1), device)
        seed = SeedRef(torch.full((), int(seed), dtype=torch.int64, device=device), -1)
    base = seed.base
    if base.dim() != 0 or base.dtype != torch.int64 or base.device != device:
        raise ValueError(f"a seed base must be a 0-d int64 tensor on {device}, got "
                         f"{tuple(base.shape)} {base.dtype} on {base.device}")
    return seed


def _dropout_args(rate: float, seed: Optional[SeedRef]):
    if rate <= 0.0:
        return 0, None, 0, 0, 1.0
    threshold, scale = threshold_and_scale(rate)
    return 1, seed.base.data_ptr(), seed.index, threshold, scale


def _launch_fwd(q, k, v, valid_len, rate, seed) -> torch.Tensor:
    B, H, L, Dh = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.function("attention_fwd", "gan_attention_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, L, Dh, valid_len.data_ptr(), 1.0 / math.sqrt(Dh), *_dropout_args(rate, seed),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention_fwd")
    _build.count_launch(fused_attention)
    return out


class _FusedAttention(torch.autograd.Function):
    """attention_fwd.cu forward, attention_bwd.cu backward; saves q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len, rate, seed):
        ctx.save_for_backward(q, k, v)
        ctx.valid_len, ctx.rate, ctx.seed = valid_len, rate, seed
        return _launch_fwd(q, k, v, valid_len, rate, seed)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(
            q, k, v, dout, ctx.valid_len, ctx.rate, ctx.seed
        )
        return dq, dk, dv, None, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len=None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Seed] = None,
) -> torch.Tensor:
    """Masked attention over ``(B, H, L, Dh)`` tensors; returns ``(B, H, L, Dh)``.

    ``valid_len`` (a host int or a 0-d int32 tensor on the operands' device;
    default ``L``) masks the keys at positions ``>=`` it.  ``dropout_rate >
    0`` applies attention-weight dropout drawn from ``dropout_seed`` (a host
    int or a :class:`~.dropout.SeedRef`; default 0).  On a CUDA tensor the
    kernels take float32, contiguous operands with ``L <= 128`` and ``Dh <=
    64`` and raise on anything else.  Differentiable in q, k and v.
    """
    B, H, L, Dh = _check_shapes(q, k, v)
    valid_len = L if valid_len is None else valid_len
    if not isinstance(valid_len, torch.Tensor):
        valid_len = min(int(valid_len), L)
    rate = float(dropout_rate)
    seed = 0 if dropout_seed is None else dropout_seed
    threshold_and_scale(rate)  # refuses a rate outside [0, 1)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, valid_len, rate, seed)
    _check_cuda_operands("fused_attention", (q, k, v), q.device)
    _check_kernel_geometry("fused_attention", L, Dh)
    return _FusedAttention.apply(q, k, v, _device_valid_len(valid_len, q.device), rate,
                                 device_seed(seed, q.device) if rate > 0.0 else None)


fused_attention.launches = 0  # forward kernel launches since the caller last reset it


def fused_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    valid_len,
    dropout_rate: float = 0.0,
    dropout_seed: Seed = 0,
):
    """(dq, dk, dv) of :func:`fused_attention` for the upstream gradient
    ``dout``, with the forward's ``valid_len``, rate and seed (each as
    :func:`fused_attention` takes it).  CPU tensors:
    :func:`attention_backward_plain`; CUDA tensors: ``attention_bwd.cu``.
    ``dout`` is made contiguous here (autograd hands over a permuted view)."""
    B, H, L, Dh = _check_shapes(q, k, v)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q {tuple(q.shape)}")
    if not isinstance(valid_len, torch.Tensor):
        valid_len = min(int(valid_len), L)
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, dout, valid_len, dropout_rate, dropout_seed)
    dout = dout.contiguous()
    _check_cuda_operands("fused_attention_backward", (q, k, v, dout), q.device)
    _check_kernel_geometry("fused_attention_backward", L, Dh)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    rate = float(dropout_rate)
    valid_len = _device_valid_len(valid_len, q.device)
    seed = device_seed(dropout_seed, q.device) if rate > 0.0 else None
    fn = _build.function("attention_bwd", "gan_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, L, Dh, valid_len.data_ptr(), 1.0 / math.sqrt(Dh),
            *_dropout_args(rate, seed),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "attention_bwd")
    _build.count_launch(fused_attention_backward)
    return dq, dk, dv


fused_attention_backward.launches = 0  # backward kernel launches since the last reset


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
