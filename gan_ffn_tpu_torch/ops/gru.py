"""The GRU's gate math, forward and backward: one hand-written CUDA kernel
each on the card (``csrc/gru_gates.cu``), the chain of torch ops on the CPU.

From the input's projection with its bias ``gi (..., 3H)``, the recurrent
projection with its bias ``gh (..., 3H)`` and the state ``h (..., H)``, in
torch's gate order::

    r = sigmoid(i_r + h_r)
    z = sigmoid(i_z + h_z)
    n = tanh(i_n + r * h_n)
    h' = (1 - z) * n + z * h

``gi`` has ``gh``'s shape, or size 1 on the axis before the last where ``h``
has P there (the DialogueRNN's party cell, whose input is the same for every
party): it is then broadcast, and its gradient summed over that axis.

:func:`gru_gates` dispatches on the device.  CPU tensors run
:func:`gru_gates_plain`, the chain of torch ops, and autograd of it is the
backward.  CUDA tensors, float32 or bfloat16, go through :class:`_GRUGates`:
its forward launches ``gru_gates_fwd_kernel``, its backward
``gru_gates_bwd_kernel``, which writes ``dgi``, ``dgh`` and the direct part
of ``dh`` in one launch, recomputing r, z and n; each launches or raises.
The kernels round where the chain's ops round (at f32 no contracted FMA, at
bf16 each op's result rounded to bf16), so on the card the forward gives the
chain's bits (``tests/test_torch_gru_cuda.py``).  Both launch on the current
stream and allocate through torch, so a CUDA graph records them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import KERNEL_DTYPES, _check_cuda_operands

LIBRARY = "gru_gates"
# gi, gh, h, out; gi rows, parties, H, bf16; stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# gi, gh, h, dout, dgi, dgh, dh; gi rows, parties, H, bf16; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def gru_gates_plain(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The gate math as a chain of torch ops: the CPU path, and the version
    the kernels are held to on the card.  Differentiable."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def _parties(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> int:
    """How many rows of ``h`` share one row of ``gi`` (see the module docstring)."""
    want = (*h.shape[:-1], 3 * h.shape[-1])
    if tuple(gh.shape) == want:
        if tuple(gi.shape) == want:
            return 1
        if h.dim() >= 2 and tuple(gi.shape) == (*h.shape[:-2], 1, want[-1]):
            return h.shape[-2]
    raise ValueError(f"gru_gates: gi {tuple(gi.shape)}, gh {tuple(gh.shape)} and h "
                     f"{tuple(h.shape)} disagree")


def _launch(fn_name: str, argtypes, tensors, gi_rows: int, parties: int, hidden: int):
    fn = _build.function(LIBRARY, fn_name, argtypes)
    device = tensors[0].device
    with torch.cuda.device(device):
        code = fn(*(t.data_ptr() for t in tensors), gi_rows, parties, hidden,
                  int(tensors[0].dtype == torch.bfloat16),
                  torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, LIBRARY)


class _GRUGates(torch.autograd.Function):
    """The kernels on checked, contiguous CUDA operands.  Saves gi, gh, h."""

    @staticmethod
    def forward(ctx, gi, gh, h, parties):
        ctx.save_for_backward(gi, gh, h)
        ctx.parties = parties
        out = torch.empty_like(h)
        if h.numel():
            _launch("gan_gru_gates_fwd", _FWD_ARGTYPES, (gi, gh, h, out),
                    gi.numel() // gi.shape[-1], parties, h.shape[-1])
        _build.count_launch(gru_gates)
        return out

    @staticmethod
    def backward(ctx, dout):
        gi, gh, h = ctx.saved_tensors
        return (*_launch_bwd(gi, gh, h, dout.contiguous(), ctx.parties), None)


def _launch_bwd(gi, gh, h, dout, parties: int):
    dgi, dgh, dh = torch.empty_like(gi), torch.empty_like(gh), torch.empty_like(h)
    if h.numel():
        _launch("gan_gru_gates_bwd", _BWD_ARGTYPES, (gi, gh, h, dout, dgi, dgh, dh),
                gi.numel() // gi.shape[-1], parties, h.shape[-1])
    _build.count_launch(gru_gates_backward)
    return dgi, dgh, dh


def gru_gates(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``h'`` from ``gi``, ``gh`` and ``h`` (see the module docstring).  On a
    CUDA tensor the kernels take float32 or bfloat16 operands of one dtype
    and raise on anything else.  Differentiable in all three."""
    if h.device.type == "cpu":
        return gru_gates_plain(gi, gh, h)
    parties = _parties(gi, gh, h)
    gi, gh, h = gi.contiguous(), gh.contiguous(), h.contiguous()
    _check_cuda_operands("gru_gates", (gi, gh, h), h.device, KERNEL_DTYPES)
    return _GRUGates.apply(gi, gh, h, parties)


gru_gates.launches = 0  # forward kernel launches since the caller last reset it


def gru_gates_backward(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor,
                       dout: torch.Tensor):
    """``(dgi, dgh, dh)`` of :func:`gru_gates` on CUDA tensors, by
    ``gru_gates_bwd_kernel``, for the upstream gradient ``dout``: ``dh`` the
    direct part (``dout * z``; the part through ``gh`` is the caller's
    product).  On the CPU, autograd of :func:`gru_gates_plain` is the
    backward."""
    parties = _parties(gi, gh, h)
    operands = tuple(t.contiguous() for t in (gi, gh, h, dout))
    _check_cuda_operands("gru_gates_backward", operands, h.device, KERNEL_DTYPES)
    return _launch_bwd(*operands, parties)


gru_gates_backward.launches = 0  # backward kernel launches since the caller last reset it
