"""Grouped SwiGLU experts, forward and backward: the routed experts of a
mixture-of-experts layer, and with one group a shared expert or a dense
SwiGLU FFN.

``x (T, H)`` holds rows sorted by group: group ``e`` owns rows
``offsets[e] .. offsets[e + 1] - 1`` (``offsets``: ``E + 1`` int32 on the
rows' device; None: one group of all T rows).  For a row of group ``e``
with routing weight ``w`` (1 where ``weights`` is None)::

    y = (w * silu(x Wg[e]^T) * (x Wu[e]^T)) Wd[e]^T

with ``w_gate``, ``w_up (E, F, H)`` and ``w_down (E, H, F)`` in torch's
Linear layout.  Rows at or past ``offsets[E]`` belong to no group: their
output is 0 on the CPU and left unwritten on the card, and the callers
(``nn/moe.py``) never read them.

:func:`grouped_swiglu` dispatches on the device.  CPU tensors run
:func:`grouped_swiglu_plain`, a loop over the groups whose autograd is the
backward.  CUDA tensors go through :class:`_GroupedSwiGLU`, which launches
``csrc/moe_ffn.cu``: two kernels forward (gate and up with the SwiGLU
epilogue, then down), and backward the SwiGLU derivative with the routing
weight's gradient, its row sums, dx, and both weight gradients, each summed
over a group's rows in one pass (their grids fill many waves at the widths
the experts train, so the reduction is not split as ``ops/mlp.py``'s is).
The kernels read the offsets from device memory and size their
grids for the worst case, so nothing of the routing reaches the host and a
captured graph replays any routing.  Products are 3xTF32 ``mma.sync``
(f32-accurate; ``tests/test_torch_moe_cuda.py`` holds them to the plain
loop).  The forward saves ``x``, the weights, ``[g | u]`` and ``a``; both
launch on the current stream and allocate through torch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .attention import _check_cuda_operands

LIBRARY = "moe_ffn"
_TILE = 64  # csrc/mlp_tile.cuh kBM = kBN
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, off; E, T, H, F; wg, wu, wd, z, a, y; stream
_FWD_ARGTYPES = [_P] * 3 + [_I] * 4 + [_P] * 6 + [_P]
# x, w, off; E, T, H, F; wg, wu, wd, z, a, dy, dx, dwg, dwu, dwd, dw, dz, dw_part; stream
_BWD_ARGTYPES = [_P] * 3 + [_I] * 4 + [_P] * 13 + [_P]


def grouped_swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The op as a loop over the groups: the CPU path, and what the kernels
    are held to on the card.  Differentiable; reads the offsets on the host."""
    T = x.shape[0]
    bounds = [0, T] if offsets is None else [int(o) for o in offsets.tolist()]
    pieces = []
    for e in range(len(bounds) - 1):
        xe = x[bounds[e]:bounds[e + 1]]
        h = F.silu(xe @ w_gate[e].t()) * (xe @ w_up[e].t())
        if weights is not None:
            h = h * weights[bounds[e]:bounds[e + 1], None]
        pieces.append(h @ w_down[e].t())
    pieces.append(x.new_zeros(T - bounds[-1], w_down.shape[1]))
    return torch.cat(pieces)


def _count(attr: str) -> None:
    """One more call on ``grouped_swiglu.<attr>``, unless a graph records it."""
    if not torch.cuda.is_current_stream_capturing():
        setattr(grouped_swiglu, attr, getattr(grouped_swiglu, attr) + 1)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(symbol: str, argtypes, args, device: torch.device) -> None:
    fn = _build.function(LIBRARY, symbol, argtypes)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, LIBRARY)


class _GroupedSwiGLU(torch.autograd.Function):
    """The kernels on checked, contiguous float32 CUDA operands."""

    @staticmethod
    def forward(ctx, x, weights, w_gate, w_up, w_down, offsets):
        T, H = x.shape
        E, F_ = w_gate.shape[:2]
        grad = any(ctx.needs_input_grad)
        z = x.new_empty(T, 2 * F_) if grad else None
        a, y = x.new_empty(T, F_), x.new_empty(T, H)
        _launch("gan_moe_ffn_fwd", _FWD_ARGTYPES,
                (x.data_ptr(), _ptr(weights), _ptr(offsets), E, T, H, F_, w_gate.data_ptr(),
                 w_up.data_ptr(), w_down.data_ptr(), _ptr(z), a.data_ptr(), y.data_ptr()),
                x.device)
        _count("launches")
        ctx.save_for_backward(x, weights, w_gate, w_up, w_down, offsets, z, a)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weights, w_gate, w_up, w_down, offsets, z, a = ctx.saved_tensors
        dy = dy.contiguous()
        T, H = x.shape
        E, F_ = w_gate.shape[:2]
        dx = torch.empty_like(x)
        dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
        dw = torch.empty_like(weights) if weights is not None else None
        dw_part = x.new_empty(T, -(-F_ // _TILE)) if weights is not None else None
        dz = x.new_empty(T, 2 * F_)
        _launch("gan_moe_ffn_bwd", _BWD_ARGTYPES,
                (x.data_ptr(), _ptr(weights), _ptr(offsets), E, T, H, F_, w_gate.data_ptr(),
                 w_up.data_ptr(), w_down.data_ptr(), z.data_ptr(), a.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), _ptr(dw),
                 dz.data_ptr(), _ptr(dw_part)),
                x.device)
        _count("backward_launches")
        return dx, dw, dwg, dwu, dwd, None


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(T, H)`` outputs of the groups' SwiGLU experts (see the module
    docstring).  On CUDA tensors the kernels take contiguous float32
    operands and raise on anything else.
    Differentiable in ``x``, ``weights`` and the three weights."""
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, w_gate, w_up, w_down, offsets, weights)
    T, H = x.shape
    E, F_ = w_gate.shape[:2]
    if (w_up.shape != w_gate.shape or w_gate.shape != (E, F_, H)
            or w_down.shape != (E, H, F_)):
        raise ValueError(f"grouped_swiglu: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)} and w_down {tuple(w_down.shape)} disagree")
    operands = [x, w_gate, w_up, w_down] + ([weights] if weights is not None else [])
    _check_cuda_operands("grouped_swiglu", operands, x.device)
    if offsets is None and E != 1:
        raise ValueError("grouped_swiglu: several groups need their offsets")
    if offsets is not None and (offsets.dtype != torch.int32 or offsets.shape != (E + 1,)
                                or offsets.device != x.device):
        raise ValueError(f"grouped_swiglu: offsets take E + 1 = {E + 1} int32 on {x.device}")
    return _GroupedSwiGLU.apply(x, weights, w_gate, w_up, w_down, offsets)


grouped_swiglu.launches = 0  # forward calls since the caller last reset them (2 kernels each)
grouped_swiglu.backward_launches = 0  # backward calls
