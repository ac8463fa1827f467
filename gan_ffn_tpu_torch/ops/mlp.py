"""Fused two-layer MLP, forward and backward (counterpart of
``gan_ffn_tpu/ops/mlp.py``): ``post(mid(pre(x) @ W1 + b1) @ W2 + b2)`` with
the ``(M, d_ff)`` intermediate kept on chip in the forward.

The elementwise chains take the JAX package's static description::

  pre  = None | (act, rate)                 # act THEN dropout, on the input
  mid  = (act, order, rate)                 # between the matmuls
  post = None | (act, "drop_first", rate)   # after the second matmul

with ``act`` in {"relu", "gelu"} (gelu is exact-erf) and ``order`` in
{"drop_first" (``act(dropout(z))``), "act_first" (``dropout(act(z))``)}.
Two configurations are on the path: the encoder FFN ``mid=("relu",
"act_first", rate)`` and the generator head ``pre=("gelu", rate),
mid=("gelu", "drop_first", rate), post=("gelu", "drop_first", rate)``.
Dropout masks come from ``ops.dropout``: one ``dropout_seed`` per call,
streams ``STREAM_PRE``, ``STREAM_MID`` and ``STREAM_POST``, addressed by the
flat ``(row, col)`` index of the ``(M, K)``, ``(M, H)`` and ``(M, N)``
tensors, rows counted over the input flattened to ``(M, K)``.

:func:`fused_mlp` dispatches on the device: CPU tensors go through
:func:`mlp_plain`, and autograd of it is the backward.  CUDA tensors go
through :class:`_FusedMLP`: its forward launches ``csrc/mlp_fwd.cu``, its
backward :func:`fused_mlp_backward`, which launches ``csrc/mlp_bwd.cu``;
each launches or raises.  The function saves the inputs only; the backward
recomputes the forward and the masks.  The plain backward,
:func:`mlp_backward_plain`, is autograd of :func:`mlp_plain`; the kernel is
held to it on the card within max |diff| <= 1e-4 * max(1, max |ref|) per
output (f32 sums over up to M = 3584 rows in another order).  Weights use
the kernel layout ``w1 (K, H)``, ``w2 (H, N)``.

Which geometries the kernels take is derived for Hopper, not copied from the
TPU guard, which is sized by the TPU backward kernel's VMEM and refuses the
visual FFN 512->2048->512.  The forward kernel (:func:`fused_mlp_supported`)
streams d_ff in 128-column chunks and keeps a ``(32, N)`` float32
accumulator in registers: ``N <= 512``, and one block's ``pre(x)`` rows plus
double-buffered weight slices fit 227 KB of shared memory.  The backward
(:func:`fused_mlp_bwd_supported`) is a chain of 64 x 64-tiled products with
fixed shared memory (8.7 KB) and registers, so any geometry fits it whose
flat indices stay below 2**31 and whose row tiles fit one launch's grid.
All four geometries of the path pass both:
100->2048->100, 512->2048->512, 100->512->100 and 512->1024->100.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .attention import _check_cuda_operands
from .dropout import STREAM_MID, STREAM_POST, STREAM_PRE, keep_scale, threshold_and_scale

ACTS = {None: 0, "relu": 1, "gelu": 2}  # the csrc Act codes
ORDERS = ("drop_first", "act_first")
MAX_OUT = 512  # csrc kMaxColGroups * kColGroup
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
INDEX_LIMIT = 2**31  # the kernels' int flat indices
GRID_Y_LIMIT = 65535  # a launch's grid y extent
# csrc tile constants: kRows, kSliceK, kChunk, kSliceH, kColGroup, kPad
_ROWS, _SLICE_K, _CHUNK, _SLICE_H, _COL_GROUP, _PAD = 32, 32, 128, 16, 128, 4
_BWD_TILE = 64  # csrc/mlp_bwd.cu kBM: output rows of one block

_CHAIN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_uint64] + [ctypes.c_void_p] * 3
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + _CHAIN_ARGTYPES
                 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + _CHAIN_ARGTYPES
                 + [ctypes.c_void_p])


def _smem_bytes(K: int, N: int) -> int:
    """Shared memory of one forward block (csrc ``gan_mlp_fwd_smem_bytes``)."""
    Kp = -(-K // _SLICE_K) * _SLICE_K + _PAD
    Np = -(-N // _COL_GROUP) * _COL_GROUP
    return 4 * (_ROWS * Kp + 2 * _SLICE_K * _CHUNK + _ROWS * (_CHUNK + _PAD) + 2 * _SLICE_H * Np)


def fused_mlp_supported(K: int, H: int, N: int) -> bool:
    """True iff the forward CUDA kernel takes the ``K -> H -> N`` geometry."""
    return min(K, H, N) >= 1 and N <= MAX_OUT and _smem_bytes(K, N) <= SMEM_LIMIT


def fused_mlp_bwd_supported(K: int, H: int, N: int, M: int = 1) -> bool:
    """True iff the backward CUDA kernel takes ``K -> H -> N`` over ``M``
    rows: its shared memory and registers do not depend on the geometry, so
    only the flat indices and the grid's row tiles bound it (csrc
    ``gan_mlp_bwd``)."""
    return (min(K, H, N, M) >= 1 and M * max(K, H, N) < INDEX_LIMIT
            and (K + 1) * H < INDEX_LIMIT and (H + 1) * N < INDEX_LIMIT
            and max(M, K, H) + 1 <= GRID_Y_LIMIT * _BWD_TILE)


def _act(name: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "gelu":
        return F.gelu(x)  # exact erf
    raise ValueError(f"unknown activation {name!r}")


def _parse_chain(pre, mid, post) -> Tuple[Tuple, Tuple[float, float, float]]:
    """Validate the chain description; return (pre act, mid act, mid order,
    post act) and the three rates (0 where a site is absent)."""
    if pre is not None and (len(pre) != 2 or pre[0] not in ("relu", "gelu")):
        raise ValueError(f"pre must be None or (act, rate), got {pre!r}")
    if len(mid) != 3 or mid[0] not in ("relu", "gelu") or mid[1] not in ORDERS:
        raise ValueError(f"mid must be (act, order, rate), got {mid!r}")
    if post is not None and (
        len(post) != 3 or post[0] not in ("relu", "gelu") or post[1] != "drop_first"
    ):
        raise ValueError(f"post must be None or (act, 'drop_first', rate), got {post!r}")
    rates = tuple(float(c[-1]) if c is not None else 0.0 for c in (pre, mid, post))
    for r in rates:
        threshold_and_scale(r)  # refuses a rate outside [0, 1)
    acts = ((pre[0] if pre else None), mid[0], mid[1], (post[0] if post else None))
    return acts, rates


def mlp_plain(x, w1, b1, w2, b2, pre=None, mid=("relu", "act_first", 0.0), post=None,
              dropout_seed: int = 0):
    """The same function in plain PyTorch: the CPU path, and the reference
    the kernel is held against on the card.  Differentiable."""
    (a_pre, a_mid, order, a_post), (r_pre, r_mid, r_post) = _parse_chain(pre, mid, post)
    K, H, N = w1.shape[0], w1.shape[1], w2.shape[1]
    lead = x.shape[:-1]
    t = x.reshape(-1, K)
    M = t.shape[0]

    def mask(stream, cols, rate):
        return keep_scale(dropout_seed, stream, (M, cols), rate, x.device)

    t = _act(a_pre, t)
    if a_pre is not None and r_pre > 0.0:
        t = t * mask(STREAM_PRE, K, r_pre)
    z = torch.matmul(t, w1) + b1
    if r_mid > 0.0:
        m = mask(STREAM_MID, H, r_mid)
        h = _act(a_mid, z * m) if order == "drop_first" else _act(a_mid, z) * m
    else:
        h = _act(a_mid, z)
    z = torch.matmul(h, w2) + b2
    if a_post is not None and r_post > 0.0:
        z = z * mask(STREAM_POST, N, r_post)
    return _act(a_post, z).reshape(*lead, N)


def mlp_backward_plain(x, w1, b1, w2, b2, dout, pre=None, mid=("relu", "act_first", 0.0),
                       post=None, dropout_seed: int = 0):
    """(dx, dw1, db1, dw2, db2): autograd of :func:`mlp_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        out = mlp_plain(*leaves, pre, mid, post, dropout_seed)
        return torch.autograd.grad(out, leaves, dout)


def _chain_args(pre, mid, post, seed):
    """The C entries' chain arguments and the host arrays they point into."""
    (a_pre, a_mid, order, a_post), rates = _parse_chain(pre, mid, post)
    on = [int(r > 0.0) for r in rates]
    on[0] &= a_pre is not None
    on[2] &= a_post is not None
    ts = [threshold_and_scale(r) if o else (0, 1.0) for r, o in zip(rates, on)]
    arrays = ((ctypes.c_uint32 * 3)(*(t for t, _ in ts)),
              (ctypes.c_float * 3)(*(s for _, s in ts)),
              (ctypes.c_int * 3)(*on))
    args = (ACTS[a_pre], ACTS[a_mid], ACTS[a_post], int(order == "act_first"),
            int(seed) if any(on) else 0, *(ctypes.addressof(a) for a in arrays))
    return args, arrays


def _launch_fwd(x2, w1, b1, w2, b2, chain, seed) -> torch.Tensor:
    M, K = x2.shape
    H, N = w2.shape
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    fn = _build.function("mlp_fwd", "gan_mlp_fwd", _FWD_ARGTYPES)
    args, _arrays = _chain_args(*chain, seed)
    with torch.cuda.device(x2.device):
        code = fn(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), M, K, H, N, *args,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _build.check(code, "mlp_fwd")
    fused_mlp.launches += 1
    return out


class _FusedMLP(torch.autograd.Function):
    """mlp_fwd.cu forward, mlp_bwd.cu backward; saves the inputs only."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, chain, seed):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        ctx.chain, ctx.seed = chain, seed
        return _launch_fwd(x2, w1, b1, w2, b2, chain, seed)

    @staticmethod
    def backward(ctx, dout):
        grads = fused_mlp_backward(*ctx.saved_tensors, dout, *ctx.chain, dropout_seed=ctx.seed)
        return (*grads, None, None)


def _check_geometry(x, w1, b1, w2, b2) -> Tuple[int, int, int]:
    K, H = w1.shape
    N = w2.shape[1]
    if x.shape[-1] != K or w2.shape[0] != H or b1.shape != (H,) or b2.shape != (N,):
        raise ValueError(
            f"fused_mlp shapes disagree: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}"
        )
    return K, H, N


def fused_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    pre: Optional[Tuple] = None,
    mid: Tuple = ("relu", "act_first", 0.0),
    post: Optional[Tuple] = None,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Fused MLP over ``(..., K)`` inputs; returns ``(..., N)``.

    ``w1 (K, H)``, ``b1 (H,)``, ``w2 (H, N)``, ``b2 (N,)``.  ``dropout_seed``
    (a host int, default 0) draws every mask of the call.  On CUDA tensors
    the kernels take float32, contiguous operands in a geometry that
    :func:`fused_mlp_supported` and :func:`fused_mlp_bwd_supported` accept,
    and raise on anything else.  Differentiable in every tensor argument.
    """
    _parse_chain(pre, mid, post)
    K, H, N = _check_geometry(x, w1, b1, w2, b2)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2, pre, mid, post, seed)
    _check_cuda_operands("fused_mlp", (x, w1, b1, w2, b2), x.device)
    lead = x.shape[:-1]
    M = x.numel() // K
    if not (fused_mlp_supported(K, H, N) and fused_mlp_bwd_supported(K, H, N, max(M, 1))):
        raise ValueError(
            f"fused_mlp kernels do not take M={M} K={K} H={H} N={N} (forward: N <= "
            f"{MAX_OUT} and one block's shared memory <= {SMEM_LIMIT} bytes; backward: "
            f"flat indices < 2**31 and at most {GRID_Y_LIMIT * _BWD_TILE} rows)"
        )
    out = _FusedMLP.apply(x.reshape(M, K), w1, b1, w2, b2, (pre, mid, post), seed)
    return out.reshape(*lead, N)


fused_mlp.launches = 0  # forward kernel launches since the caller last reset it


def fused_mlp_backward(x, w1, b1, w2, b2, dout, pre=None, mid=("relu", "act_first", 0.0),
                       post=None, dropout_seed: int = 0):
    """(dx, dw1, db1, dw2, db2) of :func:`fused_mlp` over ``(M, K)`` inputs
    for the upstream gradient ``dout (M, N)``, with the forward's chain and
    seed.  CPU tensors: :func:`mlp_backward_plain`; CUDA tensors:
    ``mlp_bwd.cu`` (its launches and scratch buffers, one call)."""
    K, H, N = _check_geometry(x, w1, b1, w2, b2)
    if x.dim() != 2 or dout.shape != (x.shape[0], N):
        raise ValueError(f"fused_mlp_backward takes x (M, K) and dout (M, N), got "
                         f"{tuple(x.shape)} and {tuple(dout.shape)}")
    if x.device.type == "cpu":
        return mlp_backward_plain(x, w1, b1, w2, b2, dout, pre, mid, post, dropout_seed)
    dout = dout.contiguous()
    _check_cuda_operands("fused_mlp_backward", (x, w1, b1, w2, b2, dout), x.device)
    M = x.shape[0]
    if not fused_mlp_bwd_supported(K, H, N, max(M, 1)):
        raise ValueError(f"fused_mlp_backward kernel does not take M={M} K={K} H={H} N={N}")
    dx = torch.empty_like(x)
    dw1, db1, dw2, db2 = (torch.empty_like(t) for t in (w1, b1, w2, b2))
    if M == 0:
        for t in (dw1, db1, dw2, db2):
            t.zero_()
        return dx, dw1, db1, dw2, db2
    args, _arrays = _chain_args(pre, mid, post, dropout_seed)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)  # noqa: E731
    t1 = empty(M, K) if pre is not None else empty(0)
    a1, d1 = empty(M, H), empty(M, H)
    g = empty(M, N) if post is not None else empty(0)
    fn = _build.function("mlp_bwd", "gan_mlp_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), t1.data_ptr(), a1.data_ptr(), d1.data_ptr(), g.data_ptr(),
            M, K, H, N, *args, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "mlp_bwd")
    fused_mlp_backward.launches += 1
    return dx, dw1, db1, dw2, db2


fused_mlp_backward.launches = 0  # backward kernel calls since the caller last reset it
