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
Dropout masks come from ``ops.dropout``: one ``dropout_seed`` per call (a
host int or an ``ops.dropout.SeedRef``, which the kernels read from device
memory), streams ``STREAM_PRE``, ``STREAM_MID`` and ``STREAM_POST``,
addressed by the flat ``(row, col)`` index of the ``(M, K)``, ``(M, H)`` and
``(M, N)`` tensors, rows counted over the input flattened to ``(M, K)``.

:func:`fused_mlp` dispatches on the device: float32 CPU tensors go through
:func:`mlp_plain`, and autograd of it is the backward.  CUDA tensors go
through :class:`_FusedMLP`: its forward launches ``csrc/mlp_fwd.cu``, its
backward :func:`fused_mlp_backward`, which launches ``csrc/mlp_bwd.cu``
(their bf16 twins at bf16); each launches or raises.  The function saves
the inputs only; the backward recomputes the forward and the masks.  The plain backward,
:func:`mlp_backward_plain`, is autograd of :func:`mlp_plain`; the kernel is
held to it on the card within max |diff| <= 1e-4 * max(1, max |ref|) per
output (f32 sums over up to M = 3584 rows in another order).  Weights use
the kernel layout ``w1 (K, H)``, ``w2 (H, N)``.

Which geometries the kernels take is derived for Hopper, not copied from the
TPU guard, which is sized by the TPU backward kernel's VMEM and refuses the
visual FFN 512->2048->512.  Both kernels run their products on the tensor
cores (TF32 ``mma.sync`` in the 3xTF32 split, f32-accurate), each block
computing 64 x 64 output tiles with fixed shared memory and registers, so
any geometry fits them whose flat indices stay below 2**31 and whose row
tiles fit one launch's grid (:func:`fused_mlp_supported`).  Their bound is
the products' flops at 165 TFLOP/s (495 TF32 over three products).  The forward computes z1 through
the same tile code as the backward's recompute, so the two give the same
bits and relu' takes the branch relu took (with ``pre``, both first write
``pre(x)`` to a scratch by one shared elementwise kernel).  A forward block
owns 64 rows and a chunk of d_ff (:func:`fwd_split`): it keeps its ``a1``
tile in shared memory and writes a partial ``(64, N)`` product to a workspace of
:func:`fwd_workspace_floats` floats, which a second kernel sums in
ascending chunk order.  The backward launches that reduce over a long axis
into at most half a wave of blocks (dx over H; dW1, db1 and dW2, db2 over
M) split it into chunks that about fill one wave of :data:`WAVE_BLOCKS`
(:func:`split_reduction`): each (tile, chunk) block writes a partial tile
to a workspace of :func:`bwd_workspace_floats` floats, and a second kernel
sums the partials in ascending chunk order.
All four geometries of the path pass both:
100->2048->100, 512->2048->512, 100->512->100 and 512->1024->100.

bfloat16 operands run at the JAX kernels' rounding points.  The forward
(``gan_ffn_tpu/ops/mlp.py:107-146``): x, b1 and b2 read as f32, the pre
chain in f32 and t1 rounded to bf16 for the first product, z1 with f32 sums
+ b1 and the mid chain in f32, a1 rounded to bf16, z2 with f32 sums + b2
and the post chain in f32, the output rounded to bf16.  The backward
(``:162-233``): the chain recomputed so, g = dz2 in f32 and rounded to bf16
for its products, dW2 = a1^T g and da1 = g W2^T, dz1 in f32 and rounded to
bf16 for dW1 = t1^T dz1 and dt1 = dz1 W1^T, db1 and db2 summed from the f32
dz1 and g, dx rounded to bf16, and dW, db summed over every row in f32 and
cast once to the weights' dtype.  :func:`mlp_plain` and
:func:`mlp_backward_plain` round at the same points; on CUDA bf16 tensors
:func:`mlp_fwd_bf16` launches ``csrc/mlp_fwd_bf16.cu`` (its own d_ff
split, :func:`fwd_bf16_split`, in whole waves of the card's SMs) and
:func:`mlp_bwd_bf16` ``csrc/mlp_bwd_bf16.cu``, each held to its plain
version within 2^-8 * max(1, max |ref|) with at least 99% of the elements
identical.  All take every product's sum exactly,
rounded to f32 once (``ops.attention.exact_matmul``; the kernels on the f64
tensor cores), so their roundings do not depend on the order of the sums.
The bf16 tensor cores truncate their sums, and a z1 one ulp off at a bf16
boundary changes an a1 that every output of its row reads (the kernels'
notes have the measurements).  The backward's z1 comes from the forward's
own tile code (``csrc/mlp_bf16_tile.cuh``), so relu' takes the branch that
relu took.  :func:`fused_mlp_supported` gives the same answer at both
dtypes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .attention import KERNEL_DTYPES, _check_cuda_operands, device_seed, exact_matmul
from .dropout import (STREAM_MID, STREAM_POST, STREAM_PRE, Seed, keep_scale,
                      threshold_and_scale)

ACTS = {None: 0, "relu": 1, "gelu": 2}  # the csrc Act codes
ORDERS = ("drop_first", "act_first")
INDEX_LIMIT = 2**31  # the kernels' int flat indices
GRID_Y_LIMIT = 65535  # a launch's grid y extent
# csrc/mlp_tile.cuh: kBM = kBN (an output tile's rows and columns), kBK (the
# k-slice), kWaveBlocks (one wave: 4 blocks on each of the H100's 132 SMs)
_TILE, _SLICE, WAVE_BLOCKS = 64, 32, 4 * 132
# csrc/mlp_fwd.cu kMaxChunkTiles: the 64-column tiles of d_ff a forward block holds
FWD_CHUNK_TILES = 4

# acts and order, seed base pointer, seed index, thresholds, scales, drop_on
_CHAIN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
_FWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + _CHAIN_ARGTYPES
                 + [ctypes.c_void_p])
_FWD_BF16_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + _CHAIN_ARGTYPES
                      + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + _CHAIN_ARGTYPES
                 + [ctypes.c_void_p])
_BWD_BF16_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + _CHAIN_ARGTYPES
                      + [ctypes.c_void_p])


def fused_mlp_supported(K: int, H: int, N: int, M: int = 1) -> bool:
    """True iff both CUDA kernels take ``K -> H -> N`` over ``M`` rows.
    Their shared memory and registers do not depend on the geometry, so
    only the int flat indices and the grid's row tiles bound them: those of
    the backward's outputs (M, K + 1 and H + 1 rows; csrc ``gan_mlp_bwd``),
    which hold the forward's (csrc ``gan_mlp_fwd``) too.  A split's chunks
    stay far below the grid's z extent: at most ``WAVE_BLOCKS``."""
    return (min(K, H, N, M) >= 1 and M * max(K, H, N) < INDEX_LIMIT
            and (K + 1) * H < INDEX_LIMIT and (H + 1) * N < INDEX_LIMIT
            and max(M, K, H) + 1 <= GRID_Y_LIMIT * _TILE)


def split_reduction(tiles: int, depth: int) -> Tuple[int, int]:
    """``(S, chunk)``: how a backward launch of ``tiles`` output tiles splits
    a reduction of length ``depth`` (csrc ``split_reduction``).  Not at all
    (``S = 1``) where the tiles make half of :data:`WAVE_BLOCKS` alone;
    else into ``s = min(WAVE_BLOCKS // tiles, slices)`` chunks of
    ``ceil(slices / s)`` 32-deep k-slices each, the last possibly shorter
    (rounding may leave fewer than ``s``)."""
    slices = -(-depth // _SLICE)
    if 2 * tiles > WAVE_BLOCKS or slices <= 1:
        return 1, slices * _SLICE
    s = min(WAVE_BLOCKS // tiles, slices)
    chunk = -(-slices // s) * _SLICE
    return -(-depth // chunk), chunk


def _split_launches(launches) -> list:
    """Each ``(name, rows, cols, depth)`` launch with its output tiles,
    chunks ``S``, chunk length and blocks (:func:`split_reduction`)."""
    out = []
    for name, rows, cols, depth in launches:
        tiles = -(-rows // _TILE) * -(-cols // _TILE)
        S, chunk = split_reduction(tiles, depth)
        out.append({"name": name, "outputs": [rows, cols], "depth": depth, "tiles": tiles,
                    "chunks": S, "chunk": chunk, "blocks": tiles * S})
    return out


def _split_workspace(launches) -> int:
    """The largest chunks x outputs of the launches that split, 0 where none does."""
    return max([l["chunks"] * l["outputs"][0] * l["outputs"][1]
                for l in launches if l["chunks"] > 1], default=0)


def bwd_launches(M: int, K: int, H: int, N: int) -> list:
    """The backward's three launches that may split their reduction: name,
    output shape (the dW launches carry the bias as one more row), depth,
    output tiles, chunks ``S``, chunk length and blocks."""
    return _split_launches((("dx", M, K, H), ("dw1_db1", K + 1, H, M),
                            ("dw2_db2", H + 1, N, M)))


def bwd_workspace_floats(M: int, K: int, H: int, N: int) -> int:
    """Floats of workspace the backward kernel needs (csrc
    ``gan_mlp_bwd_workspace_floats``): the largest chunks x outputs of a
    launch that splits, 0 where none does."""
    if min(M, K, H, N) < 1:
        return 0
    return _split_workspace(bwd_launches(M, K, H, N))


def bwd_bf16_launches(M: int, K: int, H: int, N: int) -> list:
    """The bf16 backward's product launches that may split their reduction
    (csrc ``mlp_bwd_bf16.cu``), as :func:`bwd_launches` gives the f32 ones:
    z2 (which runs only with ``post``), dx, dw1 and dw2.  db1 and db2 are
    summed apart from the f32 dz1 (in the da1 launch's epilogue, which does
    not split) and g, so the dW launches carry no bias row."""
    return _split_launches((("z2", M, N, H), ("dx", M, K, H), ("dw1", K, H, M),
                            ("dw2", H, N, M)))


# csrc/mlp_bwd_bf16.cu kColRows: the rows of one partial column sum (db1, db2)
BF16_COLSUM_ROWS = 128


def bwd_bf16_workspace_doubles(M: int, K: int, H: int, N: int) -> int:
    """Doubles of workspace the bf16 backward needs (csrc
    ``gan_mlp_bwd_bf16_workspace_doubles``): its split launches keep their
    partial sums in f64, the largest chunks x outputs; db1's column sums one
    partial row of H per 64-row tile, db2's one of N per
    :data:`BF16_COLSUM_ROWS` rows."""
    if min(M, K, H, N) < 1:
        return 0
    return max(_split_workspace(bwd_bf16_launches(M, K, H, N)), -(-M // _TILE) * H,
               -(-M // BF16_COLSUM_ROWS) * N)


def fwd_split(M: int, H: int) -> Tuple[int, int]:
    """``(S, chunk)``: how the forward kernel splits d_ff over blocks at
    ``M`` rows (csrc ``fwd_split``).  Into at least the chunks a block's
    ``a1`` tile allows (:data:`FWD_CHUNK_TILES` 64-column tiles each); where
    that leaves at most half of :data:`WAVE_BLOCKS` blocks, into ``s =
    min(WAVE_BLOCKS // row tiles, tiles of d_ff)`` chunks instead.  A
    chunk takes ``ceil(tiles / s)`` 64-column tiles, the last possibly
    shorter (rounding may leave fewer than ``s``)."""
    rows = -(-M // _TILE)
    tiles = -(-H // _TILE)
    s = -(-tiles // FWD_CHUNK_TILES)
    if 2 * rows * s <= WAVE_BLOCKS:
        s = max(s, min(WAVE_BLOCKS // rows, tiles))
    per = -(-tiles // s)
    return -(-tiles // per), per * _TILE


def _bf16_split(name: str, symbol: str, M: int, K: int, H: int) -> Tuple[int, int]:
    split = (ctypes.c_int * 2)()
    fn = _build.function(name, symbol, [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _build.check(fn(M, K, H, ctypes.addressof(split)), name)
    return split[0], split[1]


def fwd_bf16_split(M: int, K: int, H: int) -> Tuple[int, int]:
    """``(S, chunk)``: the d_ff chunks the bf16 forward launches for ``M``
    rows of ``K -> H`` on the current CUDA device (csrc
    ``gan_mlp_fwd_bf16_split``, which reads the device's SMs and shared
    memory): whole waves of the blocks its shared memory lets an SM hold."""
    return _bf16_split("mlp_fwd_bf16", "gan_mlp_fwd_bf16_split", M, K, H)


def z1_bf16_split(M: int, K: int, H: int) -> Tuple[int, int]:
    """``(S, chunk)`` of the bf16 backward's z1 recompute on the current
    CUDA device (csrc ``gan_mlp_bwd_bf16_z1_split``)."""
    return _bf16_split("mlp_bwd_bf16", "gan_mlp_bwd_bf16_z1_split", M, K, H)


def fwd_bf16_launch(M: int, K: int, H: int, N: int) -> dict:
    """The bf16 forward's main launch on the current CUDA device, as
    :func:`fwd_launch` gives the f32 one."""
    S, chunk = fwd_bf16_split(M, K, H)
    rows = -(-M // _TILE)
    return {"row_tiles": rows, "chunks": S, "chunk": chunk, "blocks": rows * S,
            "reduce": S > 1}


def fwd_bf16_workspace_floats(M: int, K: int, H: int, N: int) -> int:
    """Floats of workspace the bf16 forward needs on the current CUDA device
    (csrc ``gan_mlp_fwd_bf16_workspace_floats``): ``S * M * N`` where d_ff
    splits into ``S > 1`` chunks (:func:`fwd_bf16_split`), else 0."""
    fn = _build.function("mlp_fwd_bf16", "gan_mlp_fwd_bf16_workspace_floats",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    n = fn(M, K, H, N)
    if n < 0:
        raise RuntimeError("mlp_fwd_bf16: the current CUDA device's attributes could not be read")
    return n


def fwd_launch(M: int, K: int, H: int, N: int) -> dict:
    """The forward's main launch: row tiles, d_ff chunks ``S`` and their
    columns, blocks, and whether a second kernel sums the partials."""
    S, chunk = fwd_split(M, H)
    rows = -(-M // _TILE)
    return {"row_tiles": rows, "chunks": S, "chunk": chunk, "blocks": rows * S,
            "reduce": S > 1}


def fwd_workspace_floats(M: int, K: int, H: int, N: int) -> int:
    """Floats of workspace the forward kernel needs (csrc
    ``gan_mlp_fwd_workspace_floats``): ``S * M * N`` where d_ff splits into
    ``S > 1`` chunks, else 0."""
    if min(M, K, H, N) < 1:
        return 0
    S, _ = fwd_split(M, H)
    return S * M * N if S > 1 else 0


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
              dropout_seed: Seed = 0):
    """The same function in plain PyTorch: the CPU path, and the reference
    the kernel is held against on the card.  The chains run in f32; at bf16
    the products' operands t1 and a1 and the output are rounded to bf16,
    where the JAX kernel rounds them, and the products' sums are exact,
    rounded to f32 (the module's docstring).  Differentiable."""
    (a_pre, a_mid, order, a_post), (r_pre, r_mid, r_post) = _parse_chain(pre, mid, post)
    K, H, N = w1.shape[0], w1.shape[1], w2.shape[1]
    lead = x.shape[:-1]
    dtype = x.dtype
    t = x.reshape(-1, K).float()
    M = t.shape[0]

    def mask(stream, cols, rate):
        return keep_scale(dropout_seed, stream, (M, cols), rate, x.device)

    def product(a, w):  # bf16: the operand rounded, the sum exact, then f32
        return torch.matmul(a, w) if dtype == torch.float32 else exact_matmul(a.to(dtype), w)

    t = _act(a_pre, t)
    if a_pre is not None and r_pre > 0.0:
        t = t * mask(STREAM_PRE, K, r_pre)
    z = product(t, w1) + b1.float()
    if r_mid > 0.0:
        m = mask(STREAM_MID, H, r_mid)
        h = _act(a_mid, z * m) if order == "drop_first" else _act(a_mid, z) * m
    else:
        h = _act(a_mid, z)
    z = product(h, w2) + b2.float()
    if a_post is not None and r_post > 0.0:
        z = z * mask(STREAM_POST, N, r_post)
    return _act(a_post, z).to(dtype).reshape(*lead, N)


def mlp_backward_plain(x, w1, b1, w2, b2, dout, pre=None, mid=("relu", "act_first", 0.0),
                       post=None, dropout_seed: Seed = 0):
    """(dx, dw1, db1, dw2, db2): autograd of :func:`mlp_plain` at float32;
    at bf16 the JAX kernel's chain, rounded where it rounds
    (:func:`_mlp_backward_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _mlp_backward_bf16(x, w1, b1, w2, b2, dout, pre, mid, post, dropout_seed)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        out = mlp_plain(*leaves, pre, mid, post, dropout_seed)
        return torch.autograd.grad(out, leaves, dout)


def _act_grad(name: Optional[str], z: torch.Tensor) -> torch.Tensor:
    """d act(z) / dz in f32, as ``gan_ffn_tpu/ops/mlp.py::_act_grad``: the
    exact gelu's Phi(z) + z phi(z)."""
    if name == "relu":
        return (z > 0.0).float()
    return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) + z * (
        torch.exp(-0.5 * z * z) * 0.3989422804014327)


def _mlp_backward_bf16(x, w1, b1, w2, b2, dout, pre, mid, post, seed):
    """The bf16 backward of ``gan_ffn_tpu/ops/mlp.py::_bwd_kernel`` with
    every product's sum exact, rounded to f32 once (``exact_matmul``): the
    forward chain recomputed as :func:`mlp_plain` computes it; g (= dz2)
    and dz1 in f32, rounded to bf16 as the products' operands; db1, db2
    exact sums of the f32 dz1, g; dx rounded to bf16, and dW, db cast to
    the weights' dtype."""
    (a_pre, a_mid, order, a_post), (r_pre, r_mid, r_post) = _parse_chain(pre, mid, post)
    K, H, N = w1.shape[0], w1.shape[1], w2.shape[1]
    dtype = x.dtype
    xf = x.reshape(-1, K).float()
    M = xf.shape[0]

    def mask(stream, cols, rate, on):
        return keep_scale(seed, stream, (M, cols), rate, x.device) if on else None

    m_pre = mask(STREAM_PRE, K, r_pre, a_pre is not None and r_pre > 0.0)
    m_mid = mask(STREAM_MID, H, r_mid, r_mid > 0.0)
    m_post = mask(STREAM_POST, N, r_post, a_post is not None and r_post > 0.0)
    t1 = _act(a_pre, xf)
    if m_pre is not None:
        t1 = t1 * m_pre
    t1 = t1.to(dtype)
    z1 = exact_matmul(t1, w1) + b1.float()
    if order == "drop_first":
        zd1 = z1 if m_mid is None else z1 * m_mid
        a1 = _act(a_mid, zd1)
    else:
        a1 = _act(a_mid, z1)
        if m_mid is not None:
            a1 = a1 * m_mid
    a1 = a1.to(dtype)
    g = dout.reshape(M, N).float()
    if a_post is not None:
        z2 = exact_matmul(a1, w2) + b2.float()
        g = g * _act_grad(a_post, z2 if m_post is None else z2 * m_post)
        if m_post is not None:
            g = g * m_post
    gd = g.to(dtype)
    dw2 = exact_matmul(a1.t(), gd)
    db2 = g.double().sum(dim=0).float()
    da1 = exact_matmul(gd, w2.t())
    if order == "drop_first":
        dz1 = da1 * _act_grad(a_mid, zd1)
        if m_mid is not None:
            dz1 = dz1 * m_mid
    else:
        if m_mid is not None:
            da1 = da1 * m_mid
        dz1 = da1 * _act_grad(a_mid, z1)
    dz1d = dz1.to(dtype)
    dw1 = exact_matmul(t1.t(), dz1d)
    db1 = dz1.double().sum(dim=0).float()
    dt1 = exact_matmul(dz1d, w1.t())
    if a_pre is not None:
        if m_pre is not None:
            dt1 = dt1 * m_pre
        dt1 = dt1 * _act_grad(a_pre, xf)
    return (dt1.to(dtype).reshape(x.shape), dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(b2.dtype))


def _drop_on(pre, mid, post):
    """Which of the sites (pre, mid, post) draw a mask."""
    (a_pre, _, _, a_post), rates = _parse_chain(pre, mid, post)
    return (int(a_pre is not None and rates[0] > 0.0), int(rates[1] > 0.0),
            int(a_post is not None and rates[2] > 0.0))


def _chain_args(pre, mid, post, seed, device):
    """The C entries' chain arguments and what they point into: the host
    arrays, and the seed on ``device`` where a site draws."""
    (a_pre, a_mid, order, a_post), rates = _parse_chain(pre, mid, post)
    on = _drop_on(pre, mid, post)
    ts = [threshold_and_scale(r) if o else (0, 1.0) for r, o in zip(rates, on)]
    arrays = ((ctypes.c_uint32 * 3)(*(t for t, _ in ts)),
              (ctypes.c_float * 3)(*(s for _, s in ts)),
              (ctypes.c_int * 3)(*on))
    ref = device_seed(seed, device) if any(on) else None
    args = (ACTS[a_pre], ACTS[a_mid], ACTS[a_post], int(order == "act_first"),
            None if ref is None else ref.base.data_ptr(), 0 if ref is None else ref.index,
            *(ctypes.addressof(a) for a in arrays))
    return args, (arrays, ref)


def mlp_fwd_bf16(x2, w1, b1, w2, b2, chain, seed) -> torch.Tensor:
    """Launch ``csrc/mlp_fwd_bf16.cu`` on bf16 CUDA operands that
    :func:`fused_mlp` has checked (``x2 (M, K)``, ``chain`` its ``(pre, mid,
    post)``, ``seed`` a host int or a :class:`~.dropout.SeedRef`); returns
    the bf16 ``(M, N)`` output.  Counts its launches."""
    M, K = x2.shape
    H, N = w2.shape
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    fn = _build.function("mlp_fwd_bf16", "gan_mlp_fwd_bf16", _FWD_BF16_ARGTYPES)
    args, _keep = _chain_args(*chain, seed, x2.device)
    with torch.cuda.device(x2.device):
        ws = torch.empty(fwd_bf16_workspace_floats(M, K, H, N), dtype=torch.float32,
                         device=x2.device)
        code = fn(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), ws.data_ptr(), M, K, H, N, *args,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _build.check(code, "mlp_fwd_bf16")
    _build.count_launch(mlp_fwd_bf16)
    return out


mlp_fwd_bf16.launches = 0  # bf16 forward kernel launches since the caller last reset it


def _launch_fwd(x2, w1, b1, w2, b2, chain, seed) -> torch.Tensor:
    M, K = x2.shape
    H, N = w2.shape
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    workspace = _build.function("mlp_fwd", "gan_mlp_fwd_workspace_floats", [ctypes.c_int] * 4,
                                ctypes.c_longlong)
    ws = torch.empty(workspace(M, K, H, N), dtype=torch.float32, device=x2.device)
    t1 = torch.empty((M, K) if chain[0] is not None else 0, dtype=torch.float32, device=x2.device)
    fn = _build.function("mlp_fwd", "gan_mlp_fwd", _FWD_ARGTYPES)
    args, _keep = _chain_args(*chain, seed, x2.device)
    with torch.cuda.device(x2.device):
        code = fn(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), t1.data_ptr(), ws.data_ptr(), M, K, H, N, *args,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    _build.check(code, "mlp_fwd")
    _build.count_launch(fused_mlp)
    return out


class _FusedMLP(torch.autograd.Function):
    """Forward and backward by device and dtype: on CUDA the kernels
    (mlp_fwd.cu and mlp_bwd.cu at f32, their bf16 twins at bf16), on the
    CPU the plain versions (the bf16 route: autograd of the plain forward
    would round where JAX does not).  Saves the inputs only."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, chain, seed):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        ctx.chain, ctx.seed = chain, seed
        if x2.device.type == "cpu":
            return mlp_plain(x2, w1, b1, w2, b2, *chain, dropout_seed=seed)
        if x2.dtype == torch.bfloat16:
            return mlp_fwd_bf16(x2, w1, b1, w2, b2, chain, seed)
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
    dropout_seed: Optional[Seed] = None,
) -> torch.Tensor:
    """Fused MLP over ``(..., K)`` inputs; returns ``(..., N)``.

    ``w1 (K, H)``, ``b1 (H,)``, ``w2 (H, N)``, ``b2 (N,)``.  ``dropout_seed``
    (a host int or a :class:`~.dropout.SeedRef`, default 0) draws every mask
    of the call.  On CUDA tensors
    the kernels take float32 or bfloat16, contiguous operands of one dtype
    in a geometry that :func:`fused_mlp_supported` accepts, and raise on
    anything else.  Differentiable in every tensor argument at both dtypes.
    """
    _parse_chain(pre, mid, post)
    K, H, N = _check_geometry(x, w1, b1, w2, b2)
    seed = 0 if dropout_seed is None else dropout_seed
    lead = x.shape[:-1]
    M = x.numel() // K
    if x.device.type == "cpu":
        if x.dtype == torch.float32:
            return mlp_plain(x, w1, b1, w2, b2, pre, mid, post, seed)
        out = _FusedMLP.apply(x.reshape(M, K), w1, b1, w2, b2, (pre, mid, post), seed)
        return out.reshape(*lead, N)
    _check_cuda_operands("fused_mlp", (x, w1, b1, w2, b2), x.device, KERNEL_DTYPES)
    if not fused_mlp_supported(K, H, N, max(M, 1)):
        raise ValueError(
            f"fused_mlp kernels do not take M={M} K={K} H={H} N={N} (flat indices < 2**31 "
            f"and at most {GRID_Y_LIMIT * _TILE} rows)"
        )
    if any(_drop_on(pre, mid, post)):
        seed = device_seed(seed, x.device)  # once, so that the backward reads the same
    out = _FusedMLP.apply(x.reshape(M, K), w1, b1, w2, b2, (pre, mid, post), seed)
    return out.reshape(*lead, N)


fused_mlp.launches = 0  # forward kernel launches since the caller last reset it


def fused_mlp_backward(x, w1, b1, w2, b2, dout, pre=None, mid=("relu", "act_first", 0.0),
                       post=None, dropout_seed: Seed = 0):
    """(dx, dw1, db1, dw2, db2) of :func:`fused_mlp` over ``(M, K)`` inputs
    for the upstream gradient ``dout (M, N)``, with the forward's chain and
    seed.  CPU tensors: :func:`mlp_backward_plain`; CUDA tensors:
    ``mlp_bwd.cu`` at f32, ``mlp_bwd_bf16.cu`` at bf16 (:func:`mlp_bwd_bf16`),
    each with its launches, scratch buffers and workspace, one call."""
    K, H, N = _check_geometry(x, w1, b1, w2, b2)
    if x.dim() != 2 or dout.shape != (x.shape[0], N):
        raise ValueError(f"fused_mlp_backward takes x (M, K) and dout (M, N), got "
                         f"{tuple(x.shape)} and {tuple(dout.shape)}")
    if x.device.type == "cpu":
        return mlp_backward_plain(x, w1, b1, w2, b2, dout, pre, mid, post, dropout_seed)
    dout = dout.contiguous()
    _check_cuda_operands("fused_mlp_backward", (x, w1, b1, w2, b2, dout), x.device,
                         KERNEL_DTYPES)
    M = x.shape[0]
    if not fused_mlp_supported(K, H, N, max(M, 1)):
        raise ValueError(f"fused_mlp_backward kernel does not take M={M} K={K} H={H} N={N}")
    if x.dtype == torch.bfloat16:
        return mlp_bwd_bf16(x, w1, b1, w2, b2, dout, (pre, mid, post), dropout_seed)
    dx = torch.empty_like(x)
    dw1, db1, dw2, db2 = (torch.empty_like(t) for t in (w1, b1, w2, b2))
    if M == 0:
        for t in (dw1, db1, dw2, db2):
            t.zero_()
        return dx, dw1, db1, dw2, db2
    args, _keep = _chain_args(pre, mid, post, dropout_seed, x.device)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)  # noqa: E731
    t1 = empty(M, K) if pre is not None else empty(0)
    a1, d1 = empty(M, H), empty(M, H)
    g = empty(M, N) if post is not None else empty(0)
    workspace = _build.function("mlp_bwd", "gan_mlp_bwd_workspace_floats", [ctypes.c_int] * 4,
                                ctypes.c_longlong)
    ws = empty(workspace(M, K, H, N))
    fn = _build.function("mlp_bwd", "gan_mlp_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), t1.data_ptr(), a1.data_ptr(), d1.data_ptr(), g.data_ptr(),
            ws.data_ptr(), M, K, H, N, *args, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "mlp_bwd")
    _build.count_launch(fused_mlp_backward)
    return dx, dw1, db1, dw2, db2


fused_mlp_backward.launches = 0  # backward kernel calls since the caller last reset it


def mlp_bwd_bf16(x, w1, b1, w2, b2, dout, chain, seed):
    """Launch ``csrc/mlp_bwd_bf16.cu`` on bf16 CUDA operands that
    :func:`fused_mlp_backward` has checked (``x (M, K)``, ``dout (M, N)``,
    ``chain`` the forward's ``(pre, mid, post)``, ``seed`` its seed);
    returns the bf16 (dx, dw1, db1, dw2, db2).  Allocates the scratch: t1
    (with pre), a1, act' of z1 (an f32 buffer, which holds bf16 for relu),
    the bf16 dz1, g (f32) and its bf16 copy (with post), and the f64
    workspace of the split launches and column sums.  Counts its
    launches."""
    M, K = x.shape
    H, N = w2.shape
    dx = torch.empty_like(x)
    dw1, db1, dw2, db2 = (torch.empty_like(t) for t in (w1, b1, w2, b2))
    if M == 0:
        for t in (dw1, db1, dw2, db2):
            t.zero_()
        return dx, dw1, db1, dw2, db2
    pre, _, post = chain
    dev = x.device

    def empty(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    t1 = empty(x.dtype, M, K) if pre is not None else empty(x.dtype, 0)
    a1, dz1, dz1b = empty(x.dtype, M, H), empty(torch.float32, M, H), empty(x.dtype, M, H)
    g = empty(torch.float32, M, N) if post is not None else empty(torch.float32, 0)
    gd = empty(x.dtype, M, N) if post is not None else empty(x.dtype, 0)
    workspace = _build.function("mlp_bwd_bf16", "gan_mlp_bwd_bf16_workspace_doubles",
                                [ctypes.c_int] * 4, ctypes.c_longlong)
    ws = empty(torch.float64, workspace(M, K, H, N))
    fn = _build.function("mlp_bwd_bf16", "gan_mlp_bwd_bf16", _BWD_BF16_ARGTYPES)
    args, _keep = _chain_args(*chain, seed, dev)
    with torch.cuda.device(dev):
        code = fn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), t1.data_ptr(), a1.data_ptr(), dz1.data_ptr(), dz1b.data_ptr(),
            g.data_ptr(), gd.data_ptr(), ws.data_ptr(), M, K, H, N, *args,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(code, "mlp_bwd_bf16")
    _build.count_launch(mlp_bwd_bf16)
    return dx, dw1, db1, dw2, db2


mlp_bwd_bf16.launches = 0  # bf16 backward kernel calls since the caller last reset it
