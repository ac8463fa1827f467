"""Plain PyTorch building blocks of the references: products, layers,
dropout, the positional table and Adam.  Nothing here imports the port.

Products run through :func:`mm`: float32 products (the harness switches TF32
off), or inside :func:`tf32_products` products whose operands, forward and
backward, are first rounded to TF32 (10 mantissa bits, to nearest), which is
what a TF32 tensor-core product reads: the control of the correctness check,
one step below the float32 that the configurations state.

Dropout comes from two sources, as in the program:

- the masks inside the port's kernels (attention weights, the FFN and the
  generator head) are Philox masks from ``lib/philox.py``, the k-th masked
  kernel call of a step drawing from ``derive_seed(base, k)``;
- every other dropout is torch's own (``F.dropout``), drawn from the device's
  generator.  The reference draws the same masks by calling ``F.dropout`` on a
  tensor of ones of the same shape, in the same order, from the generator state
  that the harness read before the program's step: torch's dropout kernel picks
  its launch and its Philox offsets from the element count and the alignment
  only, never from the values.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..lib import philox

_TF32 = contextvars.ContextVar("tf32_products", default=False)
NEG_INF = -1e30


@contextlib.contextmanager
def tf32_products():
    """Every :func:`mm` inside reads TF32 operands."""
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (to nearest), as a value outside autograd."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to TF32: the
    backward's products then read TF32 operands too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _TF32.get():
        return torch.matmul(a, b)
    a = a + (_tf32(a) - a).detach()
    b = b + (_tf32(b) - b).detach()
    return _RoundGrad.apply(torch.matmul(a, b))


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = mm(x, w.t())
    return y if b is None else y + b


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w, b, 1e-5)


def torch_dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    if not train or rate == 0.0:
        return x
    return x * F.dropout(torch.ones(x.shape, device=x.device), rate, True)


def positional_table(max_len: int, d: int, device) -> torch.Tensor:
    """Sinusoidal table (max_len, 1, d): sin on even, cos on odd columns."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-np.log(10000.0) / d))
    pe = np.zeros((max_len, 1, d), dtype=np.float32)
    pe[:, 0, 0::2] = np.sin(pos * div)
    pe[:, 0, 1::2] = np.cos(pos * div)[:, : d // 2]
    return torch.from_numpy(pe).to(device)


def attention(q, k, v, valid_len: int, rate: float, seed: Optional[int]) -> torch.Tensor:
    """Softmax attention over ``(B, H, L, Dh)``: keys ``>= valid_len``
    masked, the weights dropped by the Philox attention stream."""
    L, Dh = q.shape[-2], q.shape[-1]
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    keys = torch.arange(L, device=q.device) >= valid_len
    p = torch.softmax(scores.masked_fill(keys, NEG_INF), dim=-1)
    if rate > 0.0:
        p = p * philox.keep_scale(seed, philox.STREAM_ATTENTION, p.shape, rate, q.device)
    return mm(p, v)


def _mask(seed, stream, rows, cols, rate, device):
    return philox.keep_scale(seed, stream, (rows, cols), rate, device)


def ffn(x, w1, b1, w2, b2, rate: float, seed: Optional[int]) -> torch.Tensor:
    """``dropout(relu(x W1^T + b1)) W2^T + b2``, the encoder's FFN."""
    lead, K = x.shape[:-1], x.shape[-1]
    t = x.reshape(-1, K)
    h = torch.relu(linear(t, w1, b1))
    if rate > 0.0:
        h = h * _mask(seed, philox.STREAM_MID, t.shape[0], h.shape[1], rate, x.device)
    return linear(h, w2, b2).reshape(*lead, w2.shape[0])


def gelu_head(x, w1, b1, w2, b2, rate: float, seed: Optional[int]) -> torch.Tensor:
    """``gelu(drop(fc2(gelu(drop(fc1(drop(gelu(x))))))))``, the generators' head."""
    lead, K = x.shape[:-1], x.shape[-1]
    t = F.gelu(x.reshape(-1, K))
    M = t.shape[0]
    if rate > 0.0:
        t = t * _mask(seed, philox.STREAM_PRE, M, K, rate, x.device)
    z = linear(t, w1, b1)
    if rate > 0.0:
        z = z * _mask(seed, philox.STREAM_MID, M, z.shape[1], rate, x.device)
    z = linear(F.gelu(z), w2, b2)
    if rate > 0.0:
        z = z * _mask(seed, philox.STREAM_POST, M, z.shape[1], rate, x.device)
    return F.gelu(z).reshape(*lead, w2.shape[0])


class Adam:
    """torch's Adam with coupled L2 (the L2 term added to the gradient)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params, self.lr, self.betas = params, lr, betas
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k] + self.wd * p if self.wd else grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
