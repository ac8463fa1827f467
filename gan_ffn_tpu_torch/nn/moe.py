"""A DeepSeek-V3 mixture-of-experts layer (``DeepseekV3MoE`` with the
``noaux_tc`` router at one group), as Moonlight-16B-A3B runs it: routed
SwiGLU experts chosen by a sigmoid router, and shared experts that every
row takes.

Routing, for each row the layer is asked to route (``route_mask``):

- ``s = sigmoid(h Wr^T)`` over the ``E`` experts;
- the top ``k`` of ``s + b``, ``b`` the ``e_score_correction_bias``, which
  only chooses: the weights are the chosen ``s``, normalised to sum 1 and
  scaled by ``routed_scaling_factor``;
- dropless: every chosen (row, expert) pair is computed, with no capacity.

A row outside the mask (a padded utterance or dialogue) takes no routed
expert and counts in no statistic.  The pairs are sorted by expert on the
device (a stable sort, counts by ``scatter_add``, offsets by ``cumsum``),
gathered, run through ``ops.moe.grouped_swiglu`` (the routing weight
applied inside), and summed back per row by a gather of the inverse
permutation (:class:`_Dispatch`, :class:`_Combine`: no atomics, and padded
rows masked by ``where``).  Nothing reaches the host, so a CUDA graph
records the layer whatever the routing.  The shared experts run as one
SwiGLU of ``n_shared * width`` on every row, through the same op as one
group.

Balance (DeepSeek-V3 report, arXiv:2412.19437, §2.1.2; Moonlight's config
holds neither value): in a forward that takes gradients the layer keeps
the sequence-wise balance loss ``alpha * sum_i f_i P_i`` of each dialogue
over its routed rows, averaged over the dialogues that have any
(:attr:`MoE.balance_loss`), and each expert's load (rows routed to it,
``last_load``) with the rows routed (``routed_rows``); :meth:`MoE.update_bias`
then moves ``b_i`` by ``-gamma * sign(load_i - mean load)`` on the device.

Where the port's tracing is on, the router, sort, gather and combine lie in
the region ``gan_ffn.moe.route``, the experts (routed and shared) in
``gan_ffn.moe.experts``; their backward passes in
``gan_ffn.moe.route_backward`` and ``gan_ffn.moe.experts_backward``,
marked by identity autograd functions (``utils/profiling.backward_begins``,
``backward_ends``).  Where :attr:`MoE.record_slots` is set, each forward
writes its chosen experts into slot ``calls % record_slots`` of a device
buffer per row count (:attr:`MoE.records`), for a caller that holds a
reference to the same choices.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe import grouped_swiglu
from ..utils import profiling
from .core import uniform_parameter

ROUTE, EXPERTS = "gan_ffn.moe.route", "gan_ffn.moe.experts"
ROUTE_BACKWARD, EXPERTS_BACKWARD = "gan_ffn.moe.route_backward", "gan_ffn.moe.experts_backward"


def expert_parameter(shape, bound: float, generator: Optional[torch.Generator],
                     device) -> nn.Parameter:
    """U(-bound, bound): from ``generator`` on the CPU as ``nn.core`` draws,
    or, without one, on ``device`` itself (an expert stack is hundreds of
    millions of values)."""
    if generator is not None:
        return uniform_parameter(shape, bound, generator, device)
    return nn.Parameter(torch.empty(tuple(shape), device=device).uniform_(-bound, bound))


class Experts(nn.Module):
    """``n`` SwiGLU experts, ``w_gate``, ``w_up (n, width, hidden)`` and
    ``w_down (n, hidden, width)`` in torch's Linear layout and init."""

    def __init__(self, n: int, hidden: int, width: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        up, down = 1.0 / math.sqrt(hidden), 1.0 / math.sqrt(width)
        self.w_gate = expert_parameter((n, width, hidden), up, generator, device)
        self.w_up = expert_parameter((n, width, hidden), up, generator, device)
        self.w_down = expert_parameter((n, hidden, width), down, generator, device)

    def forward(self, x: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None):
        return grouped_swiglu(x, self.w_gate, self.w_up, self.w_down, offsets, weights)


class Router(nn.Module):
    """The gate: ``weight (E, hidden)`` (torch's Linear init) and the
    correction bias ``(E,)``, a parameter that takes no gradient (V3 keeps
    it so), starting at 0."""

    def __init__(self, hidden: int, n_experts: int, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.weight = uniform_parameter((n_experts, hidden), 1.0 / math.sqrt(hidden), generator,
                                        device)
        self.e_score_correction_bias = nn.Parameter(torch.zeros(n_experts, device=device),
                                                    requires_grad=False)


class _Dispatch(torch.autograd.Function):
    """``x[src]``: the rows in expert order; the backward sums each row's
    pairs by the inverse permutation, rows outside ``valid`` taking 0."""

    @staticmethod
    def forward(ctx, x, src, inv, valid):
        ctx.save_for_backward(inv, valid)
        return x.index_select(0, src)

    @staticmethod
    def backward(ctx, dxs):
        inv, valid = ctx.saved_tensors
        return _pair_sum(dxs, inv, valid), None, None, None


class _Combine(torch.autograd.Function):
    """Each row's sum of its pairs' outputs (``ys`` in expert order, read
    through the inverse permutation ``inv (N, k)``); 0 outside ``valid``."""

    @staticmethod
    def forward(ctx, ys, src, inv, valid):
        ctx.save_for_backward(src)
        return _pair_sum(ys, inv, valid)

    @staticmethod
    def backward(ctx, dout):
        (src,) = ctx.saved_tensors
        return dout.index_select(0, src), None, None, None


def sort_pairs(idx: torch.Tensor, valid: torch.Tensor, E: int):
    """The (row, choice) pairs of ``idx (N, k)`` sorted by expert, rows
    outside ``valid`` after every expert's: ``order`` (pair index at each
    sorted position), ``counts (E + 1)`` (the last: the unrouted pairs),
    ``offsets (E + 1)`` int32, ``inv (N, k)`` (each pair's sorted position)
    and ``src`` (each sorted position's row).  All on the device."""
    N, k = idx.shape
    pair_expert = idx.masked_fill(~valid[:, None], E).reshape(-1)
    order = torch.sort(pair_expert, stable=True).indices
    counts = torch.zeros(E + 1, dtype=torch.int32, device=idx.device).scatter_add_(
        0, pair_expert, torch.ones_like(pair_expert, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros(1), counts[:E].cumsum(0)]).to(torch.int32)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(N * k, device=idx.device))
    return order, counts, offsets, inv.view(N, k), torch.div(order, k, rounding_mode="floor")


def _pair_sum(ys: torch.Tensor, inv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    pairs = ys.index_select(0, inv.reshape(-1)).view(*inv.shape, ys.shape[-1])
    return torch.where(valid[:, None, None], pairs, 0.0).sum(1)


class MoE(nn.Module):
    def __init__(self, hidden: int, n_experts: int, top_k: int, width: int, n_shared: int,
                 scaling: float, alpha: float, gamma: float, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.n_experts, self.top_k, self.scaling = n_experts, top_k, scaling
        self.alpha, self.gamma = alpha, gamma
        kw = dict(generator=generator, device=device)
        self.gate = Router(hidden, n_experts, **kw)
        self.experts = Experts(n_experts, hidden, width, **kw)
        self.shared_experts = Experts(1, hidden, width * n_shared, **kw)
        self.register_buffer("last_load", torch.zeros(n_experts, device=device), persistent=False)
        self.register_buffer("routed_rows", torch.zeros((), device=device), persistent=False)
        self.balance_loss: Optional[torch.Tensor] = None
        self.record_slots = 0
        self.records: Dict[int, torch.Tensor] = {}  # rows -> (slots, rows, k) chosen experts
        self.calls = 0

    @torch.no_grad()
    def update_bias(self) -> None:
        """b -= gamma * sign(load - mean load), from the last forward that took gradients."""
        load = self.last_load
        self.gate.e_score_correction_bias.sub_(self.gamma * torch.sign(load - load.mean()))

    def forward(self, x: torch.Tensor, route_mask: torch.Tensor) -> torch.Tensor:
        """``x (L, B, hidden)``, ``route_mask (L, B)`` bool: the rows routed."""
        L, B, H = x.shape
        N, E, k = L * B, self.n_experts, self.top_k
        flat = x.reshape(N, H)
        valid = route_mask.reshape(N)
        stats = torch.is_grad_enabled()
        self.balance_loss = None
        with profiling.region(ROUTE, x.device):
            routed = profiling.backward_ends(flat, ROUTE_BACKWARD)
            scores = torch.sigmoid(F.linear(routed, self.gate.weight))
            with torch.no_grad():
                idx = (scores + self.gate.e_score_correction_bias).topk(k, dim=-1).indices
            w = scores.gather(1, idx)
            w = w / (w.sum(-1, keepdim=True) + 1e-20) * self.scaling
            self._record(idx)
            order, counts, offsets, inv, src = sort_pairs(idx, valid, E)
            xs = profiling.backward_begins(_Dispatch.apply(routed, src, inv, valid),
                                           ROUTE_BACKWARD)
            ws = w.reshape(-1).index_select(0, order)
            if stats:
                self._statistics(idx, scores, valid, counts[:E], L, B)
        with profiling.region(EXPERTS, x.device):
            xs = profiling.backward_ends(xs, EXPERTS_BACKWARD)
            ys = self.experts(xs, offsets, ws)
            ys = profiling.backward_begins(ys, EXPERTS_BACKWARD)
            shared = self.shared_experts(flat)
        with profiling.region(ROUTE, x.device):
            ys = profiling.backward_ends(ys, ROUTE_BACKWARD)
            out = profiling.backward_begins(_Combine.apply(ys, src, inv, valid), ROUTE_BACKWARD)
        return (out + shared).view(L, B, H)

    def _record(self, idx: torch.Tensor) -> None:
        if self.record_slots <= 0:
            return
        buf = self.records.get(idx.shape[0])
        if buf is None:
            buf = self.records[idx.shape[0]] = idx.new_zeros(self.record_slots, *idx.shape)
        buf[self.calls % self.record_slots].copy_(idx)
        self.calls += 1

    def _statistics(self, idx, scores, valid, counts, L: int, B: int) -> None:
        """The balance loss, the loads and the rows routed of this forward."""
        E, k = self.n_experts, self.top_k
        with torch.no_grad():
            self.last_load.copy_(counts)
            self.routed_rows.copy_(valid.sum())
        m = valid.view(L, B).float()
        rows = m.sum(0).clamp(min=1.0)  # each dialogue's routed rows
        chosen = torch.zeros(B, E, device=idx.device).scatter_add_(
            1, idx.view(L, B, k).permute(1, 0, 2).reshape(B, L * k),
            m[:, :, None].expand(L, B, k).permute(1, 0, 2).reshape(B, L * k))
        f = chosen * (E / k) / rows[:, None]
        p = ((scores / scores.sum(-1, keepdim=True)).view(L, B, E) * m[:, :, None]).sum(0)
        p = p / rows[:, None]
        real = (m.sum(0) > 0).float()
        self.balance_loss = self.alpha * ((f * p).sum(1) * real).sum() / real.sum().clamp(min=1.0)
