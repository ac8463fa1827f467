"""Plain PyTorch reference of stage A's 12-duel step with Moonlight-16B-A3B's
decoder stack as the text generator (https://huggingface.co/moonshotai/
Moonlight-16B-A3B, ``model_type: deepseek_v3``), written from DeepSeek-V3's
equations; the other five networks are ``reference/gan_ffn.py``'s.

The text generator, on ``(L, B, 100)`` text features, its leaves under the
port's names (``models/moonlight.py``): ``input_proj`` (bias-free) to the
hidden size; per layer ``h += attn(rms(h)); h += ffn(rms(h))``; the final
RMSNorm; the GAN-FFN generator head (``common.gelu_head``, one Philox call).

- RMSNorm: ``w * x / sqrt(mean(x^2) + eps)``.
- Attention (MLA, no query LoRA): ``q = h Wq^T`` split per head into
  ``q_nope`` and ``q_pe``; ``[c, k_pe] = h Wkva^T`` (``k_pe`` one head
  shared by all); ``[k_nope, v] = rms(c) Wkvb^T``; RoPE (theta, positions
  0..L-1) on ``q_pe`` and ``k_pe``, their columns first de-interleaved
  (evens, then odds) as the V3 code does, then rotated by half; softmax
  of ``[q_nope, q_pe] . [k_nope, k_pe]`` at ``(qk_nope + qk_rope)^-1/2``,
  query t over keys ``<= t`` and ``< valid_len``; ``o_proj``.
- Layer 0 (``first_k_dense_replace``): ``(silu(x Wg^T) * x Wu^T) Wd^T``.
- MoE layers: ``s = sigmoid(x Wr^T)``; each routed row (``t < valid_len``,
  ``b < n_real``) takes the top ``k`` of ``s + b`` (the correction bias
  only chooses); weights the chosen ``s`` over their sum, times
  ``routed_scaling_factor``; each expert's SwiGLU over its rows in a Python
  loop, weighted; plus the shared experts on every row.  The sequence-wise
  balance loss ``alpha * sum_i f_i P_i`` per dialogue over its routed rows
  (``f_i = E / (k T) * #chosen``, ``P_i`` the mean of ``s_i / sum_j s_j``),
  averaged over the dialogues with routed rows, is added to the text
  generator's gen-duel loss; after its Adam step each layer's bias moves by
  ``-gamma * sign(load - mean load)`` from that duel's loads.

Ties: where the reference's ``k``-th and ``k+1``-th biased scores lie
within ``TIE_WIDTH`` of each other, the row takes the program's recorded
choice (``port_choices``); the rows where that choice differs from the
reference's own are counted (``tie_rows``), and so are the rows whose
choices differ with a wider gap (``choice_mismatch``).  ``TIE_WIDTH``
1e-3: the two sides' scores part by more than their f32 rounding once
Adam has stepped (at beta2 0.6 a weight whose gradient is near 0 moves by
about lr either way, and a rounding flips the way): over 12 seeds on the
H100 the widest gap of a row that took the program's choice was 1.5e-4,
none parted wider, and TF32 products part 28 to 818 rows wider (the
configuration's limits).

Every product runs through ``common.mm``, so ``common.tf32_products`` makes
the control.  Nothing here imports the port or JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from ..lib.philox import StepStream
from . import gan_ffn as ref
from .common import Adam, gelu_head, linear, mm

TEXT = "text_gen"
TIE_WIDTH = 1e-3
NEG_INF = -1e30


class Moonlight:
    """The stack's sizes (a configuration file's keys) and its state across
    steps: the MoE layers' correction biases, the program's recorded
    choices, and the tie counts."""

    def __init__(self, cfg: Mapping, device):
        self.cfg = cfg
        self.n_layers = int(cfg["num_hidden_layers"])
        self.dense = int(cfg["first_k_dense_replace"])
        self.E, self.k = int(cfg["n_routed_experts"]), int(cfg["num_experts_per_tok"])
        self.bias = {i: torch.zeros(self.E, device=device)
                     for i in range(self.dense, self.n_layers)}
        self.port_choices: Optional[Dict[int, torch.Tensor]] = None  # layer -> (passes, N, k)
        self.passes = 0  # text generator calls in this step
        self.tie_rows = self.choice_mismatch = 0
        self.tie_gap = 0.0  # the widest gap of a row that took the program's choice

    @property
    def alpha(self) -> float:
        return float(self.cfg.get("aux_loss_alpha", 1e-4))

    @property
    def gamma(self) -> float:
        return float(self.cfg.get("bias_update_speed", 1e-3))


def rms_norm(x, w, eps: float):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x, theta: float):
    """V3's rotary embedding over axis 0 (positions 0..L-1) of ``x (L, ..., d)``."""
    L, d = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.arange(L, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1).view((L,) + (1,) * (x.dim() - 2) + (d,))
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)  # the de-interleave
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * ang.cos() + rotated * ang.sin()


def mla(W, p: str, h, valid_len, cfg):
    L, B, _ = h.shape
    nh = int(cfg["num_attention_heads"])
    dn, dr, dv = (int(cfg[k]) for k in ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim"))
    rank, eps = int(cfg["kv_lora_rank"]), float(cfg["rms_norm_eps"])
    q = linear(h, W[p + "q_proj.weight"]).view(L, B, nh, dn + dr)
    kva = linear(h, W[p + "kv_a_proj_with_mqa.weight"])
    c, k_pe = kva[..., :rank], kva[..., rank:]
    kv = linear(rms_norm(c, W[p + "kv_a_layernorm.weight"], eps),
                W[p + "kv_b_proj.weight"]).view(L, B, nh, dn + dv)
    theta = float(cfg["rope_theta"])
    q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], dim=-1)
    k = torch.cat([kv[..., :dn], rope(k_pe.view(L, B, 1, dr), theta).expand(L, B, nh, dr)],
                  dim=-1)
    v = kv[..., dn:]
    q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(dn + dr)
    pos = torch.arange(L, device=h.device)
    hidden = (pos[None, :] > pos[:, None]) | (pos[None, :] >= valid_len)
    att = torch.softmax(scores.masked_fill(hidden, NEG_INF), dim=-1)
    out = mm(att, v).permute(2, 0, 1, 3).reshape(L, B, nh * dv)
    return linear(out, W[p + "o_proj.weight"])


def swiglu(x, wg, wu, wd):
    return linear(F.silu(linear(x, wg)) * linear(x, wu), wd)


def moe(W, p: str, x, route, layer: int, st: Moonlight, stats: bool):
    """The MoE layer on ``x (L, B, D)`` over the rows of ``route (L, B)``:
    (output, balance loss or None, each expert's load)."""
    L, B, D = x.shape
    N, E, k = L * B, st.E, st.k
    flat, valid = x.reshape(N, D), route.reshape(N)
    scores = torch.sigmoid(linear(flat, W[p + "gate.weight"]))
    with torch.no_grad():
        top = (scores + st.bias[layer]).topk(k + 1, dim=-1)
        idx = top.indices[:, :k]
        if st.port_choices is not None:
            theirs = st.port_choices[layer][st.passes].to(idx.device)
            tie = (top.values[:, k - 1] - top.values[:, k] < TIE_WIDTH) & valid
            differ = (idx.sort(-1).values != theirs.sort(-1).values).any(-1) & valid
            taken = differ & tie
            st.tie_rows += int(taken.sum())
            if bool(taken.any()):
                gap = (top.values[:, k - 1] - top.values[:, k])[taken].max()
                st.tie_gap = max(st.tie_gap, float(gap))
            st.choice_mismatch += int((differ & ~tie).sum())
            idx = torch.where(tie[:, None], theirs, idx)
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * float(st.cfg["routed_scaling_factor"])
    pieces, where = [], []
    for e in range(E):
        rows, slots = ((idx == e) & valid[:, None]).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(flat[rows], W[p + "experts.w_gate"][e], W[p + "experts.w_up"][e],
                   W[p + "experts.w_down"][e])
        pieces.append(y * w[rows, slots][:, None])
        where.append(rows * k + slots)
    pairs = flat.new_zeros(N * k, D)
    if pieces:
        pairs = pairs.index_put((torch.cat(where),), torch.cat(pieces))
    routed = pairs.view(N, k, D).sum(1)
    shared = swiglu(flat, W[p + "shared_experts.w_gate"][0], W[p + "shared_experts.w_up"][0],
                    W[p + "shared_experts.w_down"][0])
    load = torch.zeros(E, device=x.device).index_add_(
        0, idx[valid].reshape(-1), torch.ones(int(valid.sum()) * k, device=x.device))
    balance = None
    if stats:
        m = route.float()
        T = m.sum(0)
        chosen = torch.zeros(B, E, device=x.device)
        for j in range(k):
            chosen += F.one_hot(idx[:, j].view(L, B), E).float().mul(m[:, :, None]).sum(0)
        f = chosen * (E / k) / T.clamp(min=1.0)[:, None]
        share = (scores / scores.sum(-1, keepdim=True)).view(L, B, E) * m[:, :, None]
        P = share.sum(0) / T.clamp(min=1.0)[:, None]
        real = (T > 0).float()
        balance = st.alpha * ((f * P).sum(1) * real).sum() / real.sum().clamp(min=1.0)
    return (routed + shared).view(L, B, D), balance, load


def text_generator(W, x, valid_len: int, route, train: bool, cfg, st: Moonlight,
                   stream: StepStream):
    """(output, summed balance loss or None, the MoE layers' loads by layer)."""
    eps = float(cfg["rms_norm_eps"])
    h = linear(x, W["input_proj.weight"])
    balances, loads = [], {}
    stats = torch.is_grad_enabled()
    for i in range(st.n_layers):
        p = f"layers.{i}."
        h = h + mla(W, p + "self_attn.", rms_norm(h, W[p + "input_layernorm.weight"], eps),
                    valid_len, cfg)
        z = rms_norm(h, W[p + "post_attention_layernorm.weight"], eps)
        if i < st.dense:
            h = h + swiglu(z, W[p + "mlp.w_gate"][0], W[p + "mlp.w_up"][0], W[p + "mlp.w_down"][0])
        else:
            out, balance, loads[i] = moe(W, p + "mlp.", z, route, i, st, stats)
            h = h + out
            if balance is not None:
                balances.append(balance)
    st.passes += 1
    h = rms_norm(h, W["norm.weight"], eps)
    rate = cfg["dropout"] if train else 0.0
    out = gelu_head(h, W["fc1.weight"], W["fc1.bias"], W["fc2.weight"], W["fc2.bias"], rate,
                    stream.next() if train else None)
    return out, (torch.stack(balances).sum() if balances else None), loads


def _generate(params, net: str, mod: str, x, vl, train: bool, cfg, st, stream, route):
    if net == TEXT:
        return text_generator(params[net], x, vl, route, train, cfg, st, stream)
    return ref.generator(params[net], "", mod, x, vl, train, cfg, stream), None, {}


def stage_a_step(params: Mapping[str, Dict[str, torch.Tensor]], adams: Mapping[str, Adam],
                 batch: Mapping, cfg, st: Moonlight, fault: str = "") -> List[torch.Tensor]:
    """One 12-duel step (``reference/gan_ffn.stage_a_step``'s, with the
    Moonlight text generator, its balance loss and bias updates); returns
    the twelve losses.  ``fault="half_batch"`` averages the BCE over the
    first half of the dialogues (the routing keeps the whole duel mask)."""
    device = batch["text"].device
    stream, vl = StepStream(batch["seed"]), batch["valid_len"]
    mask = ref.duel_mask(batch, device)
    route = mask[:, :, 0] > 0
    if fault == "half_batch":
        mask = mask.clone()
        mask[:, mask.shape[1] // 2:] = 0.0
    st.passes = 0
    losses = []
    for kind, net, mod, opp, opp_mod in ref.SCHEDULE:
        W, O = params[net], params[opp]
        real = batch[ref.BATCH_KEY[mod]]
        loads = {}
        if kind == "disc":
            real_prob = ref.discriminator(W, "", real, vl, True, cfg, stream)
            with torch.no_grad():
                fake, _, _ = _generate(params, opp, opp_mod, batch[ref.BATCH_KEY[opp_mod]], vl,
                                       False, cfg, st, stream, route)
            fake_prob = ref.discriminator(W, "", fake, vl, True, cfg, stream)
            loss = (ref.bce(real_prob, 1.0, mask) + ref.bce(fake_prob, 0.0, mask)) / 2.0
        else:
            fused, balance, loads = _generate(params, net, mod, real, vl, True, cfg, st, stream,
                                              route)
            loss = ref.bce(ref.discriminator(O, "", fused, vl, False, cfg, stream), 1.0, mask)
            if balance is not None:
                loss = loss + balance
        names = list(W)
        grads = torch.autograd.grad(loss, [W[n] for n in names])
        adams[net].step(dict(zip(names, grads)))
        for layer, load in loads.items():
            st.bias[layer] -= st.gamma * torch.sign(load - load.mean())
        losses.append(loss.detach())
    return losses
