"""Moonlight-16B-A3B's decoder stack as stage A's text generator
(``GANConfig(text_generator="moonlight")``; ``--text-generator moonlight``).

Moonlight (https://huggingface.co/moonshotai/Moonlight-16B-A3B,
``model_type: deepseek_v3``) at its published widths, with the equations of
DeepSeek-V3's public modelling code: hidden 2048, pre-norm RMSNorm residuals
(eps 1e-5), multi-head latent attention (``nn/mla.py``: 16 heads, no query
LoRA, qk 128 + 64 rotary, v 128, KV latent 512, RoPE theta 50,000, causal),
layer 0 a dense SwiGLU of 11,264, the others mixtures of 64 routed SwiGLU
experts of 1,408 (top 6 by a sigmoid router with a correction bias,
normalised and scaled by 2.446) and 2 shared (``nn/moe.py``).  Depth is the
configuration's (:class:`MoonlightConfig`: 5 of the published 27 layers by
default, layer 0 and four MoE layers: one card holds one stage of a
layer-wise pipeline).

:class:`MoonlightGenerator` maps the 100-d text features ``(L, B, 100)`` to
``(L, B, D_h)``: a bias-free input projection in place of the token
embedding, the layers ``h += attn(norm(h)); h += ffn(norm(h))``, the final
RMSNorm, and the GAN-FFN text generator's own head, 2048 -> 512 -> D_h,
through ``ops.mlp.fused_mlp`` with its gelu chain and dropouts (the stack
itself has none, as published).  Attention runs over the dialogue's
utterances, positions 0..L-1, keys at or past ``valid_len`` masked.  Only
the rows of ``row_mask`` (stage A's duel mask; default ``t < valid_len``)
are routed.  After a forward that took gradients, :attr:`balance_loss`
holds the MoE layers' summed balance loss, and :meth:`after_step` (which
stage A calls after the generator's Adam step) updates their correction
biases and drops the gradients.  Float32 only.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
from torch import nn

from ..nn.core import Linear, RMSNorm, kernel_layout, kernel_seed
from ..nn.mla import LatentAttention
from ..nn.moe import MoE, Experts
from ..ops.dropout import StepSeeds
from ..ops.mlp import fused_mlp


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """Moonlight-16B-A3B's ``config.json`` keys that the stack reads, cut in
    depth only, and the generator's own: the input width, the head's hidden
    width, and the balance's ``alpha`` and ``gamma`` (DeepSeek-V3 report)."""

    hidden_size: int = 2048
    num_hidden_layers: int = 5
    first_k_dense_replace: int = 1
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    d_in: int = 100
    d_head_hidden: int = 512
    aux_loss_alpha: float = 1e-4
    bias_update_speed: float = 1e-3

    @classmethod
    def from_dict(cls, d: Mapping) -> "MoonlightConfig":
        """The fields that ``d`` (a configuration file) gives, the defaults for the rest."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def tiny(cls) -> "MoonlightConfig":
        """The CPU tests' size: hidden 64, 4 heads of qk 16 + 8 and v 16, a
        KV latent of 32, 8 experts of 32 (top 2, one shared), a dense layer
        of 96 and 2 MoE layers."""
        return cls(hidden_size=64, num_hidden_layers=3, intermediate_size=96,
                   moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
                   num_experts_per_tok=2, num_attention_heads=4, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, d_head_hidden=32)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MoonlightConfig, dense: bool, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        D, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(D, eps, device=device)
        self.self_attn = LatentAttention(D, cfg.num_attention_heads, cfg.qk_nope_head_dim,
                                         cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank,
                                         cfg.rope_theta, eps, **kw)
        self.post_attention_layernorm = RMSNorm(D, eps, device=device)
        if dense:
            self.mlp = Experts(1, D, cfg.intermediate_size, **kw)
        else:
            self.mlp = MoE(D, cfg.n_routed_experts, cfg.num_experts_per_tok,
                           cfg.moe_intermediate_size, cfg.n_shared_experts,
                           cfg.routed_scaling_factor, cfg.aux_loss_alpha, cfg.bias_update_speed,
                           **kw)

    def forward(self, h: torch.Tensor, valid_len, route_mask: torch.Tensor) -> torch.Tensor:
        h = h + self.self_attn(self.input_layernorm(h), valid_len)
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, MoE):
            return h + self.mlp(x, route_mask)
        L, B, D = x.shape
        return h + self.mlp(x.reshape(L * B, D)).view(L, B, D)


class MoonlightGenerator(nn.Module):
    """(L, B, d_in) -> (L, B, D_h); see the module docstring."""

    dropout_seeds: Optional[StepSeeds] = None  # the head's kernel seeds (nn.core)
    takes_row_mask = True  # stage A hands it the duel mask's rows

    def __init__(self, D_h: int = 100, dropout: float = 0.2,
                 cfg: MoonlightConfig = MoonlightConfig(), *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.cfg, self.dropout = cfg, dropout
        kw = dict(generator=generator, device=device)
        D = cfg.hidden_size
        self.input_proj = Linear(cfg.d_in, D, bias=False, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i < cfg.first_k_dense_replace, **kw)
            for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(D, cfg.rms_norm_eps, device=device)
        self.fc1 = Linear(D, cfg.d_head_hidden, **kw)
        self.fc2 = Linear(cfg.d_head_hidden, D_h, **kw)
        self.balance_loss: Optional[torch.Tensor] = None

    def moe_layers(self):
        return [layer.mlp for layer in self.layers if isinstance(layer.mlp, MoE)]

    def forward(self, x: torch.Tensor, valid_len=None,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        L, B = x.shape[:2]
        if valid_len is None:
            valid_len = L
        if row_mask is None:
            route = (torch.arange(L, device=x.device) < valid_len)[:, None].expand(L, B)
        else:
            route = row_mask.reshape(L, B) > 0
        h = self.input_proj(x)
        for layer in self.layers:
            h = layer(h, valid_len, route)
        h = self.norm(h)
        losses = [m.balance_loss for m in self.moe_layers() if m.balance_loss is not None]
        self.balance_loss = torch.stack(losses).sum() if losses else None
        rate = self.dropout if self.training else 0.0
        return fused_mlp(
            h, *kernel_layout(self.fc1), *kernel_layout(self.fc2),
            pre=("gelu", rate),
            mid=("gelu", "drop_first", rate),
            post=("gelu", "drop_first", rate),
            dropout_seed=kernel_seed(self) if rate > 0.0 else None,
        )

    def after_step(self) -> None:
        """After the generator's Adam step: the MoE layers' correction-bias
        updates from their last loads, and the gradients dropped (about 9.7
        GB at the published widths, which a graph's pool would otherwise
        hold from one replay to the next)."""
        for m in self.moe_layers():
            m.update_bias()
        for p in self.parameters():
            p.grad = None
