"""Plain PyTorch reference of the GAN-FFN networks and of stage A's 12-duel
step (Jing-yilin/GAN-FFN ``model.py``: the generators and discriminators;
``train_IEMOCAP.py:200-393``: train_disc, train_gen and the round robin).

The weights are a dict ``{name: tensor}`` under the names of torch's modules
(``nn.TransformerEncoderLayer``'s, with the generators and discriminators
under ``net.``); a network's leaves carry its prefix (``acoustic_gen.``).

- Generator: PE (dropout ``pe_dropout``) -> post-norm encoder of
  ``num_layers`` layers (self-attention and a relu FFN of ``d_ff``, dropout
  ``encoder_dropout`` on the attention weights, inside the FFN and on both
  residual branches) -> ``gelu(drop(fc2(gelu(drop(fc1(drop(gelu(x))))))))``
  at ``dropout``.
- Discriminator: PE -> encoder (``D_h`` wide, 10 heads) -> gelu ->
  ``sigmoid(drop(fc3(gelu(drop(fc2(gelu(drop(fc1(x)))))))))``; the visual one
  maps 512-wide raw features through ``object`` first.
- A disc duel trains the discriminator on real and detached fake fusions,
  ``(bce(real, 1) + bce(fake, 0)) / 2``; a gen duel trains the generator
  through the discriminator in eval mode, ``bce(disc(gen(x)), 1)``.  The BCE
  is averaged over ``t < valid_len`` and the batch's real dialogues.  Each
  duel takes the gradient of the trained network alone and steps its Adam.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F

from ..lib.philox import StepStream
from .common import (Adam, attention, ffn, gelu_head, layer_norm, linear, positional_table,
                     torch_dropout)

# (kind, trained net, its modality, opponent, opponent's modality), train_IEMOCAP.py:355-382
SCHEDULE = (
    ("disc", "visual_disc", "visual", "acoustic_gen", "acoustic"),
    ("gen", "acoustic_gen", "acoustic", "visual_disc", None),
    ("disc", "visual_disc", "visual", "text_gen", "text"),
    ("gen", "text_gen", "text", "visual_disc", None),
    ("disc", "text_disc", "text", "acoustic_gen", "acoustic"),
    ("gen", "acoustic_gen", "acoustic", "text_disc", None),
    ("disc", "acoustic_disc", "acoustic", "text_gen", "text"),
    ("gen", "text_gen", "text", "acoustic_disc", None),
    ("disc", "text_disc", "text", "visual_gen", "visual"),
    ("gen", "visual_gen", "visual", "text_disc", None),
    ("disc", "acoustic_disc", "acoustic", "visual_gen", "visual"),
    ("gen", "visual_gen", "visual", "acoustic_disc", None),
)
NETS = ("acoustic_gen", "visual_gen", "text_gen", "acoustic_disc", "visual_disc", "text_disc")
BATCH_KEY = {"acoustic": "audio", "visual": "visual", "text": "text"}


def encoder(W: Mapping, prefix: str, x, heads: int, valid_len: int, train: bool, cfg,
            stream: StepStream):
    L, B, E = x.shape
    Dh, rate = E // heads, (cfg["encoder_dropout"] if train else 0.0)
    for i in range(cfg["num_layers"]):
        p = f"{prefix}transformer_encoder.layers.{i}."
        qkv = linear(x, W[p + "self_attn.in_proj_weight"], W[p + "self_attn.in_proj_bias"])
        q, k, v = (t.reshape(L, B, heads, Dh).permute(1, 2, 0, 3) for t in qkv.chunk(3, -1))
        a = attention(q, k, v, valid_len, rate, stream.next() if train else None)
        a = linear(a.permute(2, 0, 1, 3).reshape(L, B, E), W[p + "self_attn.out_proj.weight"],
                   W[p + "self_attn.out_proj.bias"])
        x = layer_norm(x + torch_dropout(a, rate, train), W[p + "norm1.weight"],
                       W[p + "norm1.bias"])
        h = ffn(x, W[p + "linear1.weight"], W[p + "linear1.bias"], W[p + "linear2.weight"],
                W[p + "linear2.bias"], rate, stream.next() if train else None)
        x = layer_norm(x + torch_dropout(h, rate, train), W[p + "norm2.weight"],
                       W[p + "norm2.bias"])
    return x


def _pe(x, cfg, train):
    table = positional_table(cfg["pe_max_len"], x.shape[-1], x.device)
    return torch_dropout(x + table[: x.shape[0]], cfg["pe_dropout"], train)


def generator(W: Mapping, prefix: str, modality: str, x, valid_len: int, train: bool, cfg,
              stream: StepStream):
    g = cfg["generators"][modality]
    p = prefix + "net."
    x = encoder(W, p, _pe(x, cfg, train), g["heads"], valid_len, train, cfg, stream)
    rate = cfg["dropout"] if train else 0.0
    return gelu_head(x, W[p + "fc1.weight"], W[p + "fc1.bias"], W[p + "fc2.weight"],
                     W[p + "fc2.bias"], rate, stream.next() if train else None)


def discriminator(W: Mapping, prefix: str, x, valid_len: int, train: bool, cfg,
                  stream: StepStream):
    if x.shape[-1] == cfg["discriminator"]["raw_visual_dim"]:
        x = linear(x, W[prefix + "object.weight"], W[prefix + "object.bias"])
    p = prefix + "net."
    rate = cfg["dropout"]
    x = F.gelu(encoder(W, p, _pe(x, cfg, train), cfg["discriminator"]["heads"], valid_len,
                       train, cfg, stream))
    x = F.gelu(torch_dropout(linear(x, W[p + "fc1.weight"], W[p + "fc1.bias"]), rate, train))
    x = F.gelu(torch_dropout(linear(x, W[p + "fc2.weight"], W[p + "fc2.bias"]), rate, train))
    return torch.sigmoid(torch_dropout(linear(x, W[p + "fc3.weight"], W[p + "fc3.bias"]),
                                       rate, train))


def duel_mask(batch: Mapping, device) -> torch.Tensor:
    L, B = batch["umask"].shape[1], batch["umask"].shape[0]
    t = torch.arange(L, device=device)[:, None] < batch["valid_len"]
    b = torch.arange(B, device=device)[None, :] < batch["n_real"]
    return (t & b).float()[:, :, None]


def bce(pred, target: float, mask):
    elem = F.binary_cross_entropy(pred, torch.full_like(pred, target), reduction="none")
    return (elem * mask).sum() / mask.expand_as(elem).sum()


def split_weights(weights: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{net: {name within the net: leaf}}``, each leaf a fresh tensor that takes a gradient."""
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in NETS}
    for name, w in weights.items():
        net, rest = name.split(".", 1)
        out[net][rest] = w.detach().clone().requires_grad_(True)
    return out


def make_adams(params: Mapping[str, Dict[str, torch.Tensor]], cfg) -> Dict[str, Adam]:
    g = cfg["gan"]
    lr = {n: g["lr"] * (g["disc_lr_scale"] if n.endswith("_disc") else 1.0) for n in NETS}
    lr["text_gen"] = g["lr"] * g["text_gen_lr_scale"]
    return {n: Adam(params[n], lr[n], (g["b1"], g["b2"])) for n in NETS}


def stage_a_step(params: Mapping[str, Dict[str, torch.Tensor]], adams: Mapping[str, Adam],
                 batch: Mapping, cfg, fault: str = "") -> List[torch.Tensor]:
    """One 12-duel step; returns the twelve losses.  ``batch`` holds device
    tensors (``text``, ``audio``, ``visual``, ``umask``) and host ints
    (``valid_len``, ``n_real``, ``seed``).  ``fault`` plants a fault for the
    check's readings: ``half_batch`` averages the BCE over the first half of
    the batch's dialogues only."""
    device = batch["text"].device
    stream, vl = StepStream(batch["seed"]), batch["valid_len"]
    mask = duel_mask(batch, device)
    if fault == "half_batch":
        mask = mask.clone()
        mask[:, mask.shape[1] // 2:] = 0.0
    losses = []
    for kind, net, mod, opp, opp_mod in SCHEDULE:
        W, O = params[net], params[opp]
        real = batch[BATCH_KEY[mod]]
        if kind == "disc":
            real_prob = discriminator(W, "", real, vl, True, cfg, stream)
            with torch.no_grad():
                fake = generator(O, "", opp_mod, batch[BATCH_KEY[opp_mod]], vl, False, cfg,
                                 stream)
            fake_prob = discriminator(W, "", fake, vl, True, cfg, stream)
            loss = (bce(real_prob, 1.0, mask) + bce(fake_prob, 0.0, mask)) / 2.0
        else:
            fused = generator(W, "", mod, real, vl, True, cfg, stream)
            loss = bce(discriminator(O, "", fused, vl, False, cfg, stream), 1.0, mask)
        names = list(W)
        grads = torch.autograd.grad(loss, [W[n] for n in names])
        adams[net].step(dict(zip(names, grads)))
        losses.append(loss.detach())
    return losses
