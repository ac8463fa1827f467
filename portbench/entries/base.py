"""What every entry shares: the port's batch feed and the reference's batches."""

from __future__ import annotations

import gc
from typing import Dict

import torch

from ..lib.datagen import HostBatch


def port_batch(hb: HostBatch):
    """``hb`` as the port's loader ``Batch``."""
    from gan_ffn_tpu_torch.data.loaders import Batch

    return Batch(text=hb.text, audio=hb.audio, qmask=hb.qmask, umask=hb.umask, label=hb.label,
                 vids=[], visual=hb.visual, n_real=hb.n_real)


def reference_batch(hb: HostBatch, device) -> Dict[str, object]:
    out: Dict[str, object] = {k: torch.from_numpy(getattr(hb, k)).to(device)
                              for k in ("text", "audio", "visual", "qmask", "umask", "label")}
    out.update(valid_len=hb.valid_len, n_real=hb.n_real, seed=hb.seed)
    return out


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
