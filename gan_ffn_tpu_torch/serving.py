"""Serving for the ``GAN_FFN`` classifier (counterpart of
``gan_ffn_tpu/serving.py``, ``gan_ffn`` family only).

- :func:`export_classifier` writes the port's artifact: a ``torch.save`` of
  the metadata (the JAX artifact's keys, less ``jax_version`` and
  ``platforms``, plus the model ``config``) and the ``state_dict``.  It is
  read back with ``torch.load(..., weights_only=True)``, which unpickles
  tensors and plain containers only.
- :class:`ServingClassifier` rebuilds the model on ``device`` and serves it
  with the JAX class's policy: request shapes are padded up to the bucket
  grid (time) and the batch grid, padding is zeros, keys at and beyond
  ``valid_len`` are masked, and the result is sliced back.

The JAX artifact pins the XLA paths so one StableHLO blob runs on every
platform.  The port has no such blob to protect: its forward runs the
hand-written kernels on the card at every attention and MLP site.  Entry
points pin float32 matmuls to full precision (TF32 off for matmuls and
cuDNN), which the card-vs-CPU agreement checks assume.
"""

from __future__ import annotations

import io
import math
import pickle
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.gan_ffn import GAN_FFN

ARTIFACT_VERSION = 1
DEFAULT_BUCKETS = (32, 64, 96, 112)  # gan_ffn_tpu/data/loaders.py
# IEMOCAP emotion order (gan_ffn_tpu/data/datasets.py label_names)
DEFAULT_LABEL_NAMES = ("happy", "sad", "neutral", "angry", "excited", "frustrated")


def pin_full_f32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _default_inputs_gan_ffn(d_audio: int, d_visual: int, d_text: int):
    return [
        {"name": "audio", "kind": "feat", "dim": d_audio},
        {"name": "visual", "kind": "feat", "dim": d_visual},
        {"name": "text", "kind": "feat", "dim": d_text},
    ]


def export_classifier(
    model: GAN_FFN,
    path,
    *,
    max_len: int = 112,
    batch_size: int = 32,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    label_names: Sequence[str] = DEFAULT_LABEL_NAMES,
) -> Dict[str, Any]:
    """Write ``model`` (a ``GAN_FFN``) as a serving artifact to ``path`` (a
    file path or a writable binary file); returns the metadata."""
    if not isinstance(model, GAN_FFN):
        raise TypeError(f"export_classifier takes a GAN_FFN, got {type(model).__name__}")
    if buckets and max(buckets) > max_len:
        raise ValueError(f"buckets {tuple(buckets)} exceed max_len {max_len}")
    inputs = _default_inputs_gan_ffn(100, 512, 100)
    meta = {
        "version": ARTIFACT_VERSION,
        "model": type(model).__name__,
        "family": "gan_ffn",
        "inputs": inputs,
        "has_valid_len": True,
        "time_quantize": True,
        "max_len": int(max_len),
        "batch_size": int(batch_size),
        "buckets": sorted(int(b) for b in buckets),
        "dims": {s["name"]: s["dim"] for s in inputs},
        "n_classes": int(model.n_classes),
        "label_names": list(label_names),
        "dtype": "float32",
        "weights": "float32",
        "config": {
            "n_classes": int(model.n_classes),
            "D_h": int(model.D_h),
            "gen_num_layers": int(model.gen_num_layers),
        },
    }
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"meta": meta, "state_dict": state}, path)
    return meta


class ServingClassifier:
    """Inference over an artifact written by :func:`export_classifier`.

    ``quantize`` (default True) pads request shapes up to the artifact's
    bucket grid (time) and to the batch policy: multiples of the artifact's
    ``batch_size``, or with ``batch_grid`` (e.g. ``(1, 4, 8, 32)``) the next
    grid size, then ``batch_size`` multiples beyond the grid.
    ``quantize=False`` runs exact request shapes.
    """

    def __init__(self, meta: Mapping[str, Any], state_dict: Mapping[str, torch.Tensor], *,
                 device="cuda", quantize: bool = True,
                 batch_grid: Optional[Sequence[int]] = None):
        if meta.get("version") != ARTIFACT_VERSION:
            raise ValueError(f"unsupported artifact version {meta.get('version')!r}")
        self.meta = dict(meta)
        self.family: str = meta.get("family", "gan_ffn")
        if self.family != "gan_ffn":
            raise NotImplementedError(
                f"serving family {self.family!r} is not yet ported (gan_ffn only)"
            )
        self.inputs = meta["inputs"]
        self.input_names: Tuple[str, ...] = tuple(s["name"] for s in self.inputs)
        self.has_valid_len: bool = meta["has_valid_len"]
        self.time_quantize: bool = meta["time_quantize"]
        self.max_len: int = meta["max_len"]
        self.batch_size: int = meta["batch_size"]
        self.buckets: Tuple[int, ...] = tuple(meta["buckets"])
        self.label_names: Tuple[str, ...] = tuple(meta["label_names"])
        self.dtype: str = meta["dtype"]
        self.weights: str = meta["weights"]
        self.quantize = quantize
        if batch_grid is not None and (
            not batch_grid or any(int(b) < 1 for b in batch_grid)
        ):
            raise ValueError(f"batch_grid must be positive ints, got {batch_grid!r}")
        self.batch_grid: Optional[Tuple[int, ...]] = (
            tuple(sorted(int(b) for b in batch_grid)) if batch_grid else None
        )
        self.device = torch.device(device)
        pin_full_f32()
        cfg = meta["config"]
        self.model = GAN_FFN(
            n_classes=cfg["n_classes"], D_h=cfg["D_h"],
            gen_num_layers=cfg["gen_num_layers"], device=self.device,
        )
        self.model.load_state_dict(state_dict)
        self.model.eval()

    # -- construction ------------------------------------------------------
    @classmethod
    def loads(cls, blob: bytes, **kw) -> "ServingClassifier":
        return cls._from_file(io.BytesIO(blob), **kw)

    @classmethod
    def load(cls, path, **kw) -> "ServingClassifier":
        with open(path, "rb") as f:
            return cls._from_file(f, **kw)

    @classmethod
    def _from_file(cls, f, **kw) -> "ServingClassifier":
        try:
            art = torch.load(f, map_location="cpu", weights_only=True)
        except (pickle.UnpicklingError, RuntimeError, EOFError) as e:  # bad archive
            raise ValueError(f"not a gan_ffn_tpu_torch serving artifact ({e})") from e
        if not isinstance(art, dict) or set(art) != {"meta", "state_dict"}:
            raise ValueError("not a gan_ffn_tpu_torch serving artifact (bad layout)")
        return cls(art["meta"], art["state_dict"], **kw)

    # -- inference ---------------------------------------------------------
    def _quantized_shape(self, L: int, B: int) -> Tuple[int, int]:
        if not self.quantize:
            return L, B
        Lq = L
        if self.time_quantize:
            Lq = next((b for b in self.buckets if L <= b), None)
            if Lq is None:  # between the largest bucket and the hard max
                Lq = self.max_len
        if self.batch_grid:
            Bq = next((g for g in self.batch_grid if B <= g), None)
            if Bq is None:  # beyond the grid: batch_size multiples
                Bq = math.ceil(B / self.batch_size) * self.batch_size
        else:
            Bq = max(self.batch_size, math.ceil(B / self.batch_size) * self.batch_size)
        return Lq, Bq

    def warmup(
        self,
        *,
        lengths: Optional[Sequence[int]] = None,
        batches: Optional[Sequence[int]] = None,
    ) -> List[Tuple[int, int, float]]:
        """Run one zero request per padded shape of the grid, so that the
        kernels are built and the allocator is warm before the first real
        request.  ``lengths`` defaults to the buckets (plus ``max_len`` when
        requests can fall through to it), ``batches`` to the ``batch_grid``
        or the batch size.  Returns ``[(L, B, seconds), ...]`` for the padded
        shapes run, each once."""
        if lengths is None:
            lengths = tuple(self.buckets)
            if not lengths or max(lengths) < self.max_len:
                lengths = lengths + (self.max_len,)
        if batches is None:
            batches = self.batch_grid or (self.batch_size,)
        if not lengths or not batches:
            raise ValueError(
                f"nothing to warm: empty lengths={tuple(lengths)!r} / "
                f"batches={tuple(batches)!r}"
            )
        shapes: List[Tuple[int, int]] = []
        for L in lengths:
            for B in batches:
                q = self._quantized_shape(int(L), int(B))
                if q not in shapes:
                    shapes.append(q)
        timings: List[Tuple[int, int, float]] = []
        for L, B in shapes:
            zeros = [np.zeros((L, B, s["dim"]), np.float32) for s in self.inputs]
            t0 = time.perf_counter()
            self.log_probs(*zeros)
            timings.append((L, B, time.perf_counter() - t0))
        return timings

    def log_probs(self, *tensors: np.ndarray, valid_len: Optional[int] = None) -> np.ndarray:
        """``(audio, visual, text)``, each ``(L, B, dim)`` time-major ->
        ``(L, B, n_classes)`` float32 log-probs.  ``valid_len`` defaults to
        the request's L."""
        if len(tensors) != len(self.inputs):
            raise ValueError(
                f"{self.family} artifact takes {len(self.inputs)} tensors "
                f"{self.input_names}, got {len(tensors)}"
            )
        arrs = [np.asarray(a, np.float32) for a in tensors]
        for a, s in zip(arrs, self.inputs):
            if a.ndim != 3:
                raise ValueError(
                    f"{'/'.join(self.input_names)} tensors must be rank-3 "
                    f"(L, B, D) time-major; {s['name']} has rank {a.ndim}"
                )
        L, B = arrs[0].shape[0], arrs[0].shape[1]
        for a, s in zip(arrs, self.inputs):
            if a.shape[:2] != (L, B):
                raise ValueError(
                    f"input leading dims must agree: expected {s['name']} to "
                    f"start {(L, B)}, got {a.shape[:2]}"
                )
            if a.shape[2] != s["dim"]:
                raise ValueError(
                    f"{s['name']} last dim must be {s['dim']}, got {a.shape[2]}"
                )
        if L > self.max_len:
            raise ValueError(f"sequence length {L} exceeds exported max_len {self.max_len}")
        Lq, Bq = self._quantized_shape(L, B)
        # copy the request as it came and pad it on the device
        padded = [
            F.pad(torch.as_tensor(a).to(self.device), (0, 0, 0, Bq - B, 0, Lq - L))
            for a in arrs
        ]
        # the key mask's length as the kernels read it: one int in device memory
        valid = torch.full((), L if valid_len is None else int(valid_len), dtype=torch.int32,
                           device=self.device)
        with torch.inference_mode():
            out = self.model(*padded, valid_len=valid)
        return out[:L, :B].cpu().numpy()

    def predict(self, *tensors, valid_len: Optional[int] = None) -> np.ndarray:
        """Argmax class ids, (L, B) int32."""
        return np.argmax(
            self.log_probs(*tensors, valid_len=valid_len), axis=2
        ).astype(np.int32)

    def names_for(self, ids: np.ndarray):
        """Map (L, B) class ids to names, a length-B list of length-L lists."""
        return [[self.label_names[c] for c in ids[:, j]] for j in range(ids.shape[1])]

    def predict_names(self, *tensors, valid_len: Optional[int] = None):
        """Class names, a length-B list of length-L lists."""
        return self.names_for(self.predict(*tensors, valid_len=valid_len))
