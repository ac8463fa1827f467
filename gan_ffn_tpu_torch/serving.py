"""Serving for the three classifier families (counterpart of
``gan_ffn_tpu/serving.py``): ``gan_ffn`` (``GAN_FFN``),
``gan_ffn_dialoguernn`` (``GAN_FFN_DialogueRNN``) and ``meld_lstm``
(``MELDLSTMModel``).

- :func:`export_classifier`, :func:`export_dialoguernn_classifier` and
  :func:`export_meld_classifier` write the port's artifact: a
  ``torch.save`` of the metadata (the JAX artifact's keys, less
  ``jax_version`` and ``platforms``, plus the model ``config`` that
  rebuilds it) and the ``state_dict``.  It is read back with
  ``torch.load(..., weights_only=True)``, which unpickles tensors and plain
  containers only.  The metadata records the family's inputs: ``feat`` and
  ``qmask`` inputs are time-major ``(L, B, dim)``, ``umask`` batch-first
  ``(B, L)``.
- :class:`ServingClassifier` rebuilds the family's model on ``device`` and
  serves it with the JAX class's policy: request shapes are padded up to
  the bucket grid (time, where the artifact's ``time_quantize`` allows it)
  and the batch grid, padding is zeros (a zero ``umask`` and ``qmask`` is
  no utterance), ``valid_len`` is passed where the artifact's
  ``has_valid_len`` says so (keys at and beyond it are masked), and the
  result is sliced back.  Padding time is output-preserving for
  ``gan_ffn`` (``valid_len``) and ``gan_ffn_dialoguernn`` (the forward scan
  is causal; the reverse scan and att2 follow each dialogue's ``umask``
  length), not for ``meld_lstm``, whose reverse LSTM reads the whole padded
  sequence backwards: its artifact runs exact request lengths
  (``time_quantize`` false) and pads only the batch.
- Two deployment variants compose, for every family, as in the JAX package
  (``cli/export.py --dtype bf16`` / ``--weights int8``).
  :func:`bf16_variant` gives the model at compute dtype bfloat16 with every
  parameter stored as bfloat16; its forward runs the bf16 kernels.
  :func:`quantize_weights_int8` stores every float parameter with two or
  more axes as int8 with one float32 scale per output channel (per row of
  the port's ``(out, in)`` weights, under ``"<name>:scale"``), which the
  loader dequantizes into the model's dtype (:func:`dequantize_weights`).
  The metadata's ``dtype`` (the compute dtype, which the parameters are
  stored at) and ``weights`` (``dtype`` or ``"int8"``) say which; log-probs
  are float32 in every variant.

The JAX artifact pins the XLA paths so one StableHLO blob runs on every
platform.  The port has no such blob to protect: its forward runs the
hand-written kernels on the card at every attention and MLP site of the
generators (the MELD model has none).  Entry points pin float32 matmuls to
full precision (TF32 off for matmuls and cuDNN) and bf16 ones to float32
sums, which the card-vs-CPU agreement checks assume.
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
from torch import nn

from .models.baselines import MELDLSTMModel
from .models.gan_ffn import GAN_FFN, GAN_FFN_DialogueRNN
from .utils.runtime import configure_cuda_runtime

ARTIFACT_VERSION = 1
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # meta["dtype"] -> torch
SCALE = ":scale"  # suffix of an int8 tensor's scale in an artifact's state_dict
DEFAULT_BUCKETS = (32, 64, 96, 112)  # gan_ffn_tpu/data/loaders.py
# IEMOCAP emotion order (gan_ffn_tpu/data/datasets.py label_names)
DEFAULT_LABEL_NAMES = ("happy", "sad", "neutral", "angry", "excited", "frustrated")
# MELD emotion order (gan_ffn_tpu/data/datasets.py MELDDataset.emotion_names)
MELD_LABEL_NAMES = ("neutral", "surprise", "fear", "sadness", "joy", "disgust", "anger")
# a serving family -> the model its artifact rebuilds
FAMILIES = {"gan_ffn": GAN_FFN, "gan_ffn_dialoguernn": GAN_FFN_DialogueRNN,
            "meld_lstm": MELDLSTMModel}
# an input kind -> its rank: "feat" and "qmask" (L, B, dim), "umask" (B, L)
_RANK = {"feat": 3, "qmask": 3, "umask": 2}


def model_config(model: nn.Module) -> Dict[str, Any]:
    """The metadata's ``config``: what :func:`build_model` rebuilds ``model``
    from (its class's ``CONFIG`` arguments)."""
    return {k: getattr(model, k) for k in type(model).CONFIG}


def dtype_name(model: nn.Module) -> str:
    """The compute dtype of ``model`` as the metadata names it."""
    return "float32" if model.dtype is None else str(model.dtype).replace("torch.", "")


def build_model(cls: type, config: Mapping[str, Any], dtype: str, device, **kw) -> nn.Module:
    """A ``cls`` (one of :data:`FAMILIES`) of ``config`` (the metadata's)
    and ``kw`` at compute ``dtype`` (a :data:`DTYPES` name), its parameters
    stored at that dtype, on ``device``; its weights are drawn anew."""
    torch_dtype = DTYPES[dtype]
    model = cls(**config, **kw, device=device,
                dtype=None if torch_dtype == torch.float32 else torch_dtype)
    return model.to(torch_dtype)


def bf16_variant(model: nn.Module) -> nn.Module:
    """The bfloat16 deployment variant of ``model``, a model of any serving
    family (counterpart of ``gan_ffn_tpu/serving.py::bf16_variant``): the
    same model at compute dtype bfloat16 whose parameters are ``model``'s
    rounded to bfloat16, with its dropout rates, on its device and in its
    mode.  Against ``model`` at compute dtype bf16 with float32 parameters
    (``cli/predict.py --bf16``) it differs only in the LayerNorm scales and
    biases, which the JAX package too keeps in float32 there and rounds
    here."""
    device = next(model.parameters()).device
    variant = build_model(type(model), model_config(model), "bfloat16", device,
                          **{k: getattr(model, k) for k in type(model).DROPOUTS})
    variant.load_state_dict(model.state_dict())  # rounded to the bf16 parameters
    return variant.train(model.training)


def quantize_weights_int8(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weight-only per-output-channel symmetric int8 quantization
    (counterpart of ``gan_ffn_tpu/serving.py::quantize_weights_int8``).

    Every float tensor with two or more axes becomes an int8 ``q`` under its
    name and a float32 ``scale`` under ``name + ":scale"``, one per output
    channel: ``scale = max |x| / 127`` over every axis but the first (the
    port's weights are ``(out, in)``, the JAX kernels ``(in, out)``, so the
    scale of a row is that of a JAX column), 1 where that max is 0, and ``q
    = clip(round(x / scale), -127, 127)`` (round half to even), with ``x``
    in float32.  Biases and LayerNorm parameters pass through unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for name, x in state_dict.items():
        if x.dim() >= 2 and x.is_floating_point():
            xf = x.detach().float()
            scale = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True) / 127.0
            scale = torch.where(scale == 0, torch.ones_like(scale), scale)
            out[name] = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
            out[name + SCALE] = scale
        else:
            out[name] = x
    return out


def dequantize_weights(quantized: Mapping[str, torch.Tensor],
                       template: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of :func:`quantize_weights_int8`'s output: each
    int8 ``q`` as ``(q.float() * scale)`` cast to the dtype of the same key
    in ``template`` (float32 without one); the rest as it is."""
    out: Dict[str, torch.Tensor] = {}
    for name, x in quantized.items():
        if name.endswith(SCALE):
            continue
        if x.dtype == torch.int8:
            dtype = torch.float32 if template is None else template[name].dtype
            x = (x.float() * quantized[name + SCALE]).to(dtype)
        out[name] = x
    return out


def check_state(meta: Mapping[str, Any], state: Mapping[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless ``state``'s tensors are what ``meta``
    says: its ``dtype`` one of :data:`DTYPES`, its ``weights`` that dtype or
    ``"int8"``; every float tensor at the dtype, but the int8 ones, each with
    its float32 scale, and no scale without its int8 tensor."""
    dtype, weights = meta.get("dtype"), meta.get("weights")
    if dtype not in DTYPES:
        raise ValueError(f"artifact dtype {dtype!r}: expected one of {sorted(DTYPES)}")
    if weights not in (dtype, "int8"):
        raise ValueError(f"artifact weights {weights!r}: expected {dtype!r} or 'int8'")
    for name, t in state.items():
        if name.endswith(SCALE):
            q = state.get(name[: -len(SCALE)])
            if weights != "int8" or q is None or q.dtype != torch.int8:
                raise ValueError(f"artifact scale {name!r} without its int8 tensor")
            if t.dtype != torch.float32:
                raise ValueError(f"artifact scale {name!r} is {t.dtype}, expected float32")
        elif t.dtype == torch.int8:
            if weights != "int8" or name + SCALE not in state:
                raise ValueError(f"artifact int8 tensor {name!r} without its scale")
        elif t.dtype != DTYPES[dtype]:
            raise ValueError(f"artifact tensor {name!r} is {t.dtype}; its weights are "
                             f"{weights!r} at dtype {dtype!r}")


def _default_inputs_gan_ffn(d_audio: int, d_visual: int, d_text: int):
    return [
        {"name": "audio", "kind": "feat", "dim": d_audio},
        {"name": "visual", "kind": "feat", "dim": d_visual},
        {"name": "text", "kind": "feat", "dim": d_text},
    ]


def _shape_for(kind: str, dim: Optional[int], L: int, B: int) -> Tuple[int, ...]:
    return (B, L) if kind == "umask" else (L, B, dim)


def _require_family(model: nn.Module, family: str) -> None:
    if type(model) is not FAMILIES[family]:
        raise TypeError(f"a {family} artifact takes a {FAMILIES[family].__name__}, "
                        f"got {type(model).__name__}")


def _export(model: nn.Module, path, family: str, inputs: List[dict], *, has_valid_len: bool,
            time_quantize: bool, max_len: int, batch_size: int, buckets: Sequence[int],
            label_names: Sequence[str], weights_int8: bool) -> Dict[str, Any]:
    """Write ``model`` of ``family`` with the metadata of ``gan_ffn_tpu/serving.py::_export``
    (less ``jax_version`` and ``platforms``, plus ``config``); returns the metadata."""
    _require_family(model, family)
    if buckets and max(buckets) > max_len:
        raise ValueError(f"buckets {tuple(buckets)} exceed max_len {max_len}")
    meta = {
        "version": ARTIFACT_VERSION,
        "model": type(model).__name__,
        "family": family,
        "inputs": list(inputs),
        "has_valid_len": bool(has_valid_len),
        "time_quantize": bool(time_quantize),
        "max_len": int(max_len),
        "batch_size": int(batch_size),
        "buckets": sorted(int(b) for b in buckets),
        "dims": {s["name"]: s["dim"] for s in inputs if s["kind"] == "feat"},
        "n_classes": int(model.n_classes),
        "label_names": list(label_names),
        "dtype": dtype_name(model),  # the compute dtype, which the parameters are stored at
        "weights": "int8" if weights_int8 else dtype_name(model),
        "config": model_config(model),
    }
    storage = DTYPES[meta["dtype"]]
    state = {k: v.detach().cpu().to(storage) for k, v in model.state_dict().items()}
    if weights_int8:
        state = quantize_weights_int8(state)
    torch.save({"meta": meta, "state_dict": state}, path)
    return meta


def export_classifier(
    model: GAN_FFN,
    path,
    *,
    max_len: int = 112,
    batch_size: int = 32,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    label_names: Sequence[str] = DEFAULT_LABEL_NAMES,
    weights_int8: bool = False,
) -> Dict[str, Any]:
    """Write ``model`` (a ``GAN_FFN``) as a ``gan_ffn`` serving artifact to
    ``path`` (a file path or a writable binary file); returns the metadata.
    Inputs ``audio (L, B, 100)``, ``visual (L, B, 512)``, ``text (L, B,
    100)`` and ``valid_len``.  The parameters are stored at the model's
    compute dtype (so a bf16 model with float32 parameters is stored as its
    :func:`bf16_variant`), and with ``weights_int8`` quantized by
    :func:`quantize_weights_int8`; so for the other two exporters."""
    return _export(model, path, "gan_ffn", _default_inputs_gan_ffn(100, 512, 100),
                   has_valid_len=True, time_quantize=True, max_len=max_len,
                   batch_size=batch_size, buckets=buckets, label_names=label_names,
                   weights_int8=weights_int8)


def export_dialoguernn_classifier(
    model: GAN_FFN_DialogueRNN,
    path,
    *,
    max_len: int = 112,
    batch_size: int = 30,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    n_parties: int = 2,
    label_names: Sequence[str] = DEFAULT_LABEL_NAMES,
    weights_int8: bool = False,
) -> Dict[str, Any]:
    """Write ``model`` (a ``GAN_FFN_DialogueRNN``) as a
    ``gan_ffn_dialoguernn`` artifact: inputs ``audio``, ``visual``,
    ``text``, ``qmask (L, B, n_parties)``, ``umask (B, L)`` and
    ``valid_len``; time quantized onto ``buckets`` (output-preserving: the
    padded rows carry ``umask = 0``)."""
    inputs = _default_inputs_gan_ffn(100, 512, 100) + [
        {"name": "qmask", "kind": "qmask", "dim": n_parties},
        {"name": "umask", "kind": "umask", "dim": None},
    ]
    return _export(model, path, "gan_ffn_dialoguernn", inputs, has_valid_len=True,
                   time_quantize=True, max_len=max_len, batch_size=batch_size, buckets=buckets,
                   label_names=label_names, weights_int8=weights_int8)


def export_meld_classifier(
    model: MELDLSTMModel,
    path,
    *,
    max_len: int = 512,
    batch_size: int = 30,
    n_parties: int = 9,
    label_names: Sequence[str] = MELD_LABEL_NAMES,
    weights_int8: bool = False,
) -> Dict[str, Any]:
    """Write ``model`` (a ``MELDLSTMModel``) as a ``meld_lstm`` artifact:
    inputs ``text (L, B, D_m)``, ``qmask (L, B, n_parties)``, ``umask (B,
    L)``, no ``valid_len``; no time buckets (``time_quantize`` false: the
    reverse LSTM reads the whole padded sequence, so padding time would
    change real rows); ``max_len`` is a sanity bound only."""
    _require_family(model, "meld_lstm")
    inputs = [
        {"name": "text", "kind": "feat", "dim": int(model.D_m)},
        {"name": "qmask", "kind": "qmask", "dim": n_parties},
        {"name": "umask", "kind": "umask", "dim": None},
    ]
    return _export(model, path, "meld_lstm", inputs, has_valid_len=False, time_quantize=False,
                   max_len=max_len, batch_size=batch_size, buckets=(), label_names=label_names,
                   weights_int8=weights_int8)


class ServingClassifier:
    """Inference over an artifact of any family (:func:`export_classifier`,
    :func:`export_dialoguernn_classifier`, :func:`export_meld_classifier`).

    ``quantize`` (default True) pads request shapes up to the artifact's
    bucket grid (time, unless its ``time_quantize`` is false) and to the
    batch policy: multiples of the artifact's ``batch_size``, or with
    ``batch_grid`` (e.g. ``(1, 4, 8, 32)``) the next grid size, then
    ``batch_size`` multiples beyond the grid.  ``quantize=False`` runs exact
    request shapes.  The family's model is built from the metadata's
    ``config`` at the artifact's ``dtype`` (its parameters too) before the
    weights are loaded, int8 ones dequantized into it; ``log_probs`` are
    float32 in every variant.  An unknown family is refused.
    """

    def __init__(self, meta: Mapping[str, Any], state_dict: Mapping[str, torch.Tensor], *,
                 device="cuda", quantize: bool = True,
                 batch_grid: Optional[Sequence[int]] = None):
        if meta.get("version") != ARTIFACT_VERSION:
            raise ValueError(f"unsupported artifact version {meta.get('version')!r}")
        self.meta = dict(meta)
        self.family: str = meta.get("family", "gan_ffn")
        if self.family not in FAMILIES:
            raise ValueError(f"unknown serving family {self.family!r}: expected one of "
                             f"{sorted(FAMILIES)}")
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
        configure_cuda_runtime()
        check_state(meta, state_dict)
        # at the artifact's dtype first: load_state_dict copies into the
        # parameters' dtype, so a float32 module would serve a bf16 artifact in float32
        self.model = build_model(FAMILIES[self.family], meta["config"], self.dtype, self.device)
        if self.weights == "int8":
            state_dict = dequantize_weights(state_dict, self.model.state_dict())
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
        except (pickle.UnpicklingError, RuntimeError, EOFError, ValueError) as e:  # bad archive
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
        requests can fall through to it); an artifact that runs exact time
        lengths (``time_quantize`` false, the ``meld_lstm`` family) has no
        such grid and raises ``ValueError`` unless ``lengths`` are given.
        ``batches`` defaults to the ``batch_grid`` or the batch size.
        Returns ``[(L, B, seconds), ...]`` for the padded shapes run, each
        once."""
        if lengths is None:
            if not self.time_quantize:
                raise ValueError(
                    "nothing to warm: this artifact runs exact time lengths "
                    "(time_quantize=False): pass lengths=(...) for the request "
                    "lengths you expect to serve"
                )
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
            zeros = [np.zeros(_shape_for(s["kind"], s["dim"], L, B), np.float32)
                     for s in self.inputs]
            t0 = time.perf_counter()
            self.log_probs(*zeros)
            timings.append((L, B, time.perf_counter() - t0))
        return timings

    def log_probs(self, *tensors: np.ndarray, valid_len: Optional[int] = None) -> np.ndarray:
        """The artifact's inputs in order (``self.input_names``): ``(audio,
        visual, text)`` for ``gan_ffn``, with ``(qmask, umask)`` for
        ``gan_ffn_dialoguernn``, ``(text, qmask, umask)`` for ``meld_lstm``;
        features and ``qmask`` time-major ``(L, B, dim)``, ``umask`` ``(B,
        L)`` -> ``(L, B, n_classes)`` float32 log-probs.  ``valid_len``
        (where the artifact takes one) defaults to the request's L."""
        if len(tensors) != len(self.inputs):
            raise ValueError(
                f"{self.family} artifact takes {len(self.inputs)} tensors "
                f"{self.input_names}, got {len(tensors)}"
            )
        arrs = [np.asarray(a, np.float32) for a in tensors]
        for a, s in zip(arrs, self.inputs):
            if a.ndim != _RANK[s["kind"]]:
                raise ValueError(
                    f"{'/'.join(self.input_names)} tensors must be rank-3 "
                    f"(L, B, D) time-major (umask rank-2 (B, L)); "
                    f"{s['name']} has rank {a.ndim}"
                )
        L, B = arrs[0].shape[0], arrs[0].shape[1]
        for a, s in zip(arrs, self.inputs):
            want = (B, L) if s["kind"] == "umask" else (L, B)
            if a.shape[:2] != want:
                raise ValueError(
                    f"input leading dims must agree: expected {s['name']} to "
                    f"start {want}, got {a.shape[:2]}"
                )
            if s["kind"] != "umask" and a.shape[2] != s["dim"]:
                raise ValueError(
                    f"{s['name']} last dim must be {s['dim']}, got {a.shape[2]}"
                )
        if L > self.max_len:
            raise ValueError(f"sequence length {L} exceeds exported max_len {self.max_len}")
        Lq, Bq = self._quantized_shape(L, B)
        # copy the request as it came and pad it on the device, with zeros
        padded = [
            F.pad(torch.as_tensor(a).to(self.device),
                  (0, Lq - L, 0, Bq - B) if s["kind"] == "umask" else (0, 0, 0, Bq - B, 0, Lq - L))
            for a, s in zip(arrs, self.inputs)
        ]
        kw = {}
        if self.has_valid_len:
            # the key mask's length as the kernels read it: one int in device memory
            kw["valid_len"] = torch.full((), L if valid_len is None else int(valid_len),
                                         dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            out = self.model(*padded, **kw)
        if self.model.ATTENTIONS:  # the log-probs lead the attention weights
            out = out[0]
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
