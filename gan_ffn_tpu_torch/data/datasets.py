"""The IEMOCAP dialogue dataset over the reference's pickled feature schema
(the port's own copy of the IEMOCAP parts of ``gan_ffn_tpu/data/datasets.py``,
numpy only).

- **Dialogue-level min-max normalization** over each dialogue's *entire*
  feature array (one global min and max per dialogue per modality).
- qmask: 2-party one-hot from ``'M'``/``'F'`` speaker tags; umask all ones.
- The constant-feature edge case (max == min, 0/0 in the reference) is
  epsilon-guarded unless ``strict_parity=True``.

MELD, AVEC and DailyDialog come with their slices.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass

import numpy as np


def minmax_normalize(x: np.ndarray, strict_parity: bool = False) -> np.ndarray:
    """Global min-max over the whole array, as in reference dataloader.py:22.

    ``strict_parity=False`` guards the max==min case with an epsilon instead of
    producing NaNs.
    """
    x = np.asarray(x, dtype=np.float32)
    lo, hi = np.min(x), np.max(x)
    denom = hi - lo
    if not strict_parity:
        denom = max(denom, np.float32(1e-12))
    return ((x - lo) / denom).astype(np.float32)


@dataclass
class Dialogue:
    """One dialogue's fixed set of per-utterance arrays, all length ``L``."""

    vid: object
    text: np.ndarray  # (L, D_text) float32
    visual: np.ndarray | None  # (L, D_visual) float32 or None (MELD)
    audio: np.ndarray  # (L, D_audio) float32
    qmask: np.ndarray  # (L, n_parties) float32 one-hot
    label: np.ndarray  # (L,) int32 (or float32 for AVEC regression)

    @property
    def length(self) -> int:
        return int(self.label.shape[0])


class IEMOCAPDataset:
    """IEMOCAP 9-tuple pickle dataset (reference dataloader.py:8-58).

    Label map: {'happy':0,'sad':1,'neutral':2,'angry':3,'excited':4,
    'frustrated':5} (dataloader.py:15).
    """

    n_parties = 2
    label_names = ["happy", "sad", "neutral", "angry", "excited", "frustrated"]

    def __init__(self, path: str, train: bool = True, strict_parity: bool = False):
        with open(path, "rb") as f:
            (
                self.videoIDs,
                self.videoSpeakers,
                self.videoLabels,
                self.videoText,
                self.videoAudio,
                self.videoVisual,
                self.videoSentence,
                self.trainVid,
                self.testVid,
            ) = pickle.load(f, encoding="latin1")

        # Per-dialogue global min-max normalization of every modality
        # (dataloader.py:20-35).
        for store in (self.videoText, self.videoAudio, self.videoVisual):
            for key in store.keys():
                store[key] = minmax_normalize(store[key], strict_parity)

        self.keys = list(self.trainVid if train else self.testVid)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> Dialogue:
        vid = self.keys[index]
        speakers = self.videoSpeakers[vid]
        qmask = np.asarray(
            [[1, 0] if s == "M" else [0, 1] for s in speakers], dtype=np.float32
        )
        return Dialogue(
            vid=vid,
            text=np.asarray(self.videoText[vid], dtype=np.float32),
            visual=np.asarray(self.videoVisual[vid], dtype=np.float32),
            audio=np.asarray(self.videoAudio[vid], dtype=np.float32),
            qmask=qmask,
            label=np.asarray(self.videoLabels[vid], dtype=np.int32),
        )
