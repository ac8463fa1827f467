"""Bucketed fixed-shape batching (the port's own copy of the IEMOCAP parts of
``gan_ffn_tpu/data/loaders.py``, numpy only).

Every batch is padded to one of a few bucket lengths and to a fixed batch
size, so the kernels see a handful of shapes.  Layout, as the reference's
tensors (train_IEMOCAP.py:142-148):

- ``text``/``visual``/``audio``: time-major ``(L, B, D)``
- ``qmask``: ``(L, B, n_parties)``
- ``umask``: batch-first ``(B, L)``, 1 for real utterances, 0 for padding
- ``label``: batch-first ``(B, L)``

The validation subset is the *head* of the train-key order, the train
subset the tail; each epoch shuffles within its subset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .datasets import Dialogue

DEFAULT_BUCKETS = (32, 64, 96, 112)


def head_tail_split(n: int, valid: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """(train_indices, valid_indices): valid is the first ``valid*n`` items."""
    split = int(valid * n)
    idx = np.arange(n)
    return idx[split:], idx[:split]


@dataclass
class Batch:
    """One fixed-shape batch of padded dialogues."""

    text: np.ndarray  # (L, B, D_text)
    audio: np.ndarray  # (L, B, D_audio)
    qmask: np.ndarray  # (L, B, n_parties)
    umask: np.ndarray  # (B, L)
    label: np.ndarray  # (B, L)
    vids: List[object]
    visual: Optional[np.ndarray] = None  # (L, B, D_visual); None for MELD
    n_real: int = 0  # number of non-padding dialogues in the batch

    @property
    def seq_len(self) -> int:
        return self.text.shape[0]

    @property
    def batch_size(self) -> int:
        return self.text.shape[1]

    @property
    def n_utterances(self) -> int:
        return int(self.umask.sum())


def _bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"dialogue length {length} exceeds largest bucket {buckets[-1]}")


def collate(dialogues: Sequence[Dialogue], bucket_len: int, batch_size: int) -> Batch:
    """Pad a list of dialogues into one fixed ``(bucket_len, batch_size)`` batch."""
    first = dialogues[0]
    d_text = first.text.shape[-1]
    d_audio = first.audio.shape[-1]
    n_parties = first.qmask.shape[-1]
    has_visual = first.visual is not None
    d_visual = first.visual.shape[-1] if has_visual else 0
    label_dtype = first.label.dtype

    L, B = bucket_len, batch_size
    text = np.zeros((L, B, d_text), dtype=np.float32)
    audio = np.zeros((L, B, d_audio), dtype=np.float32)
    visual = np.zeros((L, B, d_visual), dtype=np.float32) if has_visual else None
    qmask = np.zeros((L, B, n_parties), dtype=np.float32)
    umask = np.zeros((B, L), dtype=np.float32)
    label = np.zeros((B, L), dtype=label_dtype)
    vids: List[object] = []

    for j, d in enumerate(dialogues):
        n = d.length
        text[:n, j] = d.text
        audio[:n, j] = d.audio
        if has_visual:
            visual[:n, j] = d.visual
        qmask[:n, j] = d.qmask
        umask[j, :n] = 1.0
        label[j, :n] = d.label
        vids.append(d.vid)

    return Batch(
        text=text,
        audio=audio,
        visual=visual,
        qmask=qmask,
        umask=umask,
        label=label,
        vids=vids,
        n_real=len(dialogues),
    )


class BucketedLoader:
    """Iterates fixed-shape batches over a subset of a dialogue dataset.

    Matches the reference DataLoader's randomized batching (random order, THEN
    grouping into batches, THEN padding each batch — not length-sorted), so
    training dynamics carry over; only the pad target is a bucket length
    instead of the batch max.

    ``drop_partial=False`` pads the final partial batch with all-masked
    dialogues up to ``batch_size`` so shapes stay static.
    """

    def __init__(
        self,
        dataset,
        indices: Optional[Sequence[int]] = None,
        batch_size: int = 32,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        shuffle: bool = True,
        seed: int = 3407,
        drop_partial: bool = False,
    ):
        self.dataset = dataset
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(dataset)), dtype=np.int64
        )
        self.batch_size = int(batch_size)
        self.buckets = tuple(sorted(buckets))
        self.shuffle = shuffle
        self.seed = seed
        self.drop_partial = drop_partial
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_partial:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        order = self.indices.copy()
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        for start in range(0, len(order), bs):
            chunk = order[start : start + bs]
            if len(chunk) < bs and self.drop_partial:
                break
            dialogues = [self.dataset[int(i)] for i in chunk]
            max_len = max(d.length for d in dialogues)
            bucket = _bucket_for(max_len, self.buckets)
            yield collate(dialogues, bucket, bs)


def get_iemocap_loaders(
    path: str,
    batch_size: int = 32,
    valid: float = 0.1,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    seed: int = 3407,
    strict_parity: bool = False,
) -> Tuple[BucketedLoader, BucketedLoader, BucketedLoader]:
    """(train, valid, test) loaders mirroring get_IEMOCAP_loaders
    (train_IEMOCAP.py:69-100)."""
    from .datasets import IEMOCAPDataset

    trainset = IEMOCAPDataset(path, train=True, strict_parity=strict_parity)
    testset = IEMOCAPDataset(path, train=False, strict_parity=strict_parity)
    train_idx, valid_idx = head_tail_split(len(trainset), valid)
    train_loader = BucketedLoader(
        trainset, train_idx, batch_size, buckets, shuffle=True, seed=seed
    )
    valid_loader = BucketedLoader(
        trainset, valid_idx, batch_size, buckets, shuffle=True, seed=seed + 1
    )
    test_loader = BucketedLoader(
        testset, None, batch_size, buckets, shuffle=False, seed=seed + 2
    )
    return train_loader, valid_loader, test_loader
