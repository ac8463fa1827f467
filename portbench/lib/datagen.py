"""The one traffic generator: an IEMOCAP-shaped train split and its epochs of
padded batches, drawn from a traffic file's parameters and ``--seed``.

Copied from the port's ``data/synthetic.py`` (class-conditional Gaussian
features with per-class means shared by the three modalities, emotion labels
that persist from turn to turn, random speakers) and ``data/datasets.py``
(each dialogue's modality min-max normalised as a whole).  Two changes make
every seed the same work:

- the dialogue lengths are one fixed multiset (:func:`fixed_lengths`) of
  ``dialogues`` lengths from ``length_min`` to ``length_max`` that sum to
  ``utterances``, and the order of the dialogues in each epoch is a
  permutation drawn from a stream of its own that the seed does not touch;
  each epoch is cut into batches of ``batch_size`` in that order, each padded
  to the smallest bucket that holds its longest dialogue, the last one filled
  with empty dialogues;
- the seed draws the contents: features, labels, speakers, and each batch's
  dropout seed base (drawn in batch order, as the port's epoch-fused loop
  draws them).

So every seed runs the same batches of the same shapes and lengths, in the
same order: the same work on other values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np

DIMS = {"text": 100, "audio": 100, "visual": 512}
MODALITIES = ("text", "audio", "visual")


@dataclasses.dataclass
class Split:
    lengths: np.ndarray  # (n,)
    features: Dict[str, List[np.ndarray]]  # modality -> per dialogue (length, dim)
    speakers: List[np.ndarray]  # per dialogue (length,) in {0, 1}
    labels: List[np.ndarray]  # per dialogue (length,) int


@dataclasses.dataclass
class HostBatch:
    """One padded batch, time-major as the port's loader pads it."""

    text: np.ndarray  # (L, B, 100)
    audio: np.ndarray  # (L, B, 100)
    visual: np.ndarray  # (L, B, 512)
    qmask: np.ndarray  # (L, B, 2)
    umask: np.ndarray  # (B, L)
    label: np.ndarray  # (B, L)
    n_real: int
    seed: int  # the step's dropout seed base

    @property
    def valid_len(self) -> int:
        return int(self.umask.sum(axis=1).max())

    @property
    def utterances(self) -> int:
        return int(self.umask.sum())

    @property
    def shape(self) -> tuple:
        return self.umask.shape


def fixed_lengths(n: int, total: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths from ``lo`` to ``hi`` that sum to ``total``: the same
    multiset for every seed.  The i-th is ``lo + (hi - lo) * (i / (n - 1))**p``,
    the exponent ``p`` set by bisection so that the lengths sum to ``total``,
    rounded by largest remainders; so the shortest is ``lo``, the longest
    ``hi``, and ``p > 1`` puts more of them short."""
    if n < 2 or not lo * (n - 1) + hi < total < lo + hi * (n - 1):
        raise ValueError(f"no {n} lengths from {lo} to {hi} sum to {total}")
    u = np.arange(n) / (n - 1)
    a, b = 1e-3, 1e3
    for _ in range(200):
        p = (a * b) ** 0.5
        if (lo + (hi - lo) * u**p).sum() > total:
            a = p
        else:
            b = p
    x = lo + (hi - lo) * u**p
    out = np.floor(x).astype(np.int64)
    out[np.argsort(out - x, kind="stable")[:total - int(out.sum())]] += 1
    return out


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = np.min(x), np.max(x)
    return ((x - lo) / max(hi - lo, np.float32(1e-12))).astype(np.float32)


STRUCTURE = 20260419  # the stream of the dialogues' lengths and of each epoch's order


def make_split(traffic: Mapping, seed: int) -> Split:
    rng = np.random.default_rng([int(seed), 1])
    n, n_classes = int(traffic["dialogues"]), int(traffic["classes"])
    lengths = np.random.default_rng([STRUCTURE, 1]).permutation(
        fixed_lengths(n, int(traffic["utterances"]), int(traffic["length_min"]),
                      int(traffic["length_max"])))
    means = {m: rng.normal(0.0, float(traffic["class_spread"]), (n_classes, d))
             for m, d in DIMS.items()}
    keep = float(traffic["label_persistence"])
    labels, speakers = [], []
    for length in lengths:
        lab = np.empty(length, dtype=np.int64)
        lab[0] = rng.integers(0, n_classes)
        stay, fresh = rng.random(length) < keep, rng.integers(0, n_classes, length)
        for t in range(1, length):
            lab[t] = lab[t - 1] if stay[t] else fresh[t]
        labels.append(lab)
        speakers.append(rng.integers(0, 2, length))
    total, cuts = int(lengths.sum()), np.cumsum(lengths)[:-1]
    features = {}
    for m in MODALITIES:
        flat = means[m][np.concatenate(labels)] + rng.normal(0.0, 1.0, (total, DIMS[m]))
        features[m] = [_minmax(x.astype(np.float32)) for x in np.split(flat, cuts)]
    return Split(lengths, features, speakers, labels)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    raise ValueError(f"dialogue length {length} exceeds the largest bucket {max(buckets)}")


def collate(split: Split, idx: Sequence[int], traffic: Mapping, seed: int) -> HostBatch:
    B = int(traffic["batch_size"])
    L = bucket_for(int(split.lengths[list(idx)].max()), traffic["buckets"])
    arrays = {m: np.zeros((L, B, DIMS[m]), np.float32) for m in MODALITIES}
    qmask = np.zeros((L, B, 2), np.float32)
    umask = np.zeros((B, L), np.float32)
    label = np.zeros((B, L), np.int64)
    for j, i in enumerate(idx):
        n = int(split.lengths[i])
        for m in MODALITIES:
            arrays[m][:n, j] = split.features[m][i]
        qmask[np.arange(n), j, split.speakers[i]] = 1.0
        umask[j, :n] = 1.0
        label[j, :n] = split.labels[i]
    return HostBatch(arrays["text"], arrays["audio"], arrays["visual"], qmask, umask, label,
                     len(idx), seed)


def make_epochs(split: Split, traffic: Mapping, seed: int, n_epochs: int) -> List[List[HostBatch]]:
    """``n_epochs`` epochs of batches, each in batch (loader) order."""
    rng, orders = np.random.default_rng([int(seed), 2]), np.random.default_rng([STRUCTURE, 2])
    B, n = int(traffic["batch_size"]), len(split.lengths)
    epochs = []
    for _ in range(n_epochs):
        order = orders.permutation(n)
        chunks = [order[s:s + B] for s in range(0, n, B)]
        bases = rng.integers(0, 2**63 - 1, len(chunks))
        epochs.append([collate(split, c, traffic, int(s)) for c, s in zip(chunks, bases)])
    return epochs

