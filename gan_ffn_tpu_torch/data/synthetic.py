"""Synthetic IEMOCAP feature pickle (the port's own copy of the IEMOCAP part
of ``gan_ffn_tpu/data/synthetic.py``, numpy only).

The reference ships without its feature pickles, so fixtures are written
with the exact 9-tuple schema the dataset loads: ``(videoIDs, videoSpeakers,
videoLabels, videoText, videoAudio, videoVisual, videoSentence, trainVid,
testVid)``.  Features are class-conditional Gaussian clusters, so a
classifier trained on them can learn.  The same arguments and seed write
the same pickle as the JAX package's writer.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

IEMOCAP_DIMS = {"text": 100, "audio": 100, "visual": 512}

IEMOCAP_N_CLASSES = 6

IEMOCAP_MAX_LEN = 110


def _class_means(rng: np.random.Generator, n_classes: int, dim: int, spread: float):
    return rng.normal(0.0, spread, size=(n_classes, dim))


def _markov_labels(
    rng, L: int, n_classes: int, persistence: float, priors=None
) -> np.ndarray:
    """Emotion sequence with temporal persistence: with probability
    ``persistence`` the next utterance keeps the current emotion, else it
    resamples (uniformly, or from ``priors``) — real conversations carry
    emotion across turns, which gives context models (DialogueRNN) signal
    beyond per-utterance features."""
    labels = np.empty(L, dtype=np.int64)

    def draw():
        if priors is None:
            return rng.integers(0, n_classes)
        return int(rng.choice(n_classes, p=priors))

    labels[0] = draw()
    for t in range(1, L):
        labels[t] = labels[t - 1] if rng.random() < persistence else draw()
    return labels


def _collapse_confusable_pairs(
    means: dict, n_classes: int, n_pairs: int
) -> dict:
    """Make classes separable only through cross-modal fusion: per modality,
    collapse ``n_pairs`` of the disjoint class pairs (0,1),(2,3),... onto a
    shared mean, ROTATING which pairs are collapsed across modalities so no
    single modality can resolve every class but any fusion of all three can.

    E.g. 6 classes / 3 modalities / n_pairs=2 (modalities iterate in sorted
    order: audio, text, visual): audio cannot tell 0↔1 or 2↔3 apart, text
    cannot tell 2↔3 or 4↔5, visual cannot tell 4↔5 or 0↔1 —
    every pair is resolvable in exactly ``3 - n_pairs`` modalities, so the
    downstream classifier's F1 depends on how consistently the three grafted
    generators embed the modalities into the shared fusion space. This is the
    regime where stage-A (cross-modal adversarial alignment) quality moves
    the final metric — the discriminating-sweep fixture of VERDICT r3 item 4.
    """
    pairs = [(a, a + 1) for a in range(0, n_classes - 1, 2)]
    for mi, modality in enumerate(sorted(means)):
        for k in range(n_pairs):
            a, b = pairs[(mi + k) % len(pairs)]
            means[modality][b] = means[modality][a]
    return means


def write_synthetic_iemocap(
    path: str,
    n_train: int = 120,
    n_test: int = 31,
    min_len: int = 5,
    max_len: int = IEMOCAP_MAX_LEN,
    seed: int = 3407,
    class_spread: float = 2.0,
    noise: float = 1.0,
    persistence: float = 0.5,
    label_noise: float = 0.0,
    confusable_pairs: int = 0,
    class_priors=None,
) -> str:
    """Write a synthetic IEMOCAP-schema feature pickle and return ``path``.

    Default split sizes match the real IEMOCAP feature file (120 train / 31
    test dialogues). Features for each modality are drawn from
    class-conditional Gaussians sharing per-class means across modalities, so
    the fused space is learnable; labels carry turn-to-turn persistence so
    dialogue-context models have exploitable temporal structure.

    ``label_noise`` flips each OBSERVED label to a different class with the
    given probability (features stay conditioned on the true label). This
    bounds the achievable accuracy at ~``1 - label_noise`` and makes the
    fixture non-trivially separable — the regime the full-pipeline quality
    A/B (scripts/ab_full_pipeline.py) runs in, where a final F1 of 100 would
    prove nothing.

    ``confusable_pairs`` (0-3) collapses that many class-mean pairs PER
    MODALITY, rotated so different pairs are ambiguous in different
    modalities (see ``_collapse_confusable_pairs``) — classes become
    separable only through cross-modal fusion, which is where the stage-A
    alignment budget (GAN epochs) can move final F1. ``class_priors``
    (length-6 probabilities) skews the emotion marginals so the class modes
    differ in mass, making the unsupervised mode correspondence of the
    12-duel alignment identifiable.
    """
    rng = np.random.default_rng(seed)
    dims = IEMOCAP_DIMS
    if class_priors is not None:
        class_priors = np.asarray(class_priors, dtype=np.float64)
        class_priors = class_priors / class_priors.sum()
    means = {m: _class_means(rng, IEMOCAP_N_CLASSES, d, class_spread) for m, d in dims.items()}
    if confusable_pairs:
        means = _collapse_confusable_pairs(means, IEMOCAP_N_CLASSES, confusable_pairs)

    videoIDs, videoSpeakers, videoLabels = {}, {}, {}
    videoText, videoAudio, videoVisual, videoSentence = {}, {}, {}, {}

    all_vids = [f"Ses{(i // 30) + 1:02d}_dia{i:04d}" for i in range(n_train + n_test)]
    for vid in all_vids:
        L = int(rng.integers(min_len, max_len + 1))
        labels = _markov_labels(rng, L, IEMOCAP_N_CLASSES, persistence, class_priors)
        speakers = ["M" if s else "F" for s in rng.integers(0, 2, size=L)]
        videoIDs[vid] = [f"{vid}_utt{t}" for t in range(L)]
        videoSpeakers[vid] = speakers
        observed = labels.copy()
        if label_noise > 0.0:
            flip = rng.random(L) < label_noise
            # flip to a uniformly-drawn DIFFERENT class
            observed[flip] = (
                labels[flip]
                + rng.integers(1, IEMOCAP_N_CLASSES, size=int(flip.sum()))
            ) % IEMOCAP_N_CLASSES
        videoLabels[vid] = observed.tolist()
        videoText[vid] = (means["text"][labels] + rng.normal(0, noise, (L, dims["text"]))).astype(
            np.float32
        )
        videoAudio[vid] = (
            means["audio"][labels] + rng.normal(0, noise, (L, dims["audio"]))
        ).astype(np.float32)
        videoVisual[vid] = (
            means["visual"][labels] + rng.normal(0, noise, (L, dims["visual"]))
        ).astype(np.float32)
        videoSentence[vid] = [f"synthetic utterance {t}" for t in range(L)]

    trainVid = all_vids[:n_train]
    testVid = all_vids[n_train:]

    payload = (
        videoIDs,
        videoSpeakers,
        videoLabels,
        videoText,
        videoAudio,
        videoVisual,
        videoSentence,
        trainVid,
        testVid,
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path
