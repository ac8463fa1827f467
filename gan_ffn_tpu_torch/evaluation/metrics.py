"""sklearn-compatible masked classification metrics, in pure NumPy (the
port's own copy of ``gan_ffn_tpu/evaluation/metrics.py``).

The reference evaluates with sklearn's ``accuracy_score`` / ``f1_score`` /
``classification_report`` / ``confusion_matrix`` using the utterance mask as
``sample_weight`` (train_IEMOCAP.py:184-188, 744-754).  The report text is
formatted as sklearn formats it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _labels_union(y_true, y_pred):
    return np.unique(np.concatenate([np.unique(y_true), np.unique(y_pred)]))


def accuracy_score(y_true, y_pred, sample_weight: Optional[np.ndarray] = None) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    correct = (y_true == y_pred).astype(np.float64)
    if sample_weight is None:
        return float(correct.mean())
    w = np.asarray(sample_weight, dtype=np.float64)
    return float(np.sum(correct * w) / np.sum(w))


def confusion_matrix(
    y_true,
    y_pred,
    labels: Optional[Sequence] = None,
    sample_weight: Optional[np.ndarray] = None,
) -> np.ndarray:
    """C[i, j] = (weighted) count of samples with true label i, predicted j.

    Integer dtype without sample_weight, float64 with — matching sklearn.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = _labels_union(y_true, y_pred)
    labels = np.asarray(labels)
    n = len(labels)
    index = {lab: i for i, lab in enumerate(labels.tolist())}
    if sample_weight is None:
        w = np.ones(len(y_true), dtype=np.int64)
        C = np.zeros((n, n), dtype=np.int64)
    else:
        w = np.asarray(sample_weight, dtype=np.float64)
        C = np.zeros((n, n), dtype=np.float64)
    for t, p, ww in zip(y_true.tolist(), y_pred.tolist(), w.tolist()):
        ti, pi = index.get(t), index.get(p)
        if ti is None or pi is None:
            continue
        C[ti, pi] += ww
    return C


def precision_recall_fscore_support(
    y_true,
    y_pred,
    labels: Optional[Sequence] = None,
    sample_weight: Optional[np.ndarray] = None,
    beta: float = 1.0,
):
    """Per-class (precision, recall, f-beta, support) with zero_division=0."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = _labels_union(y_true, y_pred)
    C = confusion_matrix(y_true, y_pred, labels=labels, sample_weight=sample_weight)
    C = C.astype(np.float64)
    tp = np.diag(C)
    support = C.sum(axis=1)  # row sums: weighted count of true label
    pred_sum = C.sum(axis=0)

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_sum > 0, tp / pred_sum, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        b2 = beta * beta
        denom = b2 * precision + recall
        fscore = np.where(denom > 0, (1 + b2) * precision * recall / denom, 0.0)
    return precision, recall, fscore, support


def f1_score(
    y_true,
    y_pred,
    labels: Optional[Sequence] = None,
    sample_weight: Optional[np.ndarray] = None,
    average: str = "weighted",
) -> float:
    p, r, f, s = precision_recall_fscore_support(
        y_true, y_pred, labels=labels, sample_weight=sample_weight
    )
    if average == "weighted":
        total = s.sum()
        return float(np.sum(f * s) / total) if total > 0 else 0.0
    if average == "macro":
        return float(f.mean())
    if average == "micro":
        C = confusion_matrix(y_true, y_pred, labels=labels, sample_weight=sample_weight)
        C = C.astype(np.float64)
        tp = np.diag(C).sum()
        return float(tp / C.sum()) if C.sum() > 0 else 0.0
    if average is None:
        return f
    raise ValueError(f"unknown average {average!r}")


def classification_report(
    y_true,
    y_pred,
    labels: Optional[Sequence] = None,
    target_names: Optional[Sequence[str]] = None,
    sample_weight: Optional[np.ndarray] = None,
    digits: int = 2,
) -> str:
    """Text report formatted identically to sklearn's ``classification_report``
    (verified byte-for-byte in tests)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = _labels_union(y_true, y_pred)
    labels = np.asarray(labels)
    if target_names is None:
        target_names = [str(lab) for lab in labels]

    p, r, f, s = precision_recall_fscore_support(
        y_true, y_pred, labels=labels, sample_weight=sample_weight
    )
    acc = accuracy_score(y_true, y_pred, sample_weight=sample_weight)
    total_support = s.sum()
    if sample_weight is None:
        s_disp = s.astype(np.int64)
        total_disp = int(total_support)
    else:
        s_disp = s
        total_disp = total_support

    headers = ["precision", "recall", "f1-score", "support"]
    longest_last_line_heading = "weighted avg"
    name_width = max(len(cn) for cn in target_names)
    width = max(name_width, len(longest_last_line_heading), digits)
    head_fmt = "{:>{width}s} " + " {:>9}" * len(headers)
    report = head_fmt.format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for name, pv, rv, fv, sv in zip(target_names, p, r, f, s_disp):
        report += row_fmt.format(name, pv, rv, fv, sv, width=width, digits=digits)
    report += "\n"

    # accuracy row
    row_fmt_accuracy = (
        "{:>{width}s} "
        + " {:>9.{digits}}" * 2
        + " {:>9.{digits}f}"
        + " {:>9}\n"
    )
    report += row_fmt_accuracy.format(
        "accuracy", "", "", acc, total_disp, width=width, digits=digits
    )

    # macro / weighted averages
    for avg_name, weights in (("macro avg", None), ("weighted avg", s)):
        if weights is None:
            avg_p, avg_r, avg_f = p.mean(), r.mean(), f.mean()
        else:
            tw = weights.sum()
            avg_p = np.sum(p * weights) / tw
            avg_r = np.sum(r * weights) / tw
            avg_f = np.sum(f * weights) / tw
        report += row_fmt.format(
            avg_name, avg_p, avg_r, avg_f, total_disp, width=width, digits=digits
        )
    return report
