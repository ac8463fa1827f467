"""Report artifact writers (the port's own copy of
``gan_ffn_tpu/evaluation/reports.py``; reference train_IEMOCAP.py:736-760).

Reproduces the reference's output file byte layout:
``./output/test_out_GAN-epochs={g}_F1-score={f1}.txt`` containing
``Loss {loss} F1-score {f1}`` + sklearn classification_report (digits=4) +
``str(confusion_matrix)``.
"""

from __future__ import annotations

import os
from .metrics import classification_report, confusion_matrix, f1_score


def format_test_report(best_loss, labels, preds, masks) -> str:
    final_f1 = round(
        f1_score(labels, preds, sample_weight=masks, average="weighted") * 100, 2
    )
    out = "Loss {} F1-score {}".format(best_loss, final_f1)
    out += str(classification_report(labels, preds, sample_weight=masks, digits=4))
    out += str(confusion_matrix(labels, preds, sample_weight=masks))
    return out


def write_test_report(
    output_dir: str,
    gan_epochs: int,
    best_loss,
    labels,
    preds,
    masks,
) -> str:
    """Write the sweep report file; returns its path."""
    final_f1 = round(
        f1_score(labels, preds, sample_weight=masks, average="weighted") * 100, 2
    )
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(
        output_dir, f"test_out_GAN-epochs={gan_epochs}_F1-score={final_f1}.txt"
    )
    with open(path, "w") as f:
        f.write(format_test_report(best_loss, labels, preds, masks))
    return path
