"""Loss-history CSV and plot artifacts (the port's own copy of
``gan_ffn_tpu/utils/artifacts.py``; reference train_IEMOCAP.py:396-424).

CSV schema matches ``output/GAN_loss.csv`` exactly:
``epoch,acoustic_G_loss,visual_G_loss,text_G_loss,visual_D_loss,text_D_loss,acoustic_D_loss``
one row per epoch (the reference appends only the LAST batch's losses each
epoch, train_IEMOCAP.py:390-392). Resume runs concatenate onto the existing
CSV (train_IEMOCAP.py:539-557).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

LOSS_COLUMNS = [
    "epoch",
    "acoustic_G_loss",
    "visual_G_loss",
    "text_G_loss",
    "visual_D_loss",
    "text_D_loss",
    "acoustic_D_loss",
]

LossHistory = List[Dict[str, float]]


def append_loss_row(history: LossHistory, epoch: int, losses: Dict[str, float]) -> None:
    row = {"epoch": epoch}
    for col in LOSS_COLUMNS[1:]:
        row[col] = float(losses[col])
    history.append(row)


def save_gan_loss_csv(history: LossHistory, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=LOSS_COLUMNS)
        writer.writeheader()
        writer.writerows(history)
    return path


def load_gan_loss_csv(path: str) -> LossHistory:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        out: LossHistory = []
        for row in reader:
            parsed = {"epoch": int(float(row["epoch"]))}
            for col in LOSS_COLUMNS[1:]:
                parsed[col] = float(row[col])
            out.append(parsed)
        return out


def draw_gan_loss(history: LossHistory, path: str) -> str:
    """Six-curve loss plot -> PNG (reference draw_GAN_loss).  Matplotlib is
    optional: without it no PNG is written and "" is returned."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return ""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    epochs = [r["epoch"] for r in history]
    plt.figure(figsize=(10, 8), dpi=300)
    for col in LOSS_COLUMNS[1:]:
        plt.plot(epochs, [r[col] for r in history], label=col)
    plt.legend()
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.title("GAN loss")
    plt.savefig(path)
    plt.close()
    return path
