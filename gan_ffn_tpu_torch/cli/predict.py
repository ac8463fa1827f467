"""Batch inference with a trained ``GAN_FFN`` classifier (counterpart of
``gan_ffn_tpu/cli/predict.py``).

    python -m gan_ffn_tpu_torch.cli.predict --data-path data/iemocap/IEMOCAP_features.pkl \\
        --model-save-path ./GAN_save/ --output predictions.json

loads ``{model-save-path}/classifier_best.msgpack`` (written by either
package's ``cli/train_iemocap``, in either encoder layout), classifies
every utterance of the ``--split``, and prints the weighted F1, the
classification report and the confusion matrix; ``--output`` writes each
dialogue's predicted labels as JSON.
Batches are the trainer's test loader's: ``--batch-size`` dialogues in
file order, no shuffle, each padded to its bucket, with the batch's longest
dialogue as ``valid_len``.  A shorter dialogue's outputs depend on that
batch (its padding rows up to ``valid_len`` are attended, as in the
reference), so on the same checkpoint and the test split this reproduces
the trainer's best-epoch test F1.  ``--bf16`` computes in bfloat16 with the
float32 parameters cast at each use (the JAX CLI's ``--bf16``), on the bf16
kernels on the card.  ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data import BucketedLoader, IEMOCAPDataset
from ..evaluation.metrics import classification_report, confusion_matrix, f1_score
from ..models import GAN_FFN
from ..serving import pin_full_f32
from ..train.loop import batch_to_tensors
from ..utils.checkpoint import load_params_any_layout


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GAN_FFN batch inference (PyTorch)")
    p.add_argument("--data-path", default="data/iemocap/IEMOCAP_features.pkl")
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--model-save-path", default="./GAN_save/")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--bf16", action="store_true", default=False,
                   help="compute in bfloat16, the float32 parameters cast at each use")
    p.add_argument("--output", default=None, help="write per-dialogue JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card: pass --device cpu to predict on the CPU")
    pin_full_f32()

    model = GAN_FFN(n_classes=len(IEMOCAPDataset.label_names), gen_num_layers=args.num_layers,
                    device=device, dtype=torch.bfloat16 if args.bf16 else None)
    ckpt = os.path.join(args.model_save_path, "classifier_best.msgpack")
    load_params_any_layout(ckpt, model).eval()
    print(f"loaded classifier from {ckpt} ({'bfloat16' if args.bf16 else 'float32'} on {device})")
    ds = IEMOCAPDataset(args.data_path, train=(args.split == "train"))
    loader = BucketedLoader(ds, batch_size=args.batch_size, shuffle=False)

    per_dialogue, all_preds, all_labels, all_masks = [], [], [], []
    for batch in loader:
        tensors = batch_to_tensors(batch, device)
        with torch.inference_mode():
            log_prob = model(*(tensors[k] for k in GAN_FFN.INPUTS),
                             valid_len=tensors["valid_len"])
        preds = log_prob.argmax(dim=2).cpu().numpy()  # (L, B)
        for j, vid in enumerate(batch.vids):
            n = int(batch.umask[j].sum())
            per_dialogue.append({"vid": str(vid), "predictions":
                                 [IEMOCAPDataset.label_names[c] for c in preds[:n, j]]})
        all_preds.append(preds.T.reshape(-1))
        all_labels.append(batch.label.reshape(-1))
        all_masks.append(batch.umask.reshape(-1))

    preds, labels, masks = (np.concatenate(a) for a in (all_preds, all_labels, all_masks))
    f1 = round(f1_score(labels, preds, sample_weight=masks, average="weighted") * 100, 2)
    print(f"weighted F1 on {args.split}: {f1}")
    print(classification_report(labels, preds, sample_weight=masks, digits=4))
    print(confusion_matrix(labels, preds, sample_weight=masks))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(per_dialogue, f, indent=1)
        print(f"wrote {len(per_dialogue)} dialogue predictions to {args.output}")
    return {"f1": f1, "n_dialogues": len(per_dialogue)}


if __name__ == "__main__":
    main()
