"""Export a trained classifier as the port's serving artifact (counterpart
of ``gan_ffn_tpu/cli/export.py``).

Train with one of the three trainers of either package (each saves its best
classifier under ``--model-save-path`` as the JAX params tree in msgpack,
``utils/checkpoint.py``, in either encoder layout), then

    python -m gan_ffn_tpu_torch.cli.export --model gan_ffn --model-save-path ./GAN_save/ \\
        --output gan_ffn.pt --dtype bf16 --weights int8 --verify

writes one ``torch.save`` file that ``cli/serve.py`` or
``serving.ServingClassifier.load`` serves.  Families (``--model``) and the
checkpoints they load:

- ``gan_ffn`` (default): ``classifier_best.msgpack`` from ``cli/train_iemocap``
  (batch 32);
- ``dialoguernn``: ``dialoguernn_classifier_best.msgpack`` from
  ``cli/train_iemocap_dialoguernn`` (D_g = D_p = 500, D_e = D_h = 100,
  train_IEMOCAP_DialogueRNN.py:635-641; batch 30);
- ``meld``: ``meld_classifier_best.msgpack`` from ``cli/train_meld`` (D_m 600,
  D_e 300, D_h 600, train_MELD.py:143-145; ``--n-classes`` 7 by default;
  batch 30; no time buckets, see ``serving.export_meld_classifier``).

``--dtype bf16`` stores the ``serving.bf16_variant`` (compute and
parameters in bfloat16; the bf16 kernels on the card), ``--weights int8``
the weights as per-output-channel int8 with float32 scales
(``serving.quantize_weights_int8``); the two compose, and log-probs are
float32 in every variant.

``--verify`` serves the artifact (from memory, before it is written) on
``--device`` (default ``cuda``) and holds it against the live model there
on random requests of the family's inputs, one on the grid (the smallest
bucket, or L = 8 for ``meld``) and one odd shape (7, 3), with the JAX
CLI's bounds: max |diff| <= 1e-4 in float32 and 5e-2 in bf16 against the
live model at the variant's dtype and weights (int8: dequantized), and
argmax agreement >= 0.98 against the float32 live model (meaningful on
trained checkpoints; on random weights the argmax sits on near-uniform
log-probs).  It fails with a non-zero exit.  The JAX CLI's ``--platforms``
has no counterpart: the artifact runs wherever the port does.
"""

from __future__ import annotations

import argparse
import copy
import io
import os

import numpy as np
import torch
from torch import nn

from ..models import GAN_FFN, GAN_FFN_DialogueRNN, MELDLSTMModel
from ..serving import (ServingClassifier, bf16_variant, dequantize_weights, export_classifier,
                       export_dialoguernn_classifier, export_meld_classifier,
                       quantize_weights_int8)
from ..utils.checkpoint import load_params_any_layout

F32_TOL, BF16_TOL, MIN_AGREEMENT = 1e-4, 5e-2, 0.98  # gan_ffn_tpu/cli/export.py
# --model -> (checkpoint, default --n-classes, default --batch-size)
CHECKPOINTS = {"gan_ffn": ("classifier_best.msgpack", 6, 32),
               "dialoguernn": ("dialoguernn_classifier_best.msgpack", 6, 30),
               "meld": ("meld_classifier_best.msgpack", 7, 30)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a classifier to a serving artifact")
    p.add_argument("--model", choices=["gan_ffn", "dialoguernn", "meld"], default="gan_ffn")
    p.add_argument("--model-save-path", default="./GAN_save/",
                   help="directory holding the trainer's best-classifier checkpoint")
    p.add_argument("--output", default=None, help="artifact path (default <model>.pt)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="serve-side batch quantization target (default: the family's trainer "
                        "batch size)")
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--n-classes", type=int, default=None,
                   help="default 6 (the IEMOCAP families) or 7 (meld, emotion)")
    p.add_argument("--max-len", type=int, default=112)
    p.add_argument("--buckets", type=int, nargs="+", default=[32, 64, 96, 112],
                   help="serve-side length quantization grid (not for meld)")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="compute and parameter dtype (serving.bf16_variant); log-probs are "
                        "float32 either way")
    p.add_argument("--weights", choices=["native", "int8"], default="native",
                   help="int8: per-output-channel int8 weights with float32 scales "
                        "(serving.quantize_weights_int8), dequantized at load; composes "
                        "with --dtype")
    p.add_argument("--verify", action="store_true", default=False,
                   help="check the artifact against the live model before writing")
    p.add_argument("--device", default="cuda",
                   help="where --verify serves the artifact and runs the live model "
                        "(default cuda)")
    return p


def random_inputs(clf: ServingClassifier, L: int, B: int, rng) -> list:
    """Random request tensors of the artifact's inputs: normal features,
    one-hot speakers, ``umask`` all ones."""
    out = []
    for spec in clf.inputs:
        if spec["kind"] == "feat":
            out.append(rng.standard_normal((L, B, spec["dim"])).astype(np.float32))
        elif spec["kind"] == "qmask":
            out.append(np.eye(spec["dim"], dtype=np.float32)[rng.integers(0, spec["dim"], (L, B))])
        else:
            out.append(np.ones((B, L), np.float32))
    return out


def verify(blob: bytes, model, model_f32, int8: bool, device, batch: int) -> dict:
    """Serve ``blob`` on ``device`` against ``model`` (the variant, float32
    or bf16; with ``int8`` its weights quantized and dequantized) and
    ``model_f32``, on a request of the grid and an odd one."""
    clf = ServingClassifier.loads(blob, device=device)
    live = copy.deepcopy(model).to(device).eval()
    if int8:
        state = live.state_dict()
        live.load_state_dict(dequantize_weights(quantize_weights_int8(state), state))
    ref = copy.deepcopy(model_f32).to(device).eval()
    rng = np.random.default_rng(0)
    worst, agree, total = 0.0, 0, 0
    grid_len = min(clf.buckets) if clf.time_quantize else 8
    for L, B in ((grid_len, batch), (7, 3)):
        xs = random_inputs(clf, L, B, rng)
        got = clf.log_probs(*xs)
        tensors = [torch.from_numpy(x).to(device) for x in xs]
        with torch.inference_mode():
            want, base = (m(*tensors, valid_len=L) for m in (live, ref))
        if model.ATTENTIONS:  # the log-probs lead the attention weights
            want, base = want[0], base[0]
        want, base = want.cpu().numpy(), base.cpu().numpy()
        worst = max(worst, float(np.abs(got - want).max()))
        agree += int(np.sum(got.argmax(2) == base.argmax(2)))
        total += L * B
    return {"max_abs_err": worst, "agree": agree, "total": total}


def load_model(args) -> nn.Module:
    """The ``--model`` family's classifier with the trainer's checkpoint, on the CPU."""
    ckpt = os.path.join(args.model_save_path, CHECKPOINTS[args.model][0])
    if args.model == "gan_ffn":
        model = GAN_FFN(n_classes=args.n_classes, gen_num_layers=args.num_layers, device="cpu")
    elif args.model == "dialoguernn":
        model = GAN_FFN_DialogueRNN(n_classes=args.n_classes, gen_num_layers=args.num_layers,
                                    device="cpu")
    else:
        model = MELDLSTMModel(D_m=600, D_e=300, D_h=600, n_classes=args.n_classes, device="cpu")
    load_params_any_layout(ckpt, model)  # written by either package, either layout
    print(f"loaded {args.model} classifier from {ckpt}")
    return model.eval()


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    _, n_classes, batch = CHECKPOINTS[args.model]
    args.n_classes = n_classes if args.n_classes is None else args.n_classes
    args.batch_size = batch if args.batch_size is None else args.batch_size
    device = torch.device(args.device)
    if args.verify and device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card for --verify: pass --device cpu")

    model = load_model(args)
    model_f32 = model  # verify's quality baseline
    if args.dtype == "bf16":
        model = bf16_variant(model)

    buf = io.BytesIO()
    kw = dict(max_len=args.max_len, batch_size=args.batch_size,
              weights_int8=args.weights == "int8")
    if args.model == "gan_ffn":
        meta = export_classifier(model, buf, buckets=args.buckets, **kw)
    elif args.model == "dialoguernn":
        meta = export_dialoguernn_classifier(model, buf, buckets=args.buckets, **kw)
    else:
        meta = export_meld_classifier(model, buf, **kw)
    blob = buf.getvalue()
    variant = meta["dtype"] + ("+int8w" if args.weights == "int8" else "")
    print(f"exported {meta['family']} {variant} artifact (L<={args.max_len}, buckets "
          f"{meta['buckets']}): {len(blob)} bytes")

    result = {"family": meta["family"], "dtype": meta["dtype"], "weights": meta["weights"],
              "bytes": len(blob)}
    if args.verify:
        v = verify(blob, model, model_f32, args.weights == "int8", device, args.batch_size)
        tol = F32_TOL if args.dtype == "f32" else BF16_TOL
        print(f"verify on {device}: max |artifact - live {variant} model| = "
              f"{v['max_abs_err']:.3e} (limit {tol}); argmax agreement vs f32 live = "
              f"{v['agree']}/{v['total']}")
        if not np.isfinite(v["max_abs_err"]) or v["max_abs_err"] > tol:
            raise SystemExit(f"artifact verification FAILED (err={v['max_abs_err']}, tol={tol})")
        if v["agree"] < MIN_AGREEMENT * v["total"]:
            raise SystemExit(f"artifact verification FAILED "
                             f"(argmax agreement {v['agree']}/{v['total']})")
        result["verify"] = v

    output = args.output or f"{args.model}.pt"
    with open(output, "wb") as f:
        f.write(blob)
    print(f"wrote {output}")
    return {"output": output, **result}


if __name__ == "__main__":
    main()
