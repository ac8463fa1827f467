"""Export a trained ``GAN_FFN`` classifier as the port's serving artifact
(counterpart of ``gan_ffn_tpu/cli/export.py``, the ``gan_ffn`` family).

Train with ``cli/train_iemocap`` (it saves the best classifier as
``{model-save-path}/classifier_best.pt``), then

    python -m gan_ffn_tpu_torch.cli.export --model-save-path ./GAN_save/ \\
        --output gan_ffn.pt --dtype bf16 --weights int8 --verify

writes one ``torch.save`` file (``serving.export_classifier``) that
``cli/serve.py`` or ``serving.ServingClassifier.load`` serves.  ``--dtype
bf16`` stores the ``serving.bf16_variant`` (compute and parameters in
bfloat16; the bf16 kernels on the card), ``--weights int8`` the weights as
per-output-channel int8 with float32 scales (``serving.quantize_weights_int8``);
the two compose, and log-probs are float32 in every variant.

``--verify`` serves the artifact (from memory, before it is written) on
``--device`` (default ``cuda``) and holds it against the live model there
on random requests, one on the bucket grid and one padded odd shape, with
the JAX CLI's bounds: max |diff| <= 1e-4 in float32 and 5e-2 in bf16
against the live model at the variant's dtype and weights (int8:
dequantized), and argmax agreement >= 0.98 against the float32 live
model (meaningful on trained checkpoints; on random weights the argmax sits
on near-uniform log-probs).  It fails with a non-zero exit.  The JAX CLI's
``--platforms`` has no counterpart: the artifact runs wherever the port
does.  ``--model dialoguernn`` and ``meld`` are refused with the ROADMAP
item that brings them.
"""

from __future__ import annotations

import argparse
import copy
import io
import os

import numpy as np
import torch

from ..models import GAN_FFN
from ..serving import (ServingClassifier, bf16_variant, dequantize_weights, export_classifier,
                       quantize_weights_int8)

# an exporter's family -> the ROADMAP item that brings it
LATER_FAMILIES = {
    "dialoguernn": "Queue 1 item 4, serving for the DialogueRNN and MELD families",
    "meld": "Queue 1 item 4, serving for the DialogueRNN and MELD families",
}
F32_TOL, BF16_TOL, MIN_AGREEMENT = 1e-4, 5e-2, 0.98  # gan_ffn_tpu/cli/export.py


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a GAN_FFN classifier to a serving artifact")
    p.add_argument("--model", choices=["gan_ffn", "dialoguernn", "meld"], default="gan_ffn")
    p.add_argument("--model-save-path", default="./GAN_save/",
                   help="directory holding the trainer's classifier_best.pt")
    p.add_argument("--output", default=None, help="artifact path (default <model>.pt)")
    p.add_argument("--batch-size", type=int, default=32,
                   help="serve-side batch quantization target")
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--n-classes", type=int, default=6)
    p.add_argument("--max-len", type=int, default=112)
    p.add_argument("--buckets", type=int, nargs="+", default=[32, 64, 96, 112],
                   help="serve-side length quantization grid")
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


def verify(blob: bytes, model: GAN_FFN, model_f32: GAN_FFN, int8: bool, device, batch: int,
           grid_len: int) -> dict:
    """Serve ``blob`` on ``device`` against ``model`` (the variant, float32
    or bf16; with ``int8`` its weights quantized and dequantized) and
    ``model_f32``, on a request of the bucket grid and an odd one."""
    clf = ServingClassifier.loads(blob, device=device)
    live = copy.deepcopy(model).to(device).eval()
    if int8:
        state = live.state_dict()
        live.load_state_dict(dequantize_weights(quantize_weights_int8(state), state))
    ref = copy.deepcopy(model_f32).to(device).eval()
    rng = np.random.default_rng(0)
    worst, agree, total = 0.0, 0, 0
    for L, B in ((grid_len, batch), (7, 3)):
        xs = [rng.standard_normal((L, B, d)).astype(np.float32) for d in (100, 512, 100)]
        got = clf.log_probs(*xs)
        tensors = [torch.from_numpy(x).to(device) for x in xs]
        with torch.inference_mode():
            want = live(*tensors, valid_len=L).cpu().numpy()
            base = ref(*tensors, valid_len=L).cpu().numpy()
        worst = max(worst, float(np.abs(got - want).max()))
        agree += int(np.sum(got.argmax(2) == base.argmax(2)))
        total += L * B
    return {"max_abs_err": worst, "agree": agree, "total": total}


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.model in LATER_FAMILIES:
        parser.error(f"--model {args.model} is not ported yet "
                     f"(ROADMAP {LATER_FAMILIES[args.model]})")
    device = torch.device(args.device)
    if args.verify and device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card for --verify: pass --device cpu")

    ckpt = os.path.join(args.model_save_path, "classifier_best.pt")
    model = GAN_FFN(n_classes=args.n_classes, gen_num_layers=args.num_layers, device="cpu")
    model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    model.eval()
    print(f"loaded gan_ffn classifier from {ckpt}")
    model_f32 = model  # verify's quality baseline
    if args.dtype == "bf16":
        model = bf16_variant(model)

    buf = io.BytesIO()
    meta = export_classifier(model, buf, max_len=args.max_len, batch_size=args.batch_size,
                             buckets=args.buckets, weights_int8=args.weights == "int8")
    blob = buf.getvalue()
    variant = meta["dtype"] + ("+int8w" if args.weights == "int8" else "")
    print(f"exported {variant} artifact (L<={args.max_len}, buckets {sorted(args.buckets)}): "
          f"{len(blob)} bytes")

    result = {"dtype": meta["dtype"], "weights": meta["weights"], "bytes": len(blob)}
    if args.verify:
        v = verify(blob, model, model_f32, args.weights == "int8", device, args.batch_size,
                   min(args.buckets))
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
