"""Convert the reference's ``GAN_save/*.pth`` stage-A networks into the
msgpack files both packages' ``--use-trained-GAN`` read (see
``utils/torch_import.py``).

    python -m gan_ffn_tpu_torch.cli.import_reference --src ./GAN_save --dst ./GAN_save \
        --reference /path/to/the/reference

``--reference`` is the reference's source tree, whose ``model`` module the
``.pth`` files were pickled from.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Import reference .pth GAN checkpoints (PyTorch)")
    p.add_argument("--src", default="./GAN_save", help="directory with *.pth files")
    p.add_argument("--dst", default="./GAN_save", help="output directory")
    p.add_argument("--reference", default=None,
                   help="the reference's source tree (its model module unpickles the files)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..utils.torch_import import import_gan_save

    written = import_gan_save(args.src, args.dst, args.reference)
    for name, path in written.items():
        print(f"{name} -> {path}")
    if not written:
        print(f"no .pth checkpoints found in {args.src}")
    return written


if __name__ == "__main__":
    main()
