"""Embedding extraction CLI: weight folder + aligned image folder ->
l2-normalized features.

Counterpart of `msml_tpu/cli/embed.py`: flip-sum features, the folder-eval
input transform (Resize -> CenterCrop -> [-1,1] / gray per the weight
folder's config, `eval/folder_eval.py`), batched through the eval forward
(`train/train_step.py::make_eval_step`). Runs on `cuda` unless `--device
cpu` is given.

Usage:
  python -m msml_torch.cli.embed --weight_folder out/arc18_msml_1 \\
      --src aligned_faces/ --out feats.npy      # + feats.npy.names.txt

Images are expected aligned to the model's input size. Output row i is the
embedding of the i-th name in the names file. Binary PPM (`.ppm`) images
are read without Pillow, and are the only format on a machine without it;
the other formats decode with Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# the JAX package's formats, and binary PPM for machines without Pillow
IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")


def list_images(src: str):
    """Stable-sorted relative paths of all images under src."""
    names = []
    for root, _, files in os.walk(src):
        for f in files:
            if f.lower().endswith(IMG_EXTS):
                names.append(os.path.relpath(os.path.join(root, f), src))
    return sorted(names)


def main(args):
    from msml_torch import resolve_device
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.eval.folder_eval import read_image, tensorize_folder_img
    from msml_torch.eval.verification import l2_normalize_np
    from msml_torch.train.train_step import make_eval_step

    device = resolve_device(args.device)
    cfg, model = load_weight_folder(args.weight_folder, device=device)
    eval_step = make_eval_step(model)
    names = list_images(args.src)
    if not names:
        raise SystemExit(f"no images under {args.src!r}")
    out_size = tuple(cfg.out_size)
    is_gray = bool(cfg.get("is_gray", False))
    use_norm = bool(cfg.get("use_norm", True))

    feats = None
    flips = (False, True) if args.flip else (False,)
    for s in range(0, len(names), args.batch_size):
        chunk = names[s:s + args.batch_size]
        imgs = [read_image(os.path.join(args.src, n)) for n in chunk]
        for flip in flips:
            x = np.stack([tensorize_folder_img(im, out_size, use_norm,
                                               is_gray, flip=flip)
                          for im in imgs])
            f = eval_step(x.astype(np.float32))
            if feats is None:
                feats = np.zeros((len(names), f.shape[1]), np.float32)
            feats[s:s + len(chunk)] += f
        if args.verbose:
            print(f"{min(s + args.batch_size, len(names))}/{len(names)}")

    if args.l2_norm:
        feats = l2_normalize_np(feats)
    np.save(args.out, feats)
    with open(args.out + ".names.txt", "w") as fh:
        fh.write("\n".join(names) + "\n")
    print(f"wrote {args.out} {feats.shape} + {args.out}.names.txt")
    return feats, names


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="msml_torch embedding extraction")
    p.add_argument("--weight_folder", required=True)
    p.add_argument("--src", required=True,
                   help="folder of aligned face images (recursed)")
    p.add_argument("--out", default="embeddings.npy")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--flip", action="store_true", default=True,
                   help="flip-sum features (the eval protocols' default)")
    p.add_argument("--no-flip", dest="flip", action="store_false")
    p.add_argument("--l2-norm", action="store_true", default=True)
    p.add_argument("--raw", dest="l2_norm", action="store_false",
                   help="skip the final l2 normalization")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
