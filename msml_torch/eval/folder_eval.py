"""Folder + pairs.txt verification (MFR2 / PKU-Masked-Face protocol) and the
eval input transform that `cli/serve.py` and `cli/embed.py` apply.

The port's own copy of `msml_tpu/eval/folder_eval.py` (`load_folder_pairs`,
`tensorize_folder_img`, `evaluate_folder`; parity target
`eval/qeval_folder.py:16-321`), on (H, W, 3) uint8 RGB arrays in place of
PIL images:
  * dataset: folder/<identity>/<img>, pairs.txt lines "<id> <i> <j>"
    (same) or "<id1> <i> <id2> <j>" (diff); images are 1-indexed
  * input transform: flip -> Resize(out_size) -> CenterCrop(out_size) ->
    /255 -> [-1, 1] (or the reference's gray mix, `/ 3.0` included)
  * metrics: cosine-distance ROC accuracy + TAR@FAR {1e-1, 1e-2, 1e-3}
    (`eval/occ_sweep.py::roc_acc_and_tarfar`, no sklearn)

PIL is imported only where the JAX package needs it: to resize an image
whose size differs from `out_size`, and to decode any format but binary
PPM, which `data/bin_loader.py` reads without it (the card's machine has no
PIL). `stat_params_flops` (XLA cost analysis) is not ported yet.
"""

from __future__ import annotations

import io
import os
from typing import Callable, List, Tuple

import numpy as np

from msml_torch.data.bin_loader import ppm_decode
from msml_torch.eval.occ_sweep import roc_acc_and_tarfar


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB: binary PPM by the port's
    reader, any other format by PIL (`Image.open(...).convert("RGB")`)."""
    if data[:2] == b"P6":
        return ppm_decode(data)
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def read_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())


def center_crop(img: np.ndarray, out_size) -> np.ndarray:
    """torchvision CenterCrop((h, w)) on (H, W, C), as PIL's `crop` in
    `msml_tpu/eval/occ_sweep.py::center_crop`: zeros where the box leaves
    the image."""
    h, w = img.shape[:2]
    th, tw = out_size[1], out_size[0]
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    out = np.zeros((th, tw) + img.shape[2:], img.dtype)
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + th, h), min(left + tw, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def load_folder_pairs(dataset_folder: str, pair_txt: str
                      ) -> Tuple[List[np.ndarray], np.ndarray]:
    """qeval_folder.py:39-75. Returns (interleaved pair images, labels with
    0 = same / 1 = diff)."""
    img_dict = {}
    for identity in sorted(os.listdir(dataset_folder)):
        d = os.path.join(dataset_folder, identity)
        if not os.path.isdir(d):
            continue
        img_dict[identity] = [read_image(os.path.join(d, f))
                              for f in sorted(os.listdir(d))]

    with open(pair_txt) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    labels = np.zeros(len(lines))
    img_pairs: List[np.ndarray] = []
    for idx, line in enumerate(lines):
        words = line.split(" ")
        if len(words) == 3:
            id1 = id2 = words[0]
            i1, i2 = words[1], words[2]
        else:
            id1, i1, id2, i2 = words[0], words[1], words[2], words[3]
        img_pairs.append(img_dict[id1][int(i1) - 1])  # 1-indexed
        img_pairs.append(img_dict[id2][int(i2) - 1])
        labels[idx] = len(words) - 3  # 0: same, 1: diff
    return img_pairs, labels


def tensorize_folder_img(img: np.ndarray, out_size=(112, 112),
                         use_norm: bool = True, is_gray: bool = False,
                         flip: bool = False) -> np.ndarray:
    """`_load_one_input` + the [-1,1] norm (qeval_folder.py:120-137,
    174-182), (H, W, 3) uint8 RGB -> HWC float32: flip -> Resize(out_size)
    (PIL bilinear to exactly (w, h), only if the size differs) ->
    CenterCrop(out_size) -> /255 -> [-1,1]."""
    if flip:
        img = img[:, ::-1]
    w, h = out_size[0], out_size[1]
    if img.shape[:2] != (h, w):
        from PIL import Image

        img = np.asarray(Image.fromarray(np.ascontiguousarray(img)).resize(
            (w, h), Image.BILINEAR))
    img = center_crop(img, out_size)
    a = np.asarray(img, np.float32) / 255.0
    if is_gray:
        a = ((0.2989 * a[..., 0] + 0.5870 * a[..., 1]
              + 0.1140 * a[..., 2]) / 3.0)[..., None]
    elif use_norm:
        a = (a - 0.5) / 0.5
    return a


def evaluate_folder(dataset_folder: str, pair_txt: str,
                    extract_fn: Callable, out_size=(112, 112),
                    batch_size: int = 16, use_norm: bool = True,
                    is_gray: bool = False, dim_feature: int = 512):
    """Full protocol -> (roc_acc, tar@far[3])."""
    imgs, labels = load_folder_pairs(dataset_folder, pair_txt)
    n = len(imgs)
    features = np.zeros((n, dim_feature))
    for flip in (False, True):
        arr = np.stack([tensorize_folder_img(img, out_size, use_norm,
                                             is_gray, flip)
                        for img in imgs])
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            features[s:e] += np.asarray(extract_fn(arr[s:e]))

    issame = [bool(l == 0) for l in labels]
    acc, tarfar = roc_acc_and_tarfar(features, issame)
    return acc, tarfar[:3]
