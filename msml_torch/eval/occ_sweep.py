"""The host occlusion sweep (the reference protocol of `cli.test`) and its
metrics, ROC accuracy and TAR@FAR.

The port's own copy of `msml_tpu/eval/occ_sweep.py`, with its own ROC
curve (`eval/verification.py::roc_curve`) in place of
`sklearn.metrics.roc_curve`. Parity target
`eval/qeval_mxnet.py:285-591`:
  * lo in {0, 10, ..., 90}, hi = lo + 1; `RandomBlock(lo, hi, fill_type)`
    after CenterCrop, on both images of a pair (protocol BB) or on the
    even-indexed one only (NB, qeval_mxnet.py:173-187);
  * 10 repeats per nonzero ratio, 1 for lo = 0 (:556);
  * features = model(orig) + model(flip), the occlusions drawn
    independently for the two passes (:295-390), from one RandomState in
    the order flip pass, image, block;
  * insightface's 10-fold accuracy (:565-567), and the ROC accuracy at
    tpr ~= 1 - fpr with TAR@FAR in {1e-1..1e-4} on cosine distances
    (:422-483), vectorised.
Pillow and `data/rand_occ.py` (which imports it) are imported inside the
sweep, so the device sweep and serving import neither.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence

import numpy as np

from msml_torch.eval import verification as ver
from msml_torch.eval.verification import l2_normalize_np, roc_curve

FAR_VALS = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)


def roc_acc_and_tarfar(features: np.ndarray, issame: Sequence[bool]):
    """qeval_mxnet.py:422-483 on l2-normalized features."""
    feats = l2_normalize_np(features)
    e1, e2 = feats[0::2], feats[1::2]
    # cosine distance per pair (scipy cdist 'cosine' parity)
    dist = 1.0 - np.sum(e1 * e2, axis=1)
    # ground truth: 0 = same, 1 = different (qeval_mxnet.py:549-553)
    label = np.array([0 if s else 1 for s in issame])

    fpr, tpr = roc_curve(label, dist)
    acc = tpr[np.argmin(np.abs(tpr - (1 - fpr)))]

    pos_dist = np.sort(dist[label == 0])  # same pairs
    neg_dist = np.sort(dist[label == 1])  # different pairs
    neg_cnt = len(neg_dist)
    pos_cnt = len(pos_dist)

    tarfar = np.zeros(len(FAR_VALS))
    for idx, far_target in enumerate(FAR_VALS):
        if idx > 3:  # reference skips 1e-5 (qeval_mxnet.py:457-459)
            continue
        # far(T) = #(neg < T)/neg_cnt; eligible thresholds T (drawn from the
        # negatives) with far(T) <= far_target; tar = max #(pos <= T)/pos_cnt
        far_of_T = np.searchsorted(neg_dist, neg_dist, side="left") / neg_cnt
        eligible = neg_dist[far_of_T <= far_target]
        if len(eligible) == 0:
            continue
        T = eligible.max()
        tarfar[idx] = np.searchsorted(pos_dist, T, side="right") / pos_cnt
    return float(acc), tarfar


def center_crop(img, out_size):
    """torchvision CenterCrop((h, w)) on a PIL image; out_size is (w, h)."""
    w, h = img.size
    th, tw = out_size[1], out_size[0]
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


def occlusion_sweep(imgs: List, issame: Sequence[bool],
                    extract_fn: Callable[[np.ndarray], np.ndarray],
                    out_size=(112, 112), fill_type: str = "black",
                    batch_size: int = 25, use_norm: bool = True,
                    is_gray: bool = False, no_occ: bool = False,
                    repeats: int = 10, rng: np.random.RandomState = None,
                    dim_feature: int = 512, verbose: bool = True,
                    feature_dir: str = "", protocol: str = "BB"):
    """The whole sweep over PIL images; -> a dict row per occlusion ratio
    (lo, hi, avg_acc, roc_acc, tar_at_far). extract_fn: (B, H, W, C)
    float32 numpy -> (B, dim_feature) features. feature_dir: save the
    flip-summed features per (ratio, repeat) as
    <dir>/feat_lo{lo}_rep{rep}.npy (qeval_mxnet.py:392-396)."""
    from msml_torch.data.rand_occ import RandomBlock

    if protocol not in ("BB", "NB"):
        raise ValueError(f"unknown protocol {protocol!r} (expected BB or NB)")
    if feature_dir:
        os.makedirs(feature_dir, exist_ok=True)
    lo_list = [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]
    hi_list = [1, 11, 21, 31, 41, 51, 61, 71, 81, 91]
    if no_occ:
        lo_list, hi_list = [0], [1]
    rng = rng or np.random.RandomState(0)

    results = []
    for lo, hi in zip(lo_list, hi_list):
        block = RandomBlock(lo, hi, fill=fill_type)
        repeat_time = 1 if lo == 0 else repeats
        avg_acc = 0.0
        avg_roc_acc = 0.0
        fars = np.zeros(len(FAR_VALS))
        for rep in range(repeat_time):
            feats = _extract_occluded(imgs, block, extract_fn, out_size,
                                      batch_size, use_norm, is_gray, rng,
                                      dim_feature, protocol)
            if feature_dir:
                np.save(f"{feature_dir}/feat_lo{lo}_rep{rep}.npy", feats)
            _, _, accuracy, _, _, _ = ver.evaluate(l2_normalize_np(feats),
                                                   issame)
            avg_acc += float(np.mean(accuracy))
            racc, tf = roc_acc_and_tarfar(feats, issame)
            avg_roc_acc += racc
            fars += tf
        row = {"lo": lo, "hi": hi, "avg_acc": avg_acc / repeat_time,
               "roc_acc": avg_roc_acc / repeat_time,
               "tar_at_far": (fars / repeat_time).tolist()}
        results.append(row)
        if verbose:
            print("[%d ~ %d] | [avg_acc]: %.4f" % (lo, hi, row["avg_acc"]))
            print("          | [tar@far]: %.4f, %.4f, %.4f, %.4f, %.4f"
                  % tuple(row["tar_at_far"]))
    return results


def _extract_occluded(imgs, block, extract_fn, out_size, batch_size,
                      use_norm, is_gray, rng, dim_feature, protocol="BB"):
    """Protocol 'BB': occlude every image; 'NB': the even indices only.
    -> (N, dim_feature) float64, the sum of the two passes' features."""
    from PIL import Image

    num = len(imgs)
    features = np.zeros((num, dim_feature))
    for flip in (False, True):
        arr = np.zeros((num,) + (out_size[1], out_size[0])
                       + ((1,) if is_gray else (3,)), np.float32)
        for i, img in enumerate(imgs):
            one = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT) if flip \
                else img
            one = center_crop(one, out_size)
            if is_gray and one.mode != "L":
                # torchvision Grayscale() (PIL's integer ITU-R 601-2) comes
                # BEFORE the block (qeval_mxnet.py:97-101), so RandomBlock
                # sees the 'L' image and a gauss fill draws one channel;
                # unlike the verification callback's luminance / 3
                one = one.convert("L")
            if protocol == "BB" or i % 2 == 0:
                one = block(one, rng)
            a = np.asarray(one, np.float32) / 255.0
            if is_gray:
                a = a[..., None]
            arr[i] = a
        if use_norm:
            # start_extract normalizes whenever cfg.use_norm, gray included
            # (qeval_mxnet.py:318-325)
            arr = (arr - 0.5) / 0.5
        for s in range(0, num, batch_size):
            e = min(s + batch_size, num)
            features[s:e] += np.asarray(extract_fn(arr[s:e]))
    return features
