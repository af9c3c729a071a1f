"""Occlusion-sweep metrics: ROC accuracy and TAR@FAR.

The port's own numpy copy of the metric half of `msml_tpu/eval/occ_sweep.py`
(`eval/qeval_mxnet.py:422-483`), with its own ROC curve in place of
`sklearn.metrics.roc_curve`. The host (PIL) sweep is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from msml_torch.eval.verification import l2_normalize_np

FAR_VALS = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)


def roc_curve(label: np.ndarray, score: np.ndarray):
    """`sklearn.metrics.roc_curve(label, score)` (pos_label 1,
    drop_intermediate=True) -> (fpr, tpr)."""
    order = np.argsort(-score, kind="stable")
    score, label = score[order], label[order].astype(np.float64)
    # indices where the (descending) score changes, plus the curve's end
    threshold_idxs = np.r_[np.nonzero(np.diff(score))[0], label.size - 1]
    tps = np.cumsum(label)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    if fps.shape[0] > 2:  # drop points collinear with their neighbours
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps = fps[keep], tps[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    return fps / fps[-1], tps / tps[-1]


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
