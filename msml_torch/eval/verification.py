"""Pair-verification metrics: 10-fold KFold ROC with per-fold best threshold.

The port's own numpy copy of `msml_tpu/eval/verification.py`. Parity target
`eval/verification.py:41-199` (insightface-derived):
  * LFold — contiguous KFold splits, no shuffle (verification.py:41-51)
  * calculate_roc — per-fold best train threshold -> test accuracy
    (verification.py:54-107)
  * calculate_val — VAL/FAR@target with slinear threshold interpolation
    (verification.py:125-163)
  * evaluate — thresholds 0:4:0.01 for ROC, 0:4:0.001 for VAL@FAR=1e-3
    (verification.py:181-199)
  * the ROC's and VAL's loops over thresholds count every threshold of a
    fold at once, by sorting the fold's distances (`_below`): the loop's
    values bit for bit, and its ZeroDivisionError where it divides by
    zero, in a few ms where the loop took ~1 s a call at 40 pairs
  * roc_curve — `sklearn.metrics.roc_curve` in numpy, without sklearn,
    for the host sweep's and IJB's curves
  * test() — batched embedding extraction with orig + flip sum, the
    overlapping tail window (`_data = data[bb - batch_size: bb]`,
    verification.py:262, kept for parity), l2 normalize, xnorm
    (verification.py:238-305)
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


class LFold:
    """KFold(shuffle=False) contiguous splits; single split when n <= 1
    (verification.py:41-51)."""

    def __init__(self, n_splits: int = 2):
        self.n_splits = n_splits

    def split(self, indices: np.ndarray):
        n = len(indices)
        if self.n_splits <= 1:
            yield indices, indices
            return
        fold_sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        fold_sizes[: n % self.n_splits] += 1
        current = 0
        for fs in fold_sizes:
            test = indices[current:current + fs]
            train = np.concatenate([indices[:current], indices[current + fs:]])
            yield train, test
            current += fs


def _below(thresholds: np.ndarray, dist: np.ndarray,
           actual_issame: np.ndarray):
    """For every threshold t at once: the same pairs and the different pairs
    with dist < t, as verification.py's `calculate_accuracy` and
    `calculate_val_far` count them one t at a time (np.less, in the dtype
    it computes in), by sorting the distances; -> (same below (T,),
    different below (T,), same pairs, different pairs)."""
    same = np.asarray(actual_issame, bool)
    dtype = np.result_type(dist, thresholds[0])
    d = np.asarray(dist).astype(dtype)
    t = np.asarray(thresholds).astype(dtype)
    return (np.searchsorted(np.sort(d[same]), t, side="left"),
            np.searchsorted(np.sort(d[~same]), t, side="left"),
            int(same.sum()), int((~same).sum()))


def _accuracy_curve(thresholds: np.ndarray, dist: np.ndarray,
                   actual_issame: np.ndarray):
    """verification.py:110-122 (`calculate_accuracy`) at every threshold:
    (tpr, fpr, acc) arrays."""
    if dist.size == 0:  # as calculate_accuracy divides by it
        raise ZeroDivisionError("float division by zero")
    tp, fp, n_same, n_diff = _below(thresholds, dist, actual_issame)
    fn, tn = n_same - tp, n_diff - fp
    tpr = np.where(tp + fn == 0, 0.0, tp / np.maximum(tp + fn, 1))
    fpr = np.where(fp + tn == 0, 0.0, fp / np.maximum(fp + tn, 1))
    return tpr, fpr, (tp + tn) / dist.size


def calculate_roc(thresholds: np.ndarray, embeddings1: np.ndarray,
                  embeddings2: np.ndarray, actual_issame: np.ndarray,
                  nrof_folds: int = 10):
    """verification.py:54-107 (pca path omitted; unused by the protocols),
    every threshold of a fold at once (`_accuracy_curve`)."""
    if embeddings1.shape != embeddings2.shape:
        raise ValueError("embedding sets differ in shape")
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    nrof_thresholds = len(thresholds)
    k_fold = LFold(n_splits=nrof_folds)

    tprs = np.zeros((nrof_folds, nrof_thresholds))
    fprs = np.zeros((nrof_folds, nrof_thresholds))
    accuracy = np.zeros(nrof_folds)
    indices = np.arange(nrof_pairs)

    diff = np.subtract(embeddings1, embeddings2)
    dist = np.sum(np.square(diff), 1)

    for fold_idx, (train_set, test_set) in enumerate(k_fold.split(indices)):
        _, _, acc_train = _accuracy_curve(thresholds, dist[train_set],
                                         actual_issame[train_set])
        best = np.argmax(acc_train)
        tprs[fold_idx], fprs[fold_idx], acc_test = _accuracy_curve(
            thresholds, dist[test_set], actual_issame[test_set])
        accuracy[fold_idx] = acc_test[best]

    return np.mean(tprs, 0), np.mean(fprs, 0), accuracy


def calculate_val_far(threshold: float, dist: np.ndarray,
                      actual_issame: np.ndarray):
    """verification.py:166-178."""
    predict = np.less(dist, threshold)
    true_accept = np.sum(np.logical_and(predict, actual_issame))
    false_accept = np.sum(np.logical_and(predict,
                                         np.logical_not(actual_issame)))
    n_same = np.sum(actual_issame)
    n_diff = np.sum(np.logical_not(actual_issame))
    val = float(true_accept) / float(n_same)
    far = float(false_accept) / float(n_diff)
    return val, far


def calculate_val(thresholds: np.ndarray, embeddings1: np.ndarray,
                  embeddings2: np.ndarray, actual_issame: np.ndarray,
                  far_target: float, nrof_folds: int = 10):
    """verification.py:125-163. slinear interp == piecewise linear on the
    (sorted) far->threshold curve; the train set's FAR at every threshold
    at once (`_below`)."""
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    k_fold = LFold(n_splits=nrof_folds)
    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)
    diff = np.subtract(embeddings1, embeddings2)
    dist = np.sum(np.square(diff), 1)
    indices = np.arange(nrof_pairs)

    for fold_idx, (train_set, test_set) in enumerate(k_fold.split(indices)):
        _, false_accept, n_same, n_diff = _below(
            thresholds, dist[train_set], actual_issame[train_set])
        if not (n_same and n_diff):  # as calculate_val_far divides by them
            raise ZeroDivisionError("float division by zero")
        far_train = false_accept / float(n_diff)
        if np.max(far_train) >= far_target:
            order = np.argsort(far_train)
            threshold = float(np.interp(far_target, far_train[order],
                                        thresholds[order]))
        else:
            threshold = 0.0
        val[fold_idx], far[fold_idx] = calculate_val_far(
            threshold, dist[test_set], actual_issame[test_set])

    return np.mean(val), np.std(val), np.mean(far)


def evaluate(embeddings: np.ndarray, actual_issame: Sequence[bool],
             nrof_folds: int = 10):
    """verification.py:181-199."""
    thresholds = np.arange(0, 4, 0.01)
    embeddings1 = embeddings[0::2]
    embeddings2 = embeddings[1::2]
    tpr, fpr, accuracy = calculate_roc(thresholds, embeddings1, embeddings2,
                                       np.asarray(actual_issame),
                                       nrof_folds=nrof_folds)
    thresholds = np.arange(0, 4, 0.001)
    val, val_std, far = calculate_val(thresholds, embeddings1, embeddings2,
                                      np.asarray(actual_issame), 1e-3,
                                      nrof_folds=nrof_folds)
    return tpr, fpr, accuracy, val, val_std, far


def l2_normalize_np(x: np.ndarray) -> np.ndarray:
    """sklearn.preprocessing.normalize parity."""
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


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


def extract_embeddings(data_list: List[np.ndarray],
                       extract_fn: Callable[[np.ndarray], np.ndarray],
                       batch_size: int, is_gray: bool = False,
                       use_norm: bool = True) -> List[np.ndarray]:
    """Batched extraction with the reference's overlapping-tail-window idiom
    (verification.py:259-281). data_list: [orig, flipped] arrays
    (N, H, W, 3) in [0, 255]; extract_fn takes normalized float32 NHWC
    numpy batches and returns (batch, D) embeddings."""
    batch_size = min(batch_size, data_list[0].shape[0])  # tiny-set safety
    embeddings_list = []
    for data in data_list:
        if is_gray:
            gray = (0.2989 * data[..., 0] + 0.5870 * data[..., 1]
                    + 0.1140 * data[..., 2]) / 3.0  # verification.py:250-254
            data = gray[..., None]
        embeddings = None
        ba = 0
        n = data.shape[0]
        while ba < n:
            bb = min(ba + batch_size, n)
            count = bb - ba
            _data = data[bb - batch_size: bb]  # overlapping tail (quirk)
            if not is_gray and use_norm:
                img = ((_data / 255.0) - 0.5) / 0.5
            else:
                img = _data / 255.0
            _emb = np.asarray(extract_fn(img.astype(np.float32)))
            if embeddings is None:
                embeddings = np.zeros((n, _emb.shape[1]))
            embeddings[ba:bb, :] = _emb[(batch_size - count):, :]
            ba = bb
        embeddings_list.append(embeddings)
    return embeddings_list


def test(data_list: List[np.ndarray], issame_list: Sequence[bool],
         extract_fn: Callable[[np.ndarray], np.ndarray], batch_size: int,
         nfolds: int = 10, is_gray: bool = False, use_norm: bool = True):
    """verification.py:238-305: flip-sum features -> normalize -> evaluate.
    Returns (acc2, std2, xnorm, embeddings_list)."""
    embeddings_list = extract_embeddings(data_list, extract_fn, batch_size,
                                         is_gray, use_norm)
    _xnorm = float(np.mean([np.linalg.norm(e, axis=1).mean()
                            for e in embeddings_list]))
    embeddings = embeddings_list[0] + embeddings_list[1]
    embeddings = l2_normalize_np(embeddings)
    _, _, accuracy, val, val_std, far = evaluate(embeddings, issame_list,
                                                 nrof_folds=nfolds)
    return float(np.mean(accuracy)), float(np.std(accuracy)), _xnorm, \
        embeddings_list
