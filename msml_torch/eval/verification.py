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
"""

from __future__ import annotations

from typing import Sequence

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


def calculate_accuracy(threshold: float, dist: np.ndarray,
                       actual_issame: np.ndarray):
    """verification.py:110-122."""
    predict = np.less(dist, threshold)
    tp = np.sum(np.logical_and(predict, actual_issame))
    fp = np.sum(np.logical_and(predict, np.logical_not(actual_issame)))
    tn = np.sum(np.logical_and(np.logical_not(predict),
                               np.logical_not(actual_issame)))
    fn = np.sum(np.logical_and(np.logical_not(predict), actual_issame))
    tpr = 0 if (tp + fn == 0) else float(tp) / float(tp + fn)
    fpr = 0 if (fp + tn == 0) else float(fp) / float(fp + tn)
    acc = float(tp + tn) / dist.size
    return tpr, fpr, acc


def calculate_roc(thresholds: np.ndarray, embeddings1: np.ndarray,
                  embeddings2: np.ndarray, actual_issame: np.ndarray,
                  nrof_folds: int = 10):
    """verification.py:54-107 (pca path omitted; unused by the protocols)."""
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
        acc_train = np.array([
            calculate_accuracy(t, dist[train_set], actual_issame[train_set])[2]
            for t in thresholds])
        best = np.argmax(acc_train)
        for ti, t in enumerate(thresholds):
            tprs[fold_idx, ti], fprs[fold_idx, ti], _ = calculate_accuracy(
                t, dist[test_set], actual_issame[test_set])
        _, _, accuracy[fold_idx] = calculate_accuracy(
            thresholds[best], dist[test_set], actual_issame[test_set])

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
    (sorted) far->threshold curve."""
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    k_fold = LFold(n_splits=nrof_folds)
    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)
    diff = np.subtract(embeddings1, embeddings2)
    dist = np.sum(np.square(diff), 1)
    indices = np.arange(nrof_pairs)

    for fold_idx, (train_set, test_set) in enumerate(k_fold.split(indices)):
        far_train = np.array([
            calculate_val_far(t, dist[train_set], actual_issame[train_set])[1]
            for t in thresholds])
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
