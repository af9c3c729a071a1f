"""IJB-B / IJB-C 1:1 template verification.

The port's own numpy copy of `msml_tpu/eval/ijb.py`. Parity target
`eval/qeval_ijbc.py`:
  * metadata readers (tid_mid.txt / template pair list) — qeval_ijbc.py:207-230
  * 5-pt (or 68->5) similarity-transform alignment to 112x112 —
    qeval_ijbc.py:145-163, with the numpy Umeyama (`umeyama`, the JAX
    package's `tools/native.py::_umeyama_np`; no native library)
  * optional RandomBlock occlusion injection with 10-repeat averaging —
    qeval_ijbc.py:166-179,536-546
  * flip-test: feature = concat(f(img), f(flip)) -> 1024-d, optionally summed
    halves (F2 add mode) — qeval_ijbc.py:189-197,484-491
  * detector-score weighting of image features — qeval_ijbc.py:496-502
  * media-then-template aggregation — image2template_feature
    (qeval_ijbc.py:303-337): images of the same media are mean-pooled, medias
    summed, templates l2-normalized
  * batched cosine scoring over template pairs — verification
    (qeval_ijbc.py:343-370)
  * TPR@FPR table at 1e-6..1e-1 — qeval_ijbc.py:556-596, on the port's own
    ROC curve (`eval/verification.py::roc_curve`, no sklearn); the AUC of
    the plotted curve is the trapezoid over it (sklearn's `auc`)
cv2, Pillow and matplotlib are imported inside the functions that use them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from msml_torch.eval.verification import l2_normalize_np, roc_curve

X_LABELS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)

ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)
"""The canonical 112x112 ArcFace 5-landmark template
(eval/preprocess/alignment.py arcface_src)."""


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Pure-numpy Umeyama (same math as skimage.transform.SimilarityTransform
    used at eval/preprocess/alignment.py:76-118): the 3x3 similarity that
    maps `src` (n, 2) onto `dst` (n, 2), float32."""
    n, dim = src.shape
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_d = src - src_mean
    dst_d = dst - dst_mean
    A = dst_d.T @ src_d / n
    d = np.ones(dim)
    if np.linalg.det(A) < 0:
        d[-1] = -1
    U, S, Vt = np.linalg.svd(A)
    rank = np.linalg.matrix_rank(A)
    T = np.eye(dim + 1)
    if rank == dim - 1:
        if np.linalg.det(U) * np.linalg.det(Vt) > 0:
            T[:dim, :dim] = U @ Vt
        else:
            s = d[-1]
            d[-1] = -1
            T[:dim, :dim] = U @ np.diag(d) @ Vt
            d[-1] = s
    else:
        T[:dim, :dim] = U @ np.diag(d) @ Vt
    scale = (S @ d) / src_d.var(0).sum()
    T[:dim, dim] = dst_mean - scale * (T[:dim, :dim] @ src_mean)
    T[:dim, :dim] *= scale
    return T.astype(np.float32)


def read_template_media_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """tid_mid.txt: <name> <template_id> <media_id> (qeval_ijbc.py:207-213)."""
    data = np.loadtxt(path, dtype=str)
    return data[:, 1].astype(int), data[:, 2].astype(int)


def read_template_pair_list(path: str):
    """pair list: <t1> <t2> <label> (qeval_ijbc.py:219-230)."""
    pairs = np.loadtxt(path, dtype=str)
    return (pairs[:, 0].astype(int), pairs[:, 1].astype(int),
            pairs[:, 2].astype(int))


def lmk68_to_5(landmark: np.ndarray) -> np.ndarray:
    """68-pt -> 5-pt (qeval_ijbc.py:149-156)."""
    out = np.zeros((5, 2), np.float32)
    out[0] = (landmark[36] + landmark[39]) / 2
    out[1] = (landmark[42] + landmark[45]) / 2
    out[2] = landmark[30]
    out[3] = landmark[48]
    out[4] = landmark[54]
    return out


def align_face(img_bgr: np.ndarray, landmark: np.ndarray,
               image_size: int = 112) -> np.ndarray:
    """similarity-transform alignment, BGR in -> RGB out
    (qeval_ijbc.py:157-164)."""
    import cv2

    lmk5 = lmk68_to_5(landmark) if landmark.shape[0] == 68 else landmark
    T = umeyama(lmk5.astype(np.float32), ARCFACE_DST * (image_size / 112.0))
    img = cv2.warpAffine(img_bgr, T[:2], (image_size, image_size),
                         borderValue=0.0)
    return img[:, :, ::-1]


def extract_ijb_features(images_rgb, extract_fn: Callable, batch_size: int,
                         occ_block=None,
                         rng: Optional[np.random.RandomState] = None
                         ) -> np.ndarray:
    """Per-image 2*D features: concat(f(img), f(flip)) with [-1,1] norm
    (qeval_ijbc.py:189-197). images_rgb: (N, 112, 112, 3) uint8-scale;
    extract_fn: (B, 112, 112, 3) float32 numpy -> (B, D)."""
    from PIL import Image

    n = len(images_rgb)
    feats = None
    for s in range(0, n, batch_size):
        chunk = np.asarray(images_rgb[s:s + batch_size], np.float32)
        if occ_block is not None:
            occd = []
            for i in range(chunk.shape[0]):
                pil = Image.fromarray(chunk[i].astype(np.uint8))
                occd.append(np.asarray(occ_block(pil, rng), np.float32))
            chunk = np.stack(occd)
        x = (chunk / 255.0 - 0.5) / 0.5
        f = np.asarray(extract_fn(x))
        ff = np.asarray(extract_fn(x[:, :, ::-1, :]))
        if feats is None:
            feats = np.zeros((n, 2 * f.shape[1]), np.float32)
        feats[s:s + batch_size] = np.concatenate([f, ff], axis=1)
    return feats


def prepare_image_feats(img_feats: np.ndarray, faceness: Optional[np.ndarray],
                        use_flip_test: bool = True, use_norm_score: bool = True,
                        use_detector_score: bool = True) -> np.ndarray:
    """qeval_ijbc.py:478-502 (F2 add mode for flip test)."""
    d = img_feats.shape[1] // 2
    feats = (img_feats[:, :d] + img_feats[:, d:]) if use_flip_test \
        else img_feats[:, :d]
    if not use_norm_score:
        feats = l2_normalize_np(feats)
    if use_detector_score and faceness is not None:
        feats = feats * faceness[:, None]
    return feats


def image2template_feature(img_feats: np.ndarray, templates: np.ndarray,
                           medias: np.ndarray):
    """qeval_ijbc.py:303-337."""
    unique_templates = np.unique(templates)
    template_feats = np.zeros((len(unique_templates), img_feats.shape[1]))
    for count, uqt in enumerate(unique_templates):
        (ind_t,) = np.where(templates == uqt)
        face_feats = img_feats[ind_t]
        face_medias = medias[ind_t]
        unique_medias, counts = np.unique(face_medias, return_counts=True)
        media_feats = []
        for u, ct in zip(unique_medias, counts):
            (ind_m,) = np.where(face_medias == u)
            if ct == 1:
                media_feats.append(face_feats[ind_m])
            else:  # same-video frames mean-pooled
                media_feats.append(face_feats[ind_m].mean(0, keepdims=True))
        template_feats[count] = np.concatenate(media_feats, 0).sum(0)
    return l2_normalize_np(template_feats), unique_templates


def verification_scores(template_norm_feats: np.ndarray,
                        unique_templates: np.ndarray, p1: np.ndarray,
                        p2: np.ndarray, batchsize: int = 100000) -> np.ndarray:
    """qeval_ijbc.py:343-370."""
    template2id = np.zeros(int(unique_templates.max()) + 1, dtype=int)
    template2id[unique_templates] = np.arange(len(unique_templates))
    score = np.zeros(len(p1))
    for s in range(0, len(p1), batchsize):
        e = min(s + batchsize, len(p1))
        f1 = template_norm_feats[template2id[p1[s:e]]]
        f2 = template_norm_feats[template2id[p2[s:e]]]
        score[s:e] = np.sum(f1 * f2, -1)
    return score


def tpr_at_fpr_table(label: np.ndarray, score: np.ndarray,
                     x_labels: Sequence[float] = X_LABELS):
    """qeval_ijbc.py:564-586: select the largest tpr at each target fpr."""
    fpr, tpr = roc_curve(np.asarray(label), np.asarray(score))
    fpr = np.flipud(fpr)
    tpr = np.flipud(tpr)
    row = {}
    for x in x_labels:
        idx = int(np.argmin(np.abs(fpr - x)))
        row[x] = float(tpr[idx])
    return row


def roc_auc(fpr: np.ndarray, tpr: np.ndarray) -> float:
    """The area under the curve by the trapezoid rule
    (`sklearn.metrics.auc`)."""
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def save_roc_artifacts(out_dir: str, target: str, label: np.ndarray,
                       score: np.ndarray, method: str = "msml_torch",
                       x_labels: Sequence[float] = X_LABELS):
    """Write the evaluation artifacts the reference produces
    (qeval_ijbc.py:544-596): the raw pair scores (`<target>_scores.npy`), a
    log-x ROC curve pdf (`<target>.pdf`, same axes: fpr 1e-6..0.1, tpr
    0.3..1.0), and a persisted `<target>_tpr_fpr.csv` of the TPR@FPR row.
    Returns the written paths. The scores and the csv are written before
    matplotlib is imported: without it they are there and the ImportError
    comes after them."""
    import csv
    import os

    os.makedirs(out_dir, exist_ok=True)
    t = target.lower()
    npy_path = os.path.join(out_dir, f"{t}_scores.npy")
    np.save(npy_path, score)
    table = tpr_at_fpr_table(label, score, x_labels)
    csv_path = os.path.join(out_dir, f"{t}_tpr_fpr.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["method"] + [str(x) for x in x_labels])
        w.writerow([f"{method}-{target}"]
                   + ["%.2f" % (table[x] * 100) for x in x_labels])

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fpr, tpr = roc_curve(np.asarray(label), np.asarray(score))
    area = roc_auc(fpr, tpr)
    fpr_f = np.flipud(fpr)
    tpr_f = np.flipud(tpr)  # largest tpr at equal fpr (qeval_ijbc.py:571-572)

    fig = plt.figure()
    plt.plot(fpr_f, tpr_f, lw=1,
             label="[%s (AUC = %0.4f %%)]" % (method, area * 100))
    plt.xlim([1e-6, 0.1])
    plt.ylim([0.3, 1.0])
    plt.grid(linestyle="--", linewidth=1)
    plt.xticks(list(x_labels))
    plt.yticks(np.linspace(0.3, 1.0, 8, endpoint=True))
    plt.xscale("log")
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.title("ROC on IJB")
    plt.legend(loc="lower right")
    pdf_path = os.path.join(out_dir, f"{t}.pdf")
    fig.savefig(pdf_path)
    plt.close(fig)
    return {"npy": npy_path, "csv": csv_path, "pdf": pdf_path}


def run_ijb_protocol(img_feats: np.ndarray, faceness: Optional[np.ndarray],
                     templates: np.ndarray, medias: np.ndarray,
                     p1: np.ndarray, p2: np.ndarray, label: np.ndarray,
                     compute_table: bool = True, **prepare_kw):
    """Full pipeline from per-image features to the TPR@FPR table.

    compute_table=False skips the ROC sweep (callers that average scores
    over occlusion repeats only need it once, on the averaged scores)."""
    feats = prepare_image_feats(img_feats, faceness, **prepare_kw)
    tfeats, uniq = image2template_feature(feats, templates, medias)
    score = verification_scores(tfeats, uniq, p1, p2)
    table = tpr_at_fpr_table(label, score) if compute_table else None
    return table, score
