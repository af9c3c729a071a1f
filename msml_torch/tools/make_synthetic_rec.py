"""Generate an identity-structured synthetic face dataset (rec + val bin).

The port's own copy of `msml_tpu/tools/make_synthetic_rec.py`, writing the
same files from the same seed. Purpose: offline stand-in for
CASIA-WebFace-style training data (`datasets/load_dataset.py:21-139`
consumes `{root}/train.rec`; `eval/verification.py:201-236` consumes
`{root}/{name}.bin`) so that from-scratch convergence and steady-state
throughput can be measured at realistic id counts with zero egress. Each
identity is a procedural "face": an id-specific smooth color field (an
upsampled random low-res grid — cues spread across the whole image, so
random occlusion leaves some visible) composited with a face-like layout
whose geometry/colors are id-specific; each view applies shift /
brightness / contrast / noise jitter. The images are 112x112 JPEGs, one
record each, as in insightface's `faces_webface_112x112` rec.
``--view-noise`` and ``--id-contrast`` tune the task difficulty (higher
noise + lower contrast -> lower verification accuracy — the
non-saturated regime a convergence curve needs).

Usage:
    python -m msml_torch.tools.make_synthetic_rec --root synth100k \
        --ids 10000 --per-id 10 --val-pairs 1200
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def gen_identity_params(id_rng: np.random.RandomState, size: int,
                        grid: int = 6) -> dict:
    """Per-identity appearance: low-res color field + face geometry."""
    return {
        "field": id_rng.randint(40, 215, (grid, grid, 3)).astype(np.uint8),
        "skin": id_rng.randint(120, 230, (3,)).astype(np.float32),
        "eye_dx": id_rng.uniform(0.13, 0.20),
        "eye_y": id_rng.uniform(0.40, 0.50),
        "eye_r": id_rng.uniform(0.03, 0.06),
        "mouth_w": id_rng.uniform(0.10, 0.20),
        "mouth_y": id_rng.uniform(0.76, 0.86),
        "mouth_c": id_rng.randint(60, 200, (3,)).astype(np.float32),
        "face_rx": id_rng.uniform(0.30, 0.40),
        "face_ry": id_rng.uniform(0.40, 0.50),
    }


_COMMON_FIELD = None


def _common_field(size: int) -> np.ndarray:
    """A fixed field shared by ALL identities (seed independent of id):
    blending the id field toward it shrinks the identity signal without
    changing the image statistics — the difficulty dial for non-saturated
    verification curves."""
    global _COMMON_FIELD
    if _COMMON_FIELD is None or _COMMON_FIELD.shape[0] != size:
        import cv2
        base = np.random.RandomState(123456).randint(
            40, 215, (6, 6, 3)).astype(np.uint8)
        _COMMON_FIELD = cv2.resize(base, (size, size),
                                   interpolation=cv2.INTER_CUBIC
                                   ).astype(np.float32)
    return _COMMON_FIELD


def render_view(p: dict, view_rng: np.random.RandomState, size: int,
                view_noise: float = 12.0, id_contrast: float = 1.0,
                id_alpha: float = 1.0, geo_jitter: float = 0.0
                ) -> np.ndarray:
    """One jittered view of an identity -> (size, size, 3) uint8.

    ``id_alpha`` < 1 blends the id-specific color field toward a field
    common to all identities (subtler id cues); ``geo_jitter`` > 0 adds a
    per-view random rotation (+-geo_jitter*30 deg) and scale
    (1 +- geo_jitter*0.3) warp. Both raise task difficulty."""
    import cv2
    # id color field, upsampled smooth
    img = cv2.resize(p["field"], (size, size),
                     interpolation=cv2.INTER_CUBIC).astype(np.float32)
    if id_alpha < 1.0:
        img = id_alpha * img + (1.0 - id_alpha) * _common_field(size)
    img = 127.5 + (img - 127.5) * id_contrast
    # face layout on top (geometry jittered a little per view)
    dx = view_rng.randint(-size // 16, size // 16 + 1)
    dy = view_rng.randint(-size // 16, size // 16 + 1)
    cx, cy = size // 2 + dx, int(size * 0.55) + dy
    face = img.copy()
    cv2.ellipse(face, (cx, cy),
                (int(p["face_rx"] * size), int(p["face_ry"] * size)),
                0, 0, 360, p["skin"].tolist(), -1)
    img = 0.55 * img + 0.45 * face
    for sx in (-1, 1):
        ex = int(cx + sx * p["eye_dx"] * size)
        ey = int(cy + (p["eye_y"] - 0.55) * size)
        cv2.circle(img, (ex, ey), int(p["eye_r"] * size),
                   (245, 245, 245), -1)
        cv2.circle(img, (ex, ey), max(int(p["eye_r"] * size * 0.45), 1),
                   (30, 30, 30), -1)
    cv2.ellipse(img, (cx, int(cy + (p["mouth_y"] - 0.55) * size)),
                (int(p["mouth_w"] * size), max(int(0.03 * size), 1)),
                0, 0, 180, p["mouth_c"].tolist(), -1)
    # view jitter: geometric warp, then brightness/contrast + noise
    if geo_jitter > 0:
        ang = view_rng.uniform(-30.0, 30.0) * geo_jitter
        scale = 1.0 + view_rng.uniform(-0.3, 0.3) * geo_jitter
        M = cv2.getRotationMatrix2D((size / 2, size / 2), ang, scale)
        img = cv2.warpAffine(img, M, (size, size),
                             borderMode=cv2.BORDER_REFLECT)
    img = img * view_rng.uniform(0.82, 1.18) + view_rng.uniform(-18, 18)
    img = img + view_rng.randn(size, size, 3) * view_noise
    return np.clip(img, 0, 255).astype(np.uint8)


def write_dataset(root: str, ids: int = 1000, per_id: int = 20,
                  size: int = 112, val_pairs: int = 600,
                  val_holdout: int = 2, seed: int = 0,
                  view_noise: float = 12.0, id_contrast: float = 1.0,
                  id_alpha: float = 1.0, geo_jitter: float = 0.0,
                  quality: int = 80, val_name: str = "synth_val",
                  log_every: int = 20000) -> dict:
    """Write {root}/train.rec(.idx) with ids*(per_id - val_holdout) images
    and {root}/{val_name}.bin with val_pairs pairs drawn from the held-out
    views (half same-id, half diff-id). Returns a summary dict."""
    from msml_torch.data.recordio import (IRHeader, IndexedRecordIO,
                                          imencode, pack)
    os.makedirs(root, exist_ok=True)
    assert per_id > val_holdout >= 2 or val_pairs == 0
    n_train = ids * (per_id - val_holdout)
    w = IndexedRecordIO(os.path.join(root, "train.idx"),
                        os.path.join(root, "train.rec"), "w")
    w.write_idx(0, pack(IRHeader(2, [n_train + 1, ids], 1, 0), b""))
    key = 1
    holdout = {}  # id -> [jpeg bytes]
    for cid in range(ids):
        id_rng = np.random.RandomState(seed * 1_000_003 + cid)
        params = gen_identity_params(id_rng, size)
        for v in range(per_id):
            view_rng = np.random.RandomState(
                (seed + 1) * 7_000_003 + cid * 1009 + v)
            img = render_view(params, view_rng, size,
                              view_noise=view_noise,
                              id_contrast=id_contrast,
                              id_alpha=id_alpha, geo_jitter=geo_jitter)
            buf = imencode(img, quality)
            if v < per_id - val_holdout:
                w.write_idx(key, pack(IRHeader(0, float(cid), 0, 0), buf))
                key += 1
                if log_every and key % log_every == 0:
                    print(f"wrote {key} train images")
            else:
                holdout.setdefault(cid, []).append(bytes(buf))
    w.close()

    bin_path = ""
    if val_pairs:
        pair_rng = np.random.RandomState(seed + 77)
        bins, issame = [], []
        for i in range(val_pairs):
            if i % 2 == 0:  # same-id pair from held-out views
                cid = int(pair_rng.randint(ids))
                a, b = pair_rng.choice(len(holdout[cid]), 2, replace=False)
                bins += [holdout[cid][a], holdout[cid][b]]
                issame.append(True)
            else:
                c1, c2 = pair_rng.choice(ids, 2, replace=False)
                bins.append(holdout[int(c1)][
                    int(pair_rng.randint(val_holdout))])
                bins.append(holdout[int(c2)][
                    int(pair_rng.randint(val_holdout))])
                issame.append(False)
        bin_path = os.path.join(root, f"{val_name}.bin")
        with open(bin_path, "wb") as f:
            pickle.dump((bins, issame), f)

    summary = {"root": root, "ids": ids, "train_images": n_train,
               "val_pairs": val_pairs, "bin": bin_path, "size": size}
    print(summary)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--ids", type=int, default=1000)
    ap.add_argument("--per-id", type=int, default=20)
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--val-pairs", type=int, default=600)
    ap.add_argument("--val-holdout", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--view-noise", type=float, default=12.0)
    ap.add_argument("--id-contrast", type=float, default=1.0)
    ap.add_argument("--id-alpha", type=float, default=1.0,
                    help="<1 blends id cues toward a common field (harder)")
    ap.add_argument("--geo-jitter", type=float, default=0.0,
                    help=">0 adds per-view rotation/scale warps (harder)")
    ap.add_argument("--quality", type=int, default=80)
    ap.add_argument("--val-name", default="synth_val")
    a = ap.parse_args(argv)
    write_dataset(a.root, a.ids, a.per_id, a.size, a.val_pairs,
                  a.val_holdout, a.seed, a.view_noise, a.id_contrast,
                  a.id_alpha, a.geo_jitter, a.quality, a.val_name)


if __name__ == "__main__":
    main()
