"""Generate IJB-style and folder+pairs eval fixtures from the procedural
identity renderer (`tools/make_synthetic_rec.py`) — NEW held-out views of
the SAME identities a model was trained on, so the full template/folder
protocols can be driven end to end against a trained checkpoint with
meaningful separability.

The port's own copy of `msml_tpu/tools/make_synthetic_eval_fixtures.py`:
the same files from the same seed and knobs. It downloads nothing; cv2
(the JPEG writer) is imported inside the functions that write.

IJB root layout (`eval/ijb.py`, `cli/eval_ijb.py` consume; reference
qeval_ijbc.py:553-596):
    {root}/loose_crop/<name>.jpg
    {root}/meta/ijbc_face_tid_mid.txt            name tid mid
    {root}/meta/ijbc_name_5pts_score.txt         name x1 y1 ... x5 y5 s
    {root}/meta/ijbc_template_pair_label.txt     t1 t2 label

5-point landmarks are derived from each identity's procedural geometry
(gen_identity_params: eye_dx/eye_y, mouth_w/mouth_y), so the similarity
crop is semantically aligned like a detector's output would be.

Folder layout (`eval/folder_eval.py`; reference qeval_folder.py:39-75):
    {folder}/<identity>/<k>.jpg  +  pairs.txt ("id i j" / "id1 i id2 j")

Usage:
    python -m msml_torch.tools.make_synthetic_eval_fixtures \
        --out synth_eval --ids 40 --seed 0 \
        --view-noise 55 --id-contrast 0.6 --id-alpha 0.25 --geo-jitter 0.8
(the conv_hard2 recipe's difficulty knobs; identities match when the
seed + knobs match the training rec's.)
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def identity_lmk5(p: dict, size: int) -> np.ndarray:
    """5-point landmarks (two eyes, nose, two mouth corners) from the
    procedural face geometry, in pixel coords."""
    cx = 0.5
    eye_l = (cx - p["eye_dx"], p["eye_y"])
    eye_r = (cx + p["eye_dx"], p["eye_y"])
    nose = (cx, (p["eye_y"] + p["mouth_y"]) / 2.0)
    m_l = (cx - p["mouth_w"] / 2.0, p["mouth_y"])
    m_r = (cx + p["mouth_w"] / 2.0, p["mouth_y"])
    return np.asarray([eye_l, eye_r, nose, m_l, m_r],
                      np.float32) * float(size)


def _render(cid, v, args):
    from msml_torch.tools.make_synthetic_rec import (gen_identity_params,
                                                   render_view)
    id_rng = np.random.RandomState(args.seed * 1_000_003 + cid)
    params = gen_identity_params(id_rng, args.size)
    # views beyond any per-id count ever used for training/val -> unseen
    view_rng = np.random.RandomState(
        (args.seed + 1) * 7_000_003 + cid * 1009 + 10_000 + v)
    img = render_view(params, view_rng, args.size,
                      view_noise=args.view_noise,
                      id_contrast=args.id_contrast,
                      id_alpha=args.id_alpha, geo_jitter=args.geo_jitter)
    return img, params


def write_ijb_root(args) -> str:
    import cv2
    root = os.path.join(args.out, "ijb")
    os.makedirs(os.path.join(root, "loose_crop"), exist_ok=True)
    os.makedirs(os.path.join(root, "meta"), exist_ok=True)
    rng = np.random.RandomState(args.seed + 77)
    tid_mid, lmk_lines = [], []
    per_template = args.per_template
    n_templates = args.ids * 2          # two templates per identity
    for cid in range(args.ids):
        for t in range(2):
            tid = cid * 2 + t
            for k in range(per_template):
                v = t * per_template + k
                img, params = _render(cid, v, args)
                name = f"i{cid}_t{t}_{k}.jpg"
                cv2.imwrite(os.path.join(root, "loose_crop", name),
                            img[:, :, ::-1])
                # one media id per image (still exercises media grouping)
                tid_mid.append(f"{name} {tid} {tid * per_template + k}")
                pts = identity_lmk5(params, args.size).reshape(-1)
                lmk_lines.append(
                    name + " " + " ".join("%.2f" % x for x in pts)
                    + " %.3f" % (0.8 + 0.2 * rng.rand()))
    pairs = []
    for cid in range(args.ids):                      # genuine pairs
        pairs.append(f"{cid * 2} {cid * 2 + 1} 1")
    for _ in range(args.ids * 3):                    # impostor pairs
        a, b = rng.randint(0, args.ids, 2)
        if a == b:
            continue
        pairs.append(f"{a * 2 + rng.randint(2)} {b * 2 + rng.randint(2)} 0")
    meta = os.path.join(root, "meta")
    with open(os.path.join(meta, "ijbc_face_tid_mid.txt"), "w") as f:
        f.write("\n".join(tid_mid) + "\n")
    with open(os.path.join(meta, "ijbc_name_5pts_score.txt"), "w") as f:
        f.write("\n".join(lmk_lines) + "\n")
    with open(os.path.join(meta, "ijbc_template_pair_label.txt"),
              "w") as f:
        f.write("\n".join(pairs) + "\n")
    print(f"ijb root: {root} ({n_templates} templates, "
          f"{len(pairs)} pairs)")
    return root


def write_folder(args) -> str:
    import cv2
    folder = os.path.join(args.out, "folder")
    rng = np.random.RandomState(args.seed + 99)
    per_id = args.per_folder_id
    for cid in range(args.ids):
        d = os.path.join(folder, f"id{cid:04d}")
        os.makedirs(d, exist_ok=True)
        for v in range(per_id):
            img, _ = _render(cid, 100 + v, args)
            cv2.imwrite(os.path.join(d, f"{v + 1}.jpg"), img[:, :, ::-1])
    lines = []
    for cid in range(args.ids):                      # same pairs
        i, j = rng.choice(per_id, 2, replace=False) + 1
        lines.append(f"id{cid:04d} {i} {j}")
    for _ in range(args.ids):                        # diff pairs
        a, b = rng.randint(0, args.ids, 2)
        if a == b:
            continue
        lines.append(f"id{a:04d} {rng.randint(per_id) + 1} "
                     f"id{b:04d} {rng.randint(per_id) + 1}")
    pair_txt = os.path.join(args.out, "folder_pairs.txt")
    with open(pair_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"folder: {folder} + {pair_txt} ({len(lines)} pairs)")
    return folder


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--ids", type=int, default=40)
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per-template", type=int, default=3)
    ap.add_argument("--per-folder-id", type=int, default=4)
    ap.add_argument("--view-noise", type=float, default=12.0)
    ap.add_argument("--id-contrast", type=float, default=1.0)
    ap.add_argument("--id-alpha", type=float, default=1.0)
    ap.add_argument("--geo-jitter", type=float, default=0.0)
    args = ap.parse_args(argv)
    write_ijb_root(args)
    write_folder(args)


if __name__ == "__main__":
    main()
