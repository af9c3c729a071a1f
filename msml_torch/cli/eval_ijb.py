"""IJB-B / IJB-C 1:1 verification entry point.

Counterpart of `msml_tpu/cli/eval_ijb.py` (reference `eval/qeval_ijbc.py`,
argparse at qeval_ijbc.py:41-52): reads the IJB meta files, aligns crops
from the landmark list, extracts flip-concat features with the weight
folder's eval forward on the device, with optional occlusion injection
(10-repeat averaged), aggregates media -> template, scores pairs, prints
the TPR@FPR table and writes the ROC artifacts (`eval/ijb.py`).

Expected layout (the standard insightface IJB release):
  <ijb-root>/meta/<target>_face_tid_mid.txt
  <ijb-root>/meta/<target>_template_pair_label.txt
  <ijb-root>/meta/<target>_name_5pts_score.txt   (img name, 10 lmk, score)
  <ijb-root>/loose_crop/<img files>
(`python -m msml_torch.tools.make_synthetic_eval_fixtures` writes one.)

Usage:
  python -m msml_torch.cli.eval_ijb --weight_folder out/arc18_msml_1 \\
      --ijb-root IJB --target IJBC [--lo 40 --hi 41] [--device cpu]

The weight folder is one `core/weight_folder.py` reads. The crops are RGB
112 x 112, as in the JAX package; a folder whose config is gray or of
another input size is refused here (the JAX package fails deep inside).
Runs on `cuda` unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

IJB_SIZE = (112, 112)  # the aligned crops' (w, h)


class AlignedCrops:
    """Lazy aligned-crop source: loads + aligns per requested batch, like
    the reference's streaming dataloader (`qeval_ijbc.py:242-301`).
    Materialising all crops as f32 would be ~70 GB for IJB-C's 469k
    images; this keeps only one batch resident. Supports len() and slice
    indexing — exactly what `extract_ijb_features` consumes."""

    def __init__(self, root: str, names, lmks):
        self.root, self.names, self.lmks = root, names, lmks

    def __len__(self):
        return len(self.names)

    def __getitem__(self, sl):
        import cv2

        from msml_torch.eval.ijb import align_face

        idxs = (range(*sl.indices(len(self.names)))
                if isinstance(sl, slice) else [sl])
        out = np.zeros((len(idxs), 112, 112, 3), np.float32)
        for j, i in enumerate(idxs):
            path = os.path.join(self.root, self.names[i])
            img = cv2.imread(path)
            if img is None:
                raise FileNotFoundError(f"unreadable IJB crop: {path}")
            out[j] = align_face(img, self.lmks[i])
        return out if isinstance(sl, slice) else out[0]


def load_name_lmk_score(path: str):
    names, lmks, scores = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 12:
                continue
            names.append(parts[0])
            lmks.append(np.asarray(list(map(float, parts[1:11])),
                                   np.float32).reshape(5, 2))
            scores.append(float(parts[-1]))
    return names, lmks, np.asarray(scores, np.float32)


def main(args):
    from msml_torch import resolve_device
    from msml_torch.cli.serve import numpy_forward
    from msml_torch.core.weight_folder import (folder_config,
                                               load_weight_folder)
    from msml_torch.data.rand_occ import RandomBlock
    from msml_torch.eval.ijb import (extract_ijb_features,
                                     read_template_media_list,
                                     read_template_pair_list,
                                     run_ijb_protocol, save_roc_artifacts,
                                     tpr_at_fpr_table)
    from msml_torch.tools.export_serving import EvalForward

    device = resolve_device(args.device)
    cfg = folder_config(args.weight_folder)
    if cfg.get("is_gray", False) or tuple(cfg.out_size) != IJB_SIZE:
        raise SystemExit(
            f"cli.eval_ijb evaluates RGB {IJB_SIZE[0]}x{IJB_SIZE[1]} crops; "
            f"{args.weight_folder} holds a model of "
            f"{'gray' if cfg.get('is_gray', False) else 'RGB'} "
            f"{cfg.out_size[0]}x{cfg.out_size[1]} input")
    _, model = load_weight_folder(args.weight_folder, device=device)
    extract_fn = numpy_forward(EvalForward(model), device)

    meta = os.path.join(args.ijb_root, "meta")
    t = args.target.lower()
    templates, medias = read_template_media_list(
        os.path.join(meta, f"{t}_face_tid_mid.txt"))
    p1, p2, label = read_template_pair_list(
        os.path.join(meta, f"{t}_template_pair_label.txt"))
    names, lmks, faceness = load_name_lmk_score(
        os.path.join(meta, f"{t}_name_5pts_score.txt"))

    # lazy load+align per batch (streamed like the reference dataloader);
    # one batch resident instead of ~70 GB of f32 crops for IJB-C
    imgs = AlignedCrops(os.path.join(args.ijb_root, "loose_crop"),
                        names, lmks)

    occ = RandomBlock(args.lo, args.hi) if args.hi > 1 else None
    # qeval_ijbc.py:536-546: repeats only when an occlusion range is set
    repeats = 10 if (args.lo > 0 and args.hi > 1) else 1
    rng_np = np.random.RandomState(0)
    score = None
    for _ in range(repeats):
        feats = extract_ijb_features(imgs, extract_fn, args.batch_size,
                                     occ_block=occ, rng=rng_np)
        _, s = run_ijb_protocol(
            feats, faceness, templates, medias, p1, p2, label,
            compute_table=False,  # computed once below on averaged scores
            use_detector_score=not args.no_detector_score)
        score = s if score is None else score + s
    score /= repeats

    table = tpr_at_fpr_table(label, score)
    print(f"TPR@FPR ({args.target}):")
    for fpr, tpr in table.items():
        print(f"  {fpr:g}: {tpr * 100:.2f}%")
    # write the requested JSON before the plotting artifacts so a missing
    # matplotlib degrades gracefully instead of eating the output
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({str(k): v for k, v in table.items()}, f, indent=2)
    # ROC pdf + csv + raw scores next to the weights (qeval_ijbc.py:544-596)
    art_dir = args.artifact_dir or args.weight_folder
    try:
        paths = save_roc_artifacts(art_dir, args.target, label, score)
        print("artifacts:", ", ".join(paths.values()))
    except ImportError as e:  # matplotlib is optional at runtime
        print(f"warning: ROC artifacts skipped ({e})")
    return table


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="msml_torch IJB-B/C eval")
    p.add_argument("--weight_folder", required=True)
    p.add_argument("--ijb-root", required=True)
    p.add_argument("--target", default="IJBC", choices=["IJBB", "IJBC"])
    p.add_argument("--lo", type=int, default=0)
    p.add_argument("--hi", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--no-detector-score", action="store_true")
    p.add_argument("--out-json", default="")
    p.add_argument("--artifact-dir", default="",
                   help="where to write the ROC pdf/csv/scores "
                        "(default: the weight folder)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
