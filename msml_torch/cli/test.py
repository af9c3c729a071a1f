"""Evaluation entry point: the occlusion sweep of a weight folder.

Counterpart of `msml_tpu/cli/test.py` (reference `test.py` ->
`eval/qeval_mxnet.py`) for `--network msml`:

    python -m msml_torch.cli.test --weight_folder out/arc18_msml_1 \
        --dataset lfw --fill_type black [--protocol NB] [--repeats 10] \
        [--batch-size 25] [--save-features DIR] [--weight backbone.pth] \
        [--no-occ] [--quant int8] [--device cpu]
    python -m msml_torch.cli.test --device-sweep --weight_folder ...

Loads `config.yaml` and the weights from the weight folder (the latest
checkpoint that `msml_torch.cli.train` wrote there, or else `backbone.pth`:
`core/weight_folder.py`; with `--weight`, that file instead) and
`{rec}/{dataset}.bin` (or `--bin`). By default it runs the reference's
host sweep (`eval/occ_sweep.py`): PIL decode, CenterCrop and `RandomBlock`
on the host, protocol BB or NB, `--repeats` per nonzero ratio, the model's
eval forward on the device in batches of `--batch-size`. `--device-sweep`
runs protocol BB with block occlusion + normalize fused in the port's
kernel (`eval/occ_sweep_device.py`), drawing its gauss fill differently
from PIL. `--quant int8` sweeps the int8 post-training quantization of
the model (`core/quantize.py`) on either path. Runs on `cuda` unless
`--device cpu` is given. The baseline networks and `--vis` are not ported
yet.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def main(args):
    from msml_torch import resolve_device

    device = resolve_device(args.device)
    not_ported = [name for name, on in (
        ("--network " + args.network, args.network != "msml"),
        ("--vis", args.vis)) if on]
    if not_ported:
        raise SystemExit("not ported yet: " + ", ".join(not_ported))
    if not args.weight_folder:
        raise SystemExit("--weight_folder required for --network msml")
    if args.device_sweep and args.protocol != "BB":
        raise SystemExit("--device-sweep supports protocol BB only; "
                         "use the host sweep for NB")

    from msml_torch.core.weight_folder import load_weight_folder

    cfg, model = load_weight_folder(args.weight_folder, device=device,
                                    weight=args.weight or None)
    if args.quant:
        from msml_torch.core.quantize import quantize_eval_model
        model = quantize_eval_model(model, (
            cfg.out_size[1], cfg.out_size[0],
            1 if cfg.get("is_gray", False) else 3), args.quant)
    bin_path = args.bin or os.path.join(cfg.rec, args.dataset + ".bin")
    use_norm = bool(cfg.get("use_norm", True))
    is_gray = bool(cfg.get("is_gray", False))
    if args.device_sweep:
        from msml_torch.data.bin_loader import load_bin
        from msml_torch.eval.occ_sweep_device import occlusion_sweep_device

        @torch.inference_mode()
        def extract_fn(img):
            return model(img)[0]

        data_list, issame = load_bin(bin_path, tuple(cfg.out_size))
        results = occlusion_sweep_device(
            data_list, issame, extract_fn, fill_type=args.fill_type,
            use_norm=use_norm, is_gray=is_gray, no_occ=args.no_occ,
            device=device)
        protocol = "BB (device)"
    else:
        from msml_torch.cli.serve import numpy_forward
        from msml_torch.data.bin_loader import load_bin_pil
        from msml_torch.eval.occ_sweep import occlusion_sweep
        from msml_torch.tools.export_serving import EvalForward

        imgs, issame = load_bin_pil(bin_path)
        results = occlusion_sweep(
            imgs, issame, numpy_forward(EvalForward(model), device),
            out_size=tuple(cfg.out_size), fill_type=args.fill_type,
            batch_size=args.batch_size, use_norm=use_norm, is_gray=is_gray,
            no_occ=args.no_occ, dim_feature=cfg.dim_feature,
            feature_dir=args.save_features, protocol=args.protocol,
            repeats=args.repeats)
        protocol = args.protocol
    print(f"[protocol]: {protocol} [fill_type]", args.fill_type)
    for row in results:
        print("[%d ~ %d] | [avg_acc]: %.4f" % (row["lo"], row["hi"],
                                               row["avg_acc"]))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="msml_torch testing")
    p.add_argument("--network", type=str, default="msml",
                   help="msml (the only network ported so far)")
    p.add_argument("--weight", type=str, default="",
                   help="a reference MSML backbone.pth (or a checkpoint) "
                        "evaluated with the weight folder's config.yaml")
    p.add_argument("--dataset", type=str, default="lfw",
                   help="lfw, cfp_fp, agedb_30")
    p.add_argument("--weight_folder", type=str, default="",
                   help="folder with config.yaml and the checkpoints of "
                        "a training run, or backbone.pth")
    p.add_argument("--fill_type", type=str, default="black",
                   choices=["black", "white", "gauss"])
    p.add_argument("--no-occ", action="store_true")
    p.add_argument("--protocol", type=str, default="BB",
                   choices=["BB", "NB"],
                   help="BB: occlude both pair images; NB: occlude only the "
                        "first (qeval_mxnet.py:173-187)")
    p.add_argument("--bin", type=str, default="",
                   help="explicit path to the .bin pair file")
    p.add_argument("--batch-size", type=int, default=25)
    p.add_argument("--repeats", type=int, default=10,
                   help="repeats per nonzero occlusion ratio "
                        "(reference: 10, qeval_mxnet.py:556)")
    p.add_argument("--out-json", type=str, default="")
    p.add_argument("--save-features", type=str, default="",
                   help="save flip-summed features per ratio/repeat as .npy "
                        "(qeval_mxnet.py:392-396 cache)")
    p.add_argument("--quant", type=str, default="", choices=["", "int8"],
                   help="post-training int8 quantization of the eval "
                        "forward (core/quantize.py); run against a "
                        "non-quantized baseline to bound accuracy impact")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--device-sweep", action="store_true",
                   help="run occlusion + normalize on the device "
                        "(eval/occ_sweep_device.py; protocol BB)")
    p.add_argument("--vis", action="store_true", help="not ported yet")
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
