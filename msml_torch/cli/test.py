"""Evaluation entry point: the on-device occlusion sweep on the card.

Counterpart of `msml_tpu/cli/test.py`'s `--device-sweep` path (reference
`test.py` -> `eval/qeval_mxnet.py`):

    python -m msml_torch.cli.test --device-sweep --weight_folder out/arc18_1 \
        --dataset lfw --fill_type black [--no-occ] [--device cpu]

Loads `config.yaml` and the weights from the weight folder (the latest
checkpoint that `msml_torch.cli.train` wrote there, or else `backbone.pth`:
`core/weight_folder.py`), loads `{rec}/{dataset}.bin` (or `--bin`), and
runs the protocol-BB sweep with
block occlusion + normalize fused in the port's kernel. Runs on `cuda`
unless `--device cpu` is given. The host sweep, protocol NB, `--vis`,
`--quant` and the baseline networks are not ported yet.
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
        ("the host sweep (run with --device-sweep)", not args.device_sweep),
        ("protocol " + args.protocol, args.protocol != "BB"),
        ("--vis", args.vis), ("--quant", bool(args.quant))) if on]
    if not_ported:
        raise SystemExit("not ported yet: " + ", ".join(not_ported))
    if not args.weight_folder:
        raise SystemExit("--weight_folder required for --network msml")

    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.data.bin_loader import load_bin
    from msml_torch.eval.occ_sweep_device import occlusion_sweep_device

    cfg, model = load_weight_folder(args.weight_folder, device=device)

    @torch.inference_mode()
    def extract_fn(img):
        return model(img)[0]

    bin_path = args.bin or os.path.join(cfg.rec, args.dataset + ".bin")
    data_list, issame = load_bin(bin_path, tuple(cfg.out_size))
    results = occlusion_sweep_device(
        data_list, issame, extract_fn, fill_type=args.fill_type,
        use_norm=bool(cfg.get("use_norm", True)),
        is_gray=bool(cfg.get("is_gray", False)), no_occ=args.no_occ,
        device=device)
    print("[protocol]: BB (device) [fill_type]", args.fill_type)
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
    p.add_argument("--dataset", type=str, default="lfw",
                   help="lfw, cfp_fp, agedb_30")
    p.add_argument("--weight_folder", type=str, default="",
                   help="folder with config.yaml and the checkpoints of "
                        "a training run, or backbone.pth")
    p.add_argument("--fill_type", type=str, default="black",
                   choices=["black", "white", "gauss"])
    p.add_argument("--no-occ", action="store_true")
    p.add_argument("--protocol", type=str, default="BB", choices=["BB", "NB"],
                   help="BB only so far")
    p.add_argument("--bin", type=str, default="",
                   help="explicit path to the .bin pair file")
    p.add_argument("--out-json", type=str, default="")
    p.add_argument("--quant", type=str, default="", choices=["", "int8"],
                   help="not ported yet")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--device-sweep", action="store_true",
                   help="run occlusion + normalize on the device "
                        "(the only sweep ported so far)")
    p.add_argument("--vis", action="store_true", help="not ported yet")
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
