"""Evaluation entry point: the occlusion sweep of a weight folder or of a
baseline network.

Counterpart of `msml_tpu/cli/test.py` (reference `test.py` ->
`eval/qeval_mxnet.py`):

    python -m msml_torch.cli.test --weight_folder out/arc18_msml_1 \
        --dataset lfw --fill_type black [--protocol NB] [--repeats 10] \
        [--batch-size 25] [--save-features DIR] [--weight backbone.pth] \
        [--no-occ] [--quant int8] [--device cpu]
    python -m msml_torch.cli.test --device-sweep --weight_folder ...
    python -m msml_torch.cli.test --network cosface2018 \
        --weight sphere20.pth --bin lfw.bin [--device-sweep] [--quant int8]

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
`--device cpu` is given.

`--network` other than msml evaluates a baseline from a torch `.pth`
(`--weight`, a bare state dict or one under "state_dict", with the
reference's names), as the JAX package's `_build_baseline`
(`msml_tpu/cli/test.py:180-268`, reference `qeval_mxnet.py:106-171`):
`iresnet{18,34,50,100}[_v]` (the vanilla iResNet, `nn/iresnet.py::
PeerIResNet`, 112 x 112), `cosface2018` (Sphere-20, `nn/baselines.py`,
112 x 96) and `from2021` (`nn/from2021.py`, 112 x 96). A baseline runs in
float32 with cuDNN's and cuBLAS's TF32 off (`core/precision.py::no_tf32`:
JAX's FULL_PRECISION); its config is `dataset: synthetic`, RGB, `use_norm`
on, 512-d features and no `rec`, so `--bin` names the pairs. Its device
sweep center-crops the `.bin`'s square images to 112 x 96 on the host as
the host sweep's PIL CenterCrop does (the JAX package's `load_bin` is
handed (w, h) as (h, w) there and fails). `--vis`
(FM internals) is MSML-only and not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch


class BaselineEval(torch.nn.Module):
    """A baseline network's forward in the shape of MSML's eval forward,
    whose element 0 the sweeps, the serving wrapper and
    `quantize_eval_model` read: (B, 3, H, W) -> (feature,)."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor):
        return (self.net(x),)


def _build_baseline(args, device: torch.device):
    """--network other than msml -> (cfg, model): the network of
    `args.network` in float32, eval mode, on `device`, with the weights of
    `args.weight` loaded strict (`msml_tpu/cli/test.py:180-268`)."""
    from msml_torch.core.config import Config, config_init

    if not args.weight:
        raise SystemExit(f"--network {args.network} requires --weight .pth")
    sd = torch.load(args.weight, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out_size = [112, 112]  # (w, h) like qeval_mxnet's cfg.out_size
    if args.network.startswith("iresnet"):
        from msml_torch.nn.iresnet import IRESNET_LAYERS, PeerIResNet
        from msml_torch.tools.load_weights import warn_features_scale

        depth = args.network.replace("iresnet", "").replace("_v", "")
        net = PeerIResNet(layers=IRESNET_LAYERS[f"iresnet{depth}"])
        # the frozen features scale stays 1.0, as the JAX package's head
        # has none (import_iresnet_trunk)
        warn_features_scale(sd, "features.weight")
        sd = dict(sd, **{"features.weight": net.features.weight})
    elif args.network == "cosface2018":
        from msml_torch.nn.baselines import cosface2018

        net = cosface2018(input_size=(112, 96))
        out_size = [96, 112]  # (w, h), qeval_mxnet.py:508-510
    elif args.network == "from2021":
        from msml_torch.nn.from2021 import From2021

        net = From2021(input_size=(112, 96))
        out_size = [96, 112]
    else:
        raise SystemExit(f"unknown --network {args.network}")
    net.load_state_dict(sd, strict=True)
    # PeerIResNet's forward already gives (feature, stage features)
    model = (net if args.network.startswith("iresnet")
             else BaselineEval(net)).to(device).eval()
    cfg = Config.from_dict({
        "dataset": "synthetic", "fp16": False, "batch_size": 1,
        "frb_type": "iresnet18", "osb_type": "unet", "use_osb": False,
        "fm_layers": [0, 0, 0, 0], "fm_params": [3, 2, "sigmoid", "mul"],
        "header_type": "AMArcFace", "header_params": [64.0, 0.48, 0, 0],
        "exp_id": 0, "output_prefix": "baseline",
        "out_folder": "baseline_out"})
    config_init(cfg, make_output_dir=False)
    cfg.out_size = tuple(out_size)
    return cfg, model


def main(args):
    from msml_torch import resolve_device
    from msml_torch.core.precision import no_tf32

    device = resolve_device(args.device)
    if args.device_sweep and args.protocol != "BB":
        raise SystemExit("--device-sweep supports protocol BB only; "
                         "use the host sweep for NB")
    if args.network != "msml":
        cfg, model = _build_baseline(args, device)
        if args.vis:
            raise SystemExit("--vis is MSML-only (FM internals)")
        precision = no_tf32()
    else:
        if args.vis:
            raise SystemExit("not ported yet: --vis")
        if not args.weight_folder:
            raise SystemExit("--weight_folder required for --network msml")
        from msml_torch.core.weight_folder import load_weight_folder

        cfg, model = load_weight_folder(args.weight_folder, device=device,
                                        weight=args.weight or None)
        precision = contextlib.nullcontext()
    with precision:
        results, protocol = _sweep(args, cfg, model, device)
    print(f"[protocol]: {protocol} [fill_type]", args.fill_type)
    for row in results:
        print("[%d ~ %d] | [avg_acc]: %.4f" % (row["lo"], row["hi"],
                                               row["avg_acc"]))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


def _sweep(args, cfg, model, device):
    """-> (rows, protocol name) of the sweep `args` ask for."""
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

        w, h = cfg.out_size
        data_list, issame = load_bin(bin_path, (h, h))
        if w != h:  # 112 x 96: PIL CenterCrop's columns, as the host sweep
            left = int(round((h - w) / 2.0))
            crop = np.ascontiguousarray(data_list[0][:, :, left:left + w])
            data_list = [crop, crop[:, :, ::-1].copy()]
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
    return results, protocol


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="msml_torch testing")
    p.add_argument("--network", type=str, default="msml",
                   help="msml | iresnet18_v/34_v/50_v/100_v (vanilla "
                        "iResNet) | cosface2018 (Sphere-20, 112x96) | "
                        "from2021 (FROM, 112x96): a baseline from a torch "
                        ".pth via --weight, pairs via --bin")
    p.add_argument("--weight", type=str, default="",
                   help="torch .pth: for baseline networks, or (with "
                        "--network msml) a reference MSML backbone.pth (or "
                        "a checkpoint) evaluated with the weight folder's "
                        "config.yaml")
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
    p.add_argument("--vis", action="store_true",
                   help="FM-internals visualization (MSML only; not "
                        "ported yet)")
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
