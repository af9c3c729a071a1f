"""Export the eval forward as a portable `torch.export` artifact.

Counterpart of `msml_tpu/tools/export_serving.py`, with `torch.export` in
place of serialized StableHLO: the eval forward of a weight folder's model,
NHWC float32 images in (permuted to NCHW inside, as `make_eval_step` does)
and features out, with the weights in the program and, by default, a
symbolic batch dimension. The conv3x3 and PReLU kernels stay in the graph
as the custom ops `msml_torch::conv3x3_fwd` and `msml_torch::prelu_fwd`, so
the artifact runs the hand-written kernels on the card (their plain
versions on the CPU); the precision policy's autocast is folded into
explicit casts (`run_decompositions`), which `torch.export.load` reads
back. The program runs on the device it was exported on. `--quant int8`
exports the int8 post-training quantization (`core/quantize.py`): int8
weight constants, about a quarter of the float artifact's bytes, and the
int8 kernels as the custom ops `msml_torch::quant_act` and
`msml_torch::qconv_int8`; its sidecar says `"quant": "int8"`.

Usage:
  python -m msml_torch.tools.export_serving --weight_folder out/arc18_1 \\
      --out model.pt2 [--batch b] [--device cpu]   # b symbolic by default
      [--quant int8]

Load side (`msml_torch.cli.serve --artifact model.pt2` does this):
  import msml_torch.kernels              # registers the custom ops
  fn = torch.export.load("model.pt2").module()
  feats = fn(images_nhwc_f32)            # (B, 112, 112, 3) -> (B, 512)
"""

from __future__ import annotations

import argparse
import json
import os

import torch


class EvalForward(torch.nn.Module):
    """(B, H, W, C) float32 images -> (B, dim_feature) float32 features of
    `model`'s eval forward. The model stays in the mode it is in."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img.permute(0, 3, 1, 2).contiguous())[0]


def export_eval_fn(model: torch.nn.Module, input_shape, batch=None,
                   quant: str = "") -> torch.export.ExportedProgram:
    """The eval forward of `model` (in eval mode) as an ExportedProgram on
    its parameters' device. batch=None -> symbolic batch dimension;
    quant="int8" exports its int8 quantization (`core/quantize.py`)."""
    device = next(model.parameters()).device
    example = torch.zeros((2 if batch is None else int(batch),)
                          + tuple(input_shape), device=device)
    dynamic = (None if batch is not None
               else {"img": {0: torch.export.Dim("batch")}})
    if quant:
        from msml_torch.core.quantize import quantize_eval_model
        model = quantize_eval_model(model, input_shape, quant)
    forward = EvalForward(model)
    with torch.no_grad():
        program = torch.export.export(forward, (example,),
                                      dynamic_shapes=dynamic)
    # autocast regions are higher-order ops that torch.export.load does not
    # read back; decomposing folds them into casts and keeps the custom ops
    return program.run_decompositions({})


def main(args):
    from msml_torch import resolve_device
    from msml_torch.core.weight_folder import load_weight_folder

    device = resolve_device(args.device)
    cfg, model = load_weight_folder(args.weight_folder, device=device)
    h, w = cfg.out_size[1], cfg.out_size[0]
    c = 1 if cfg.get("is_gray") else 3
    program = export_eval_fn(model, (h, w, c),
                             batch=args.batch if args.batch > 0 else None,
                             quant=args.quant)
    torch.export.save(program, args.out)
    # sidecar metadata so `serve --artifact` can preprocess without the
    # weight folder (input geometry + eval-transform switches)
    meta = {"input_hwc": [h, w, c],
            "use_norm": bool(cfg.get("use_norm", True)),
            "network": str(cfg.frb_type), "dim": int(cfg.dim_feature),
            "batch": args.batch if args.batch > 0 else "symbolic",
            **({"quant": args.quant} if args.quant else {})}
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {os.path.getsize(args.out)} bytes -> {args.out} (+ .json) "
          f"(input ({'b' if args.batch <= 0 else args.batch}, {h}, {w}, {c})"
          f" on {device})")
    return program


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="export the eval forward with torch.export")
    p.add_argument("--weight_folder", required=True)
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--batch", type=int, default=0,
                   help="fixed batch size; <=0 exports a symbolic batch dim")
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="post-training int8 quantization of the exported "
                        "forward (core/quantize.py)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the artifact runs on")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
