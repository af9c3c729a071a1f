"""Write a reference `backbone.pth` from a folder the port trained.

Counterpart of `msml_tpu/tools/export_torch.py`: the weights of the
folder's latest `ckpt/<step>.pt` (or its `backbone.pth`), classification
head included, as the torch state dict the JAX package writes: float32
tensors with the reference's names, `num_batches_tracked` 0 and the
`features` scale 1.0, the frozen teacher as `frb.peer.*` and the FM
towers under the reference's names. The reference stack,
`msml_tpu.tools.import_torch.import_msml_checkpoint`, `load_weight_folder`
and `cli.test --weight` read it. A model with the recover decoder is
refused, as the JAX exporter refuses it (`msml_tpu/tools/
export_torch.py:235-238`).

Usage:
  python -m msml_torch.tools.export_torch --weight_folder out/arc18_msml_1 \
      --out backbone.pth
"""

from __future__ import annotations

import argparse


def main(args):
    import torch

    from msml_torch.core.weight_folder import read_state_dict, weights_path
    from msml_torch.tools.convert import (jax_from_state_dict,
                                          state_dict_from_jax)

    # through the flax trees and back: the JAX exporter's conventions
    params, stats = jax_from_state_dict(
        read_state_dict(weights_path(args.weight_folder)))
    if "decoder" in params["frb"]:
        raise NotImplementedError(
            "decoder export not implemented (the recover decoder is "
            "loss-inert in the reference and unused at eval)")
    sd = state_dict_from_jax(params, stats)
    torch.save(sd, args.out)
    print(f"wrote {len(sd)} tensors -> {args.out}")
    return args.out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="export an msml_torch weight folder to backbone.pth")
    p.add_argument("--weight_folder", required=True)
    p.add_argument("--out", default="backbone.pth")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
