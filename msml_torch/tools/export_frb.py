"""Export the FRB trunk of a folder the port trained as a standalone `.npz`.

Counterpart of `msml_tpu/tools/export_frb.py` (parity target
`backbones/peer/save_msml_to_iresnet.py`): the `frb` weights of an MSML
checkpoint, without the FM operators and the head, for a frozen peer or a
`pretrained_backbone`. The file holds the flax trees under the JAX
package's keys, `params/<path>` and `batch_stats/<path>`, so
`msml_tpu.tools.export_frb.load_npz` reads what this writes, and this
`load_npz` reads what that package writes. numpy only on the `.npz` side.

Usage:
  python -m msml_torch.tools.export_frb --weight_folder out/arc18_msml_1 \
      --out out/arc18_msml_1/frb.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from msml_torch.tools.convert import flatten, unflatten


def extract_frb(params: dict, batch_stats: dict):
    """The frb subtree (the FM operators and the head are MSML's own and
    not part of a vanilla peer, as in save_msml_to_iresnet)."""
    if "frb" not in params:
        raise KeyError("no 'frb' subtree in checkpoint params")
    return params["frb"], batch_stats.get("frb", {})


def save_npz(path: str, params: dict, batch_stats: dict) -> None:
    flat = {}
    for prefix, tree in (("params", params), ("batch_stats", batch_stats)):
        flat.update({k: np.asarray(v) for k, v in flatten(tree,
                                                          prefix).items()})
    np.savez(path, **flat)


def load_npz(path: str):
    """-> (params, batch_stats) trees of the file."""
    data = np.load(path)
    flat = {"params": {}, "batch_stats": {}}
    for key in data.files:
        prefix, rest = key.split("/", 1)
        flat["params" if prefix == "params" else "batch_stats"][rest] = \
            data[key]
    return unflatten(flat["params"]), unflatten(flat["batch_stats"])


def main(args):
    from msml_torch.core.weight_folder import read_state_dict, weights_path
    from msml_torch.tools.convert import jax_from_state_dict

    params, stats = jax_from_state_dict(
        read_state_dict(weights_path(args.weight_folder)))
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_npz(out, *extract_frb(params, stats))
    print("exported frb to", out)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="export the FRB of an msml_torch weight folder as .npz")
    p.add_argument("--weight_folder", required=True)
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
