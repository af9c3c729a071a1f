"""Load a self-describing weight folder (the reference's eval contract:
`config.yaml` next to the weights, `eval/qeval_mxnet.py:515-517`).

Counterpart of `msml_tpu/core/weight_folder.py` for the port: the folder
holds `config.yaml` and `backbone.pth` with the reference's torch names, the
file `python -m msml_tpu.tools.export_torch` writes. Orbax checkpoints need
JAX and are not read here.
"""

from __future__ import annotations

import os

import torch

from msml_torch import resolve_device
from msml_torch.core.config import config_init, load_yaml
from msml_torch.nn.msml import msml_from_config


def load_weight_folder(weight_folder: str, device="cuda"):
    """-> (cfg, model) with the weights of `backbone.pth`, in eval mode.

    The precision follows the folder's own config (`fp16: true` -> bf16
    compute). The classification head is dropped: eval never uses it
    (cli/test.py:60-72)."""
    dev = resolve_device(device)
    cfg = load_yaml(os.path.join(weight_folder, "config.yaml"))
    cfg.out_folder = os.path.dirname(weight_folder.rstrip("/")) or "out"
    config_init(cfg, make_output_dir=False)
    model = msml_from_config(cfg, device=dev)
    sd = torch.load(os.path.join(weight_folder, "backbone.pth"),
                    map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    sd = {k: v for k, v in sd.items() if not k.startswith("classification.")}
    model.load_state_dict(sd, strict=True)
    return cfg, model
