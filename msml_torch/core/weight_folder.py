"""Load a self-describing weight folder (the reference's eval contract:
`config.yaml` next to the weights, `eval/qeval_mxnet.py:515-517`).

Counterpart of `msml_tpu/core/weight_folder.py` for the port. The folder
holds `config.yaml` and either the checkpoints that `msml_torch.cli.train`
writes (`ckpt/<step>.pt`, the latest of which is restored, as the JAX
package restores its latest orbax checkpoint) or a `backbone.pth` with the
reference's torch names (the file `python -m msml_torch.tools.export_torch`
or `python -m msml_tpu.tools.export_torch` writes). Orbax checkpoints need
JAX and are not read here.
"""

from __future__ import annotations

import os

import torch

from msml_torch import resolve_device
from msml_torch.core import checkpoint
from msml_torch.core.config import config_init, load_yaml
from msml_torch.nn.msml import msml_from_config


def weights_path(weight_folder: str) -> str:
    """The file `load_weight_folder` reads: the latest `ckpt/<step>.pt`
    if there is one, else `backbone.pth`; FileNotFoundError naming both
    if neither is there."""
    step = checkpoint.latest_step(weight_folder)
    if step is not None:
        return checkpoint.checkpoint_path(weight_folder, step)
    path = os.path.join(weight_folder, "backbone.pth")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no weights in {weight_folder}: no checkpoint "
            f"{checkpoint.checkpoint_path(weight_folder, '<step>')} and no "
            f"{path}")
    return path


def read_state_dict(path: str) -> dict:
    """The torch state dict in `path`: a bare one, or the one under
    "state_dict" (a reference checkpoint) or "model" (a `ckpt/<step>.pt`
    of `msml_torch.cli.train`). Loaded with weights_only=True."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd:
            return sd[key]
    return sd


def folder_config(weight_folder: str):
    """The folder's `config.yaml`, derived (`config_init`) without making
    an output folder."""
    cfg = load_yaml(os.path.join(weight_folder, "config.yaml"))
    cfg.out_folder = os.path.dirname(weight_folder.rstrip("/")) or "out"
    return config_init(cfg, make_output_dir=False)


def load_weight_folder(weight_folder: str, device="cuda", weight=None):
    """-> (cfg, model) in eval mode, with the weights of `weights_path`:
    the `model` state dict of the latest training checkpoint, or else
    `backbone.pth` (a bare state dict or one under "state_dict"). With
    `weight`, a file of the same kinds, the folder supplies only
    `config.yaml` and the weights come from that file (`cli.test
    --weight`).

    The precision follows the folder's own config (`fp16: true` -> bf16
    compute). The classification head is dropped: eval never uses it
    (cli/test.py:60-72)."""
    dev = resolve_device(device)
    cfg = folder_config(weight_folder)
    path = weight or weights_path(weight_folder)
    model = msml_from_config(cfg, device=dev)
    sd = {k: v for k, v in read_state_dict(path).items()
          if not k.startswith("classification.")}
    model.load_state_dict(sd, strict=True)
    return cfg, model
