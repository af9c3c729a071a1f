"""Load pretrained weights into a train state.

Counterpart of `msml_tpu/tools/load_weights.py` (parity target: the FRB
pretrained load of `backbones/frb/iresnet.py:410-442`: overlay the
pretrained trunk, keep the newly initialised layers).

Sources, by extension:
  * .npz from `tools/export_frb.py` of either package: the frb trunk only;
  * .pth / .pt / .tar: a reference MSML `backbone.pth`, one that
    `tools/export_torch.py` of either package wrote, or a `ckpt/<step>.pt`
    of `msml_torch.cli.train`; a vanilla iResNet state dict (no `frb.` or
    `osb.` key) is read as the frb trunk.

The overlay covers the key groups the JAX package merges, frb (the trunk),
fm_op0..3, osb and classification: in torch names `frb.*` with
`frb.fm_ops.*`, `osb.*` and `classification.*`. Parameters and BatchNorm
statistics are copied in place into the model's float32 tensors, so the
optimizer and its LR groups keep their references; keys the model lacks
are ignored, keys the source lacks keep their init, a shape mismatch
raises. `num_batches_tracked` and the frozen `features` scale (1.0) are
not copied. The log line counts the tensors as the JAX package does (its
flax parameter leaves: no statistics, no `features` scale).

Config keys read by `cli.train`: `pretrained_backbone`. `peer_weights`
needs the frozen peer teacher, which is not ported: the CLI refuses it.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from msml_torch.core.logging import LOGGER

STATS = ("running_mean", "running_var", "num_batches_tracked")
FEATURES_SCALE = "frb.features.weight"


def group(key: str) -> Optional[str]:
    """The JAX package's key group of a torch key, or None outside them
    (the peer and the decoder are not part of the backbone load)."""
    if key.startswith("frb.fm_ops."):
        return "fm_op" + key.split(".")[2]
    if key.startswith(("frb.peer.", "frb.decoder.")):
        return None
    head = key.split(".", 1)[0]
    return head if head in ("frb", "osb", "classification") else None


def load_source(path: str) -> Dict[str, torch.Tensor]:
    """The weights in `path` as a state dict with the port's names."""
    if path.endswith(".npz"):
        from msml_torch.tools.convert import state_dict_from_jax
        from msml_torch.tools.export_frb import load_npz

        p, s = load_npz(path)
        return state_dict_from_jax({"frb": p}, {"frb": s})
    if path.endswith((".pth", ".pt", ".tar")):
        from msml_torch.core.weight_folder import read_state_dict

        sd = read_state_dict(path)
        if not any(k.startswith(("frb.", "osb.")) for k in sd):
            # vanilla iresnet .pth: treat as an frb trunk
            sd = {"frb." + k: v for k, v in sd.items()}
        if FEATURES_SCALE in sd and not np.allclose(
                sd[FEATURES_SCALE].float().numpy(), 1.0, atol=1e-5):
            warnings.warn("features BN scale != 1.0 in checkpoint; "
                          "our head has use_scale=False — accuracy may "
                          "differ")
        return sd
    raise ValueError(f"unsupported weight file {path!r} (.npz or .pth)")


def overlay(model: torch.nn.Module, src: Dict[str, torch.Tensor]) -> int:
    """Copy the groups that both `src` and `model` have from `src` into
    `model` in place; -> the count the JAX package logs for them."""
    targets = model.state_dict()
    in_model = {group(k) for k in targets} - {None}
    loaded = 0
    for g in sorted({group(k) for k in src} & in_model):
        loaded += sum(1 for k in src if group(k) == g
                      and not k.endswith(STATS) and k != FEATURES_SCALE)
    with torch.no_grad():
        for key, dst in targets.items():
            if (group(key) not in in_model or key not in src
                    or key == FEATURES_SCALE
                    or key.endswith("num_batches_tracked")):
                continue
            value = torch.as_tensor(src[key])
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch at {key}: ckpt {tuple(value.shape)} "
                    f"vs model {tuple(dst.shape)}")
            dst.copy_(value)
    return loaded


def load_pretrained(state, cfg):
    """Overlay the configured `pretrained_backbone` onto `state.model` in
    place and return `state` (no-op without the key; warns when a
    'pretrained' recipe has no weights)."""
    logger = logging.getLogger(LOGGER)
    backbone_path = cfg.get("pretrained_backbone", "")
    peer_path = cfg.get("peer_weights", "")
    if not backbone_path and not peer_path:
        if cfg.get("pretrained"):
            logger.warning(
                "cfg.pretrained is set but no pretrained_backbone/"
                "peer_weights path given — training from scratch while the "
                "pretrained LR groups (train.py:152-178) are in effect")
        return state
    if peer_path:
        raise NotImplementedError(
            "peer_weights: the frozen peer teacher is not ported yet")
    if not os.path.exists(backbone_path):
        raise FileNotFoundError(backbone_path)
    loaded = overlay(state.model, load_source(backbone_path))
    logger.info("loaded %d pretrained backbone tensors from %s",
                loaded, backbone_path)
    return state
