"""Load pretrained weights into a train state.

Counterpart of `msml_tpu/tools/load_weights.py` (parity targets: the FRB
pretrained load of `backbones/frb/iresnet.py:410-442`: overlay the
pretrained trunk, keep the newly initialised layers; and the frozen peer
load of `backbones/peer/arcface.py:199-237`).

Sources, by extension, for either FRB (iResNet or LightCNN-29v2):
  * .npz from `tools/export_frb.py` of either package: the frb trunk only
    (with the recover decoder, which the JAX package keeps under `frb`);
  * .pth / .pt / .tar: a reference MSML `backbone.pth`, one that
    `tools/export_torch.py` of either package wrote, or a `ckpt/<step>.pt`
    of `msml_torch.cli.train`; a vanilla iResNet or LightCNN state dict
    (no `frb.` or `osb.` key) is read as the frb trunk. Their
    `frb.decoder.*` keys are dropped, as the JAX package's
    `import_msml_checkpoint` reads none.

`pretrained_backbone` covers the key groups the JAX package merges, frb
(the trunk and the decoder), fm_op0..3, osb and classification: in torch
names `frb.*` with `frb.fm_ops.*`, `osb.*` and `classification.*`.
`peer_weights` fills the frozen teacher `frb.peer.*` as JAX merges its
`peer` subtree: first from the source's frb group (`frb.X` ->
`frb.peer.X`), then from the source's own `frb.peer.*`. Parameters and
BatchNorm statistics are copied in place into the model's float32
tensors, so the optimizer and its LR groups keep their references; keys
the model lacks are ignored, keys the source lacks keep their init, a
shape mismatch raises. `num_batches_tracked` and the frozen `features`
scales (1.0) are not copied. The log lines count the tensors as the JAX
package does (the source's flax parameter leaves in the merged groups: no
statistics, no `features` scale).

Config keys read by `cli.train`: `pretrained_backbone`, `peer_weights`.
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
SCALE = ".features.weight"  # the frozen scale, of the frb and of the peer
PEER = "frb.peer."


def group(key: str) -> Optional[str]:
    """The JAX package's key group (its top-level subtree) of a torch key,
    or None outside them."""
    if key.startswith("frb.fm_ops."):
        return "fm_op" + key.split(".")[2]
    if key.startswith(PEER):
        return "peer"
    head = key.split(".", 1)[0]
    return head if head in ("frb", "osb", "classification") else None


def is_leaf(key: str) -> bool:
    """A key with a flax parameter leaf: no statistics, no `features`
    scale."""
    return not key.endswith(STATS + (SCALE,))


def warn_features_scale(sd: Dict[str, torch.Tensor],
                        key: str = FEATURES_SCALE) -> None:
    """Warn as the JAX package's importer does when the frozen `features`
    scale at `key` is not 1.0 (the port keeps it at 1.0)."""
    if key in sd and not np.allclose(
            torch.as_tensor(sd[key]).float().numpy(), 1.0, atol=1e-5):
        warnings.warn("features BN scale != 1.0 in checkpoint; "
                      "our head has use_scale=False — accuracy may "
                      "differ")


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
            # vanilla iresnet / lightcnn .pth: treat as an frb trunk
            sd = {"frb." + k: v for k, v in sd.items()}
        sd = {k: v for k, v in sd.items() if not k.startswith("frb.decoder.")}
        warn_features_scale(sd)
        return sd
    raise ValueError(f"unsupported weight file {path!r} (.npz or .pth)")


def _copy(model: torch.nn.Module, src: Dict[str, torch.Tensor],
          keys) -> None:
    """Copy `src[key]` into the model's tensor `key` in place for each of
    `keys` that both have (no `num_batches_tracked`, no `features` scale);
    a shape mismatch raises."""
    targets = model.state_dict()
    with torch.no_grad():
        for key in keys:
            dst = targets.get(key)
            if (dst is None or key not in src
                    or key.endswith((SCALE, "num_batches_tracked"))):
                continue
            value = torch.as_tensor(src[key])
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch at {key}: ckpt {tuple(value.shape)} "
                    f"vs model {tuple(dst.shape)}")
            dst.copy_(value)


def overlay(model: torch.nn.Module, src: Dict[str, torch.Tensor]) -> int:
    """Copy the backbone groups that both `src` and `model` have from `src`
    into `model` in place; -> the count the JAX package logs for them."""
    targets = model.state_dict()
    in_model = {group(k) for k in targets} - {None, "peer"}
    merged = {group(k) for k in src} & in_model
    _copy(model, src, [k for k in targets if group(k) in merged])
    return sum(1 for k in src if group(k) in merged and is_leaf(k))


def overlay_peer(model: torch.nn.Module,
                 src: Dict[str, torch.Tensor]) -> int:
    """Fill the model's frozen teacher from `src` in place, from the
    source's frb group and then its own peer (`msml_tpu/tools/
    load_weights.py:86-91`); -> the count the JAX package logs (0 for a
    model without a teacher)."""
    if not any(k.startswith(PEER) for k in model.state_dict()):
        return 0
    loaded = 0
    for g in ("frb", "peer"):
        part = {k if g == "peer" else PEER + k[4:]: v
                for k, v in src.items() if group(k) == g}
        _copy(model, part, list(part))
        loaded += sum(1 for k in part if is_leaf(k))
    return loaded


def load_pretrained(state, cfg):
    """Overlay the configured `pretrained_backbone` and `peer_weights` onto
    `state.model` in place and return `state` (no-op without the keys;
    warns when a 'pretrained' recipe has no weights)."""
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
    if backbone_path:
        if not os.path.exists(backbone_path):
            raise FileNotFoundError(backbone_path)
        loaded = overlay(state.model, load_source(backbone_path))
        logger.info("loaded %d pretrained backbone tensors from %s",
                    loaded, backbone_path)
    if peer_path:
        if not os.path.exists(peer_path):
            raise FileNotFoundError(peer_path)
        n = overlay_peer(state.model, load_source(peer_path))
        logger.info("loaded %d peer tensors from %s", n, peer_path)
    return state
