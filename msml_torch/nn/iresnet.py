"""iResNet (ArcFace-style ResNet) Face Recognition Branch, NCHW.

Counterpart of `msml_tpu/nn/iresnet.py`. Parity targets in the reference:
  * `IBasicBlock`      — `backbones/frb/iresnet.py:38-67`
  * `IResNet.forward`  — `backbones/frb/iresnet.py:190-236`: stride-1 3x3
    stem, four stride-2 stages with an FM-operator hook after each, bn2 ->
    flatten (C-major) -> fc -> BatchNorm1d `features`; fc and `features` run
    in float32 like the reference's `.float()` cast at iresnet.py:232
  * `IResNetVanilla`  — `backbones/frb/iresnet.py:241-363` /
    `backbones/peer/arcface.py`: `PeerIResNet`, the frozen teacher that
    returns the 4 stage features, held as `frb.peer` (the reference's torch
    names; the JAX package's `peer` subtree)
  * the recover decoder hook — `backbones/frb/iresnet.py:146-150,227-228`
    (`msml_tpu/nn/iresnet.py:163-172`): `frb.decoder` exists whenever
    `use_decoder`, and runs only when `decoder_loss_weight > 0` and `ori`
    is given
  * depth configs 18/34/50/100 — `backbones/frb/iresnet.py:444-481`
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from msml_torch.core.precision import f32_region
from msml_torch.nn.common import (BatchNorm1d, PReLU, batch_norm, conv1x1,
                                  conv3x3)
from msml_torch.nn.decoder import DeepMindDecoder

IRESNET_LAYERS = {
    "iresnet18": (2, 2, 2, 2),
    "iresnet34": (3, 4, 6, 3),
    "iresnet50": (3, 4, 14, 3),
    "iresnet100": (3, 13, 30, 3),
}


class IBasicBlock(nn.Module):
    """BN-first residual block (`iresnet.py:38-67`)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.bn1 = batch_norm(inplanes)
        self.conv1 = conv3x3(inplanes, planes)
        self.bn2 = batch_norm(planes)
        self.prelu = PReLU(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn3 = batch_norm(planes)
        self.downsample = (nn.Sequential(conv1x1(inplanes, planes, stride),
                                         batch_norm(planes))
                           if use_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(x)
        out = self.conv1(out)
        out = self.bn2(out)
        out = self.prelu(out)
        out = self.conv2(out)
        out = self.bn3(out)
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


class ResStage(nn.Sequential):
    """One `_make_layer` stage (`iresnet.py:164-188`): first block stride-2
    with downsample, the rest stride-1."""

    def __init__(self, inplanes: int, planes: int, blocks: int,
                 stride: int = 2):
        needs_down = stride != 1 or inplanes != planes
        super().__init__(
            IBasicBlock(inplanes, planes, stride, needs_down),
            *[IBasicBlock(planes, planes) for _ in range(1, blocks)])


class _Trunk(nn.Module):
    """The iResNet layers without hooks: the stride-1 3x3 stem, four
    stride-2 stages, `bn2`, the C-major flatten, `fc` and the BatchNorm1d
    `features` with its scale frozen at 1.0 (iresnet.py:119-120); fc and
    `features` run in float32 (iresnet.py:232)."""

    def __init__(self, layers: Sequence[int], dim_feature: int,
                 planes: Sequence[int]):
        super().__init__()
        self.conv1 = conv3x3(3, planes[0])
        self.bn1 = batch_norm(planes[0])
        self.prelu = PReLU(planes[0])
        inplanes = planes[0]
        for i in range(4):
            self.add_module(f"layer{i + 1}",
                            ResStage(inplanes, planes[i], layers[i], 2))
            inplanes = planes[i]
        self.bn2 = batch_norm(planes[3])
        self.fc = nn.Linear(planes[3] * 7 * 7, dim_feature)
        self.features = BatchNorm1d(dim_feature, eps=1e-5)
        self.features.weight.requires_grad_(False)

    def stages(self):
        return (self.layer1, self.layer2, self.layer3, self.layer4)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """bn2's output -> the (B, dim_feature) float32 feature."""
        x = torch.flatten(x, 1)  # C-major, as the reference (iresnet.py:230)
        with f32_region(x.device.type):
            return self.features(self.fc(x.float()))


class PeerIResNet(_Trunk):
    """The frozen teacher (`IResNetVanilla`, `backbones/peer/arcface.py`):
    forward(x) -> (feature, [4 stage features]), all without gradient.

    It stays in eval mode, BatchNorm on its running statistics, whatever
    mode its parent is put in (`train` is overridden), and its parameters
    do not require grad, so no optimizer or clip sees them
    (`msml_tpu/train/optim.py:39,77-83`)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 dim_feature: int = 512):
        super().__init__(layers, dim_feature, (64, 128, 256, 512))
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        return super().train(False)

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        x = self.prelu(self.bn1(self.conv1(x)))
        inters = []
        for stage in self.stages():
            x = stage(x)
            inters.append(x)
        return self.embed(self.bn2(x)), inters


class IResNet(_Trunk):
    """FRB iResNet with per-stage FM-operator hooks (`iresnet.py:70-236`).

    forward(x, segs, ori=None, losses=None) -> (feature, kd)
      x      : (B, 3, 112, 112)
      segs   : 4 OSB feature maps (B, 18, 56/28/14/7) or (None,) * 4
      ori    : the unoccluded images (B, 3, 112, 112), or None: with the
               peer teacher they give the FMs their teacher features, with
               the decoder and `decoder_loss_weight > 0` its target
      losses : a dict that receives the recover loss times
               `decoder_loss_weight` under 'rec' when the decoder runs
               (the JAX package's sown 'losses' collection)
    kd is the sum of the FMs' KD terms, 0.0 when none gave one."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 dim_feature: int = 512, fm_ops: Sequence[nn.Module] = (),
                 width_mult: int = 1, use_peer: bool = False,
                 use_decoder: bool = False,
                 decoder_loss_weight: float = 0.0):
        if len(fm_ops) != 4:
            raise ValueError("IResNet needs four FM operators")
        if not isinstance(width_mult, int):
            raise NotImplementedError(
                "only an integer width_mult is ported so far")
        super().__init__(layers, dim_feature,
                         tuple(c * width_mult for c in (64, 128, 256, 512)))
        self.fm_ops = nn.ModuleList(fm_ops)
        self.peer: Optional[PeerIResNet] = (
            PeerIResNet(layers, dim_feature) if use_peer else None)
        self.decoder: Optional[DeepMindDecoder] = (
            DeepMindDecoder(n_init=dim_feature) if use_decoder else None)
        self.decoder_loss_weight = float(decoder_loss_weight)

    def forward(self, x: torch.Tensor, segs,
                ori: Optional[torch.Tensor] = None,
                losses: Optional[dict] = None):
        peer_feats = (None,) * 4
        if ori is not None and self.peer is not None:
            _, peer_feats = self.peer(ori)  # iresnet.py:203-206
        x = self.prelu(self.bn1(self.conv1(x)))
        kd_losses = []
        for stage, fm_op, seg, yt in zip(self.stages(), self.fm_ops, segs,
                                         peer_feats):
            x, kd = fm_op(stage(x), seg, yt)
            if kd is not None:
                kd_losses.append(kd)
        x = self.bn2(x)
        if (self.decoder is not None and self.decoder_loss_weight > 0.0
                and ori is not None):
            _, rec = self.decoder(x, ori)
            if losses is not None:
                losses["rec"] = self.decoder_loss_weight * rec
        return self.embed(x), (sum(kd_losses) if kd_losses else 0.0)
