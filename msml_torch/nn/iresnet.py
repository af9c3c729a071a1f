"""iResNet (ArcFace-style ResNet) Face Recognition Branch, NCHW.

Counterpart of `msml_tpu/nn/iresnet.py`. Parity targets in the reference:
  * `IBasicBlock`      — `backbones/frb/iresnet.py:38-67`
  * `IResNet.forward`  — `backbones/frb/iresnet.py:190-236`: stride-1 3x3
    stem, four stride-2 stages with an FM-operator hook after each, bn2 ->
    flatten (C-major) -> fc -> BatchNorm1d `features`; fc and `features` run
    in float32 like the reference's `.float()` cast at iresnet.py:232
  * depth configs 18/34/50/100 — `backbones/frb/iresnet.py:444-481`

The recover decoder (`use_decoder`) and the peer teacher are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from msml_torch.core.precision import f32_region
from msml_torch.nn.common import (BatchNorm1d, PReLU, batch_norm, conv1x1,
                                  conv3x3)

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


class IResNet(nn.Module):
    """FRB iResNet with per-stage FM-operator hooks (`iresnet.py:70-236`).

    forward(x, segs) -> feature
      x    : (B, 3, 112, 112)
      segs : 4 OSB feature maps (B, 18, 56/28/14/7) or (None,) * 4
    """

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 dim_feature: int = 512, fm_ops: Sequence[nn.Module] = (),
                 width_mult: int = 1, use_decoder: bool = False):
        super().__init__()
        if len(fm_ops) != 4:
            raise ValueError("IResNet needs four FM operators")
        if use_decoder:
            raise NotImplementedError(
                "the recover decoder (use_decoder) is not ported yet")
        if not isinstance(width_mult, int):
            raise NotImplementedError(
                "only an integer width_mult is ported so far")
        planes = tuple(c * width_mult for c in (64, 128, 256, 512))
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
        # `features` scale is frozen at 1.0 (iresnet.py:119-120)
        self.features = BatchNorm1d(dim_feature, eps=1e-5)
        self.features.weight.requires_grad_(False)
        self.fm_ops = nn.ModuleList(fm_ops)

    def forward(self, x: torch.Tensor, segs) -> torch.Tensor:
        x = self.prelu(self.bn1(self.conv1(x)))
        stages = (self.layer1, self.layer2, self.layer3, self.layer4)
        for stage, fm_op, seg in zip(stages, self.fm_ops, segs):
            x = fm_op(stage(x), seg)
        x = self.bn2(x)
        x = torch.flatten(x, 1)  # C-major, as the reference (iresnet.py:230)
        with f32_region(x.device.type):
            return self.features(self.fc(x.float()))
