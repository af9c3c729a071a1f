"""FROM (TPAMI'21) occlusion-robust baseline: LResNet50E-IR + FPN mask, NCHW.

Counterpart of `msml_tpu/nn/from2021.py`. Parity target
`backbones/third_party/from2021.py`, with its torch names (the ones
`msml_tpu/tools/import_torch.py::import_from2021` reads):
  * `PyramidFeatures` FPN over stages 2-4 (from2021.py:4-49): `fpn.P5_1`
    ... `fpn.P7_2`, upsampling by 2 (nearest) then cropping to the skip
    branch
  * `BlockIR` (52-84): `bn1, conv1, bn2, prelu1, conv2, bn3,
    downsample.{0,1}` (iResNet's block names its PReLU `prelu`)
  * `LResNetOcc` (291-373): the LResNet50E-IR trunk (`conv1, bn1, prelu1,
    layer{n}.{b}`) on 112 x 96 input; the mask head `mask.{0..4}` (conv,
    PReLU, BN, conv, sigmoid) over FPN P3 -> a 512 x 7 x 6 mask; the
    mask-pattern regressor `regress.{0..3}` (BN1d, dropout, linear
    without bias, BN1d) over `get_grids(112, 96, 5)`'s 226 patterns
    (391-409); the fc head `fc.{0..3}` (BN1d, dropout, linear, BN1d),
    shared by the masked and the plain map (272-276)
  * `From2021` (412-428): the eval wrapper returning the plain fc embedding

The heads act on the C-major flatten, as the reference's; the JAX package
flattens NHWC and its importer permutes (`import_torch.py:279-347`).

`From2021.forward` runs the trunk and the plain `fc` head only: its output
does not depend on the FPN, the mask head or `regress`, which JAX's jit
drops from that forward. It keeps their parameters, so a strict load takes
the reference's checkpoint. `LResNetOcc.forward` computes all four outputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msml_torch.core.precision import f32_region
from msml_torch.nn.baselines import PLANES, final_map
from msml_torch.nn.common import (BatchNorm1d, PReLU, batch_norm, conv1x1,
                                  conv3x3)


FROM_LAYERS = (3, 4, 14, 3)  # LResNet50E-IR, the depth From2021 builds


def get_grids(h: int, w: int, n: int) -> list:
    """Occlusion-pattern dictionary (from2021.py:391-409): all axis-aligned
    rectangles on an n x n vertex grid, plus the empty grid."""
    x_axis = np.linspace(0, w, n + 1, True, dtype=int)
    y_axis = np.linspace(0, h, n + 1, True, dtype=int)
    vertex_set = [(y, x) for y in y_axis for x in x_axis]
    grids = [np.zeros((h, w))]
    for start in vertex_set:
        for end in vertex_set:
            if end[0] > start[0] and end[1] > start[1]:
                g = np.zeros((h, w))
                g[start[0]:end[0], start[1]:end[1]] = 1.0
                grids.append(g)
    return grids


def _upsample2(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='nearest'), then cropped to the skip
    branch's size (its odd dims)."""
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return y[:, :, :like.shape[2], :like.shape[3]]


class PyramidFeatures(nn.Module):
    """FPN (from2021.py:4-49) over (C3, C4, C5) -> [P3, P4, P5, P6, P7]."""

    def __init__(self, c3: int = 128, c4: int = 256, c5: int = 512,
                 feature_size: int = 256):
        super().__init__()

        def conv(cin, k, s=1):
            return nn.Conv2d(cin, feature_size, k, s, (k - 1) // 2)

        self.P5_1 = conv(c5, 1)
        self.P5_2 = conv(feature_size, 3)
        self.P4_1 = conv(c4, 1)
        self.P4_2 = conv(feature_size, 3)
        self.P3_1 = conv(c3, 1)
        self.P3_2 = conv(feature_size, 3)
        self.P6 = conv(c5, 3, 2)
        self.P7_2 = conv(feature_size, 3, 2)

    def forward(self, inputs):
        c3, c4, c5 = inputs
        p5 = self.P5_1(c5)
        p4 = self.P4_1(c4) + _upsample2(p5, c4)
        p3 = self.P3_1(c3) + _upsample2(p4, c3)
        p6 = self.P6(c5)
        return [self.P3_2(p3), self.P4_2(p4), self.P5_2(p5), p6,
                self.P7_2(F.relu(p6))]


class BlockIR(nn.Module):
    """from2021.py:52-84: bn1 -> conv3x3 -> bn2 -> PReLU -> conv3x3(stride)
    -> bn3, plus a 1x1 conv + BN downsample."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.bn1 = batch_norm(inplanes)
        self.conv1 = conv3x3(inplanes, planes)
        self.bn2 = batch_norm(planes)
        self.prelu1 = PReLU(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn3 = batch_norm(planes)
        self.downsample = (nn.Sequential(conv1x1(inplanes, planes, stride),
                                         batch_norm(planes))
                           if use_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prelu1(self.bn2(self.conv1(self.bn1(x))))
        out = self.bn3(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


def _bn1d(n: int) -> BatchNorm1d:
    return BatchNorm1d(n, eps=1e-5, momentum=0.1)


class LResNetOcc(nn.Module):
    """LResNet_Occ (from2021.py:291-373), 50E-IR depth by default:
    forward(x (B, 3, H, W), mask=None) -> (fc_mask, mask, vec, fc), the
    mask (B, 512, h, w) from the FPN head unless given."""

    def __init__(self, layers: Sequence[int] = FROM_LAYERS,
                 num_mask: int = 226, input_size=(112, 96)):
        super().__init__()
        self.conv1 = conv3x3(3, PLANES[0])
        self.bn1 = batch_norm(PLANES[0])
        self.prelu1 = PReLU(PLANES[0])
        inplanes = PLANES[0]
        for li, (planes, blocks) in enumerate(zip(PLANES, layers)):
            self.add_module(f"layer{li + 1}", nn.Sequential(
                BlockIR(inplanes, planes, 2, True),
                *[BlockIR(planes, planes) for _ in range(1, blocks)]))
            inplanes = planes
        self.fpn = PyramidFeatures()
        self.mask = nn.Sequential(
            nn.Conv2d(256, 256, 3, 2, 1, bias=False), PReLU(256),
            batch_norm(256), nn.Conv2d(256, 512, 3, 2, 1, bias=False),
            nn.Sigmoid())
        h, w = final_map(input_size)
        flat = PLANES[-1] * h * w
        self.regress = nn.Sequential(_bn1d(flat), nn.Dropout(0.5),
                                     nn.Linear(flat, num_mask, bias=False),
                                     _bn1d(num_mask))
        self.fc = nn.Sequential(_bn1d(flat), nn.Dropout(0.5),
                                nn.Linear(flat, 512), _bn1d(512))

    def trunk(self, x: torch.Tensor):
        """The stem and the four stages -> their four outputs."""
        x = self.prelu1(self.bn1(self.conv1(x)))
        feats = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats

    def head(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """A BN1d / dropout / linear / BN1d head on the C-major flatten,
        in float32."""
        x = torch.flatten(x, 1)
        with f32_region(x.device.type):
            return seq(x.float())

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        _, x2, x3, fmap = self.trunk(x)
        if mask is None:
            mask = self.mask(self.fpn([x2, x3, fmap])[0])
        vec = self.head(self.regress, mask)
        return (self.head(self.fc, fmap * mask), mask, vec,
                self.head(self.fc, fmap))


class From2021(LResNetOcc):
    """from2021.py:412-428: the eval wrapper, forward(x) -> the plain fc
    embedding (B, 512) float32; the FPN, the mask head and `regress` keep
    their parameters but do not run."""

    def __init__(self, input_size=(112, 96)):
        super().__init__(FROM_LAYERS, len(get_grids(112, 96, 5)),
                         input_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.fc, self.trunk(x)[-1])
