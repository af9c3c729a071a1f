"""LightCNN-29v2 Face Recognition Branch (grayscale 128 x 128), NCHW.

Counterpart of `msml_tpu/nn/lightcnn.py`. Parity targets in the reference:
  * `mfm`, the Max-Feature-Map conv — `backbones/frb/lightcnn.py:25-38`
    (type 1): a conv with a bias to 2C channels, then the elementwise max
    of the first C channels and the second C (`torch.split(x, C, 1)`)
  * `group` / `resblock` — `lightcnn.py:41-66`
  * `network_29layers_v2.forward` with an FM-operator hook after each
    max + avg pooling — `lightcnn.py:145-237`
  * the frozen teacher that returns the 4 pooled stage features —
    `backbones/peer/lightcnn.py:99-136`

No BatchNorm and no PReLU anywhere (faithful to the reference); every conv
carries a bias, so none runs the conv3x3 kernels; `fc` has a bias and no
feature BN and runs in float32 (`msml_tpu/nn/lightcnn.py:132-133`).
Parameter names are the reference's torch names (`conv1.filter`,
`block1.{i}.conv{1,2}.filter`, `group1.conv_a.filter`, `group1.conv.filter`,
..., `group4.conv.filter`, `fc`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from msml_torch.core.precision import f32_region
from msml_torch.nn.common import max_avg_pool2

LIGHTCNN29_LAYERS = (1, 2, 3, 4)
FC_HW = 8  # the final 8 x 8 x 128 map at 128 input


class MFM(nn.Module):
    """Max-Feature-Map conv (`lightcnn.py:25-38`, type 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.out_channels = out_channels
        self.filter = nn.Conv2d(in_channels, 2 * out_channels, kernel_size,
                                stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = torch.split(self.filter(x), self.out_channels, 1)
        return torch.max(a, b)


class Group(nn.Module):
    """mfm 1x1 then mfm 3x3 (`lightcnn.py:41-50`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_a = MFM(in_channels, in_channels, 1, 1, 0)
        self.conv = MFM(in_channels, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.conv_a(x))


class MfmResblock(nn.Module):
    """Two 3x3 mfm convs and the residual (`lightcnn.py:53-66`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = MFM(channels, channels)
        self.conv2 = MFM(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x)) + x


class _LightTrunk(nn.Module):
    """The LightCNN layers without hooks: `conv1` mfm 5x5 to 48, then four
    stages, each ending in a max + avg pooling (64 x 64 x 48, 32 x 32 x 96,
    16 x 16 x 192, 8 x 8 x 128 at 128 input), the C-major flatten and `fc`
    in float32. `layers` counts the resblocks of block1..block4."""

    def __init__(self, layers: Sequence[int] = LIGHTCNN29_LAYERS,
                 dim_feature: int = 256, in_channels: int = 1):
        super().__init__()
        self.conv1 = MFM(in_channels, 48, 5, 1, 2)
        self.block1 = nn.Sequential(*[MfmResblock(48)
                                      for _ in range(layers[0])])
        self.group1 = Group(48, 96)
        self.block2 = nn.Sequential(*[MfmResblock(96)
                                      for _ in range(layers[1])])
        self.group2 = Group(96, 192)
        self.block3 = nn.Sequential(*[MfmResblock(192)
                                      for _ in range(layers[2])])
        self.group3 = Group(192, 128)
        self.block4 = nn.Sequential(*[MfmResblock(128)
                                      for _ in range(layers[3])])
        self.group4 = Group(128, 128)
        self.fc = nn.Linear(FC_HW * FC_HW * 128, dim_feature)

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Stage `i` (0..3) on x, up to (not including) its pooling."""
        if i == 0:
            return self.conv1(x)
        if i == 1:
            return self.group1(self.block1(x))
        if i == 2:
            return self.group2(self.block2(x))
        return self.group4(self.block4(self.group3(self.block3(x))))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The last pooled map -> the (B, dim_feature) float32 feature."""
        x = torch.flatten(x, 1)  # C-major, as the reference (lightcnn.py:231)
        with f32_region(x.device.type):
            return self.fc(x.float())


class PeerLightCNN(_LightTrunk):
    """The frozen teacher (`backbones/peer/lightcnn.py:99-136`):
    forward(x) -> (feature, [4 pooled stage features]), all without
    gradient. It stays in eval mode whatever mode its parent is put in and
    its parameters do not require grad, as `iresnet.PeerIResNet`'s."""

    def __init__(self, layers: Sequence[int] = LIGHTCNN29_LAYERS,
                 dim_feature: int = 256, in_channels: int = 1):
        super().__init__(layers, dim_feature, in_channels)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        return super().train(False)

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        inters = []
        for i in range(4):
            x = max_avg_pool2(self.stage(i, x))
            inters.append(x)
        return self.embed(x), inters


class LightCNN29v2(_LightTrunk):
    """FRB LightCNN with an FM-operator hook after each pooling
    (`lightcnn.py:145-237`).

    forward(x, segs, ori=None, losses=None) -> (feature, kd)
      x      : (B, 1, 128, 128)
      segs   : 4 OSB feature maps (B, 18, 64/32/16/8) or (None,) * 4
      ori    : the unoccluded images, same shape, or None: with the peer
               teacher they give the FMs their teacher features
      losses : unused (LightCNN has no recover decoder); taken so that the
               MSML calls every FRB alike
    kd is the sum of the FMs' KD terms, 0.0 when none gave one."""

    def __init__(self, layers: Sequence[int] = LIGHTCNN29_LAYERS,
                 dim_feature: int = 256, fm_ops: Sequence[nn.Module] = (),
                 in_channels: int = 1, use_peer: bool = False):
        if len(fm_ops) != 4:
            raise ValueError("LightCNN29v2 needs four FM operators")
        super().__init__(layers, dim_feature, in_channels)
        self.fm_ops = nn.ModuleList(fm_ops)
        self.peer: Optional[PeerLightCNN] = (
            PeerLightCNN(layers, dim_feature, in_channels) if use_peer
            else None)

    def forward(self, x: torch.Tensor, segs,
                ori: Optional[torch.Tensor] = None,
                losses: Optional[dict] = None):
        peer_feats = (None,) * 4
        if ori is not None and self.peer is not None:
            _, peer_feats = self.peer(ori)
        kd_losses = []
        for i, (fm_op, seg, yt) in enumerate(zip(self.fm_ops, segs,
                                                 peer_feats)):
            x, kd = fm_op(max_avg_pool2(self.stage(i, x)), seg, yt)
            if kd is not None:
                kd_losses.append(kd)
        return self.embed(x), (sum(kd_losses) if kd_losses else 0.0)
