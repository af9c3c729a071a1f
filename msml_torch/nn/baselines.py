"""Eval-only baseline backbones, NCHW.

Counterpart of `msml_tpu/nn/baselines.py`. Parity targets in the reference:
  * `Sphere` / `cosface2018` — `backbones/frb/cosface2018.py:7-73,190-201`:
    the SphereFace-20/64 trunk used as the CosFace-2018 embedding model,
    112 x 96 or 112 x 112 input, with the reference's torch names (the ones
    `msml_tpu/tools/import_torch.py::import_sphere` reads): `layer{n}` is a
    Sequential of the stride-2 conv with a bias (`.0`), its PReLU (`.1`)
    and the blocks (`.2` on, each `conv1, prelu1, conv2, prelu2`, convs
    without bias); `fc` reads the C-major flatten of the last map
  * `ResNet` / `resnet28` — `backbones/frb/resnet.py`: a torchvision
    BasicBlock ResNet with an embedding fc, every stage's first block at
    stride 2 (layer 1's too, `msml_tpu/nn/baselines.py:131-134`); the JAX
    package has no importer for it, so it takes torchvision's names
    (`conv1, bn1, layer{n}.{b}.{conv1,bn1,conv2,bn2,downsample.0/1}`) and
    `bn2`, `fc`

The block convs are `nn/common.py::conv3x3`, so those at 64 -> 64, stride 1
run the conv3x3 kernel and the PReLUs the PReLU kernel. The fc runs in
float32 under every policy, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msml_torch.core.precision import f32_region
from msml_torch.nn.common import PReLU, batch_norm, conv1x1, conv3x3

PLANES = (64, 128, 256, 512)


def final_map(input_size: Sequence[int], stages: int = 4) -> Tuple[int, int]:
    """(h, w) of the map after `stages` stride-2 3x3 convs with padding 1
    on an (h, w) input: 112 x 96 -> 7 x 6."""
    h, w = input_size
    for _ in range(stages):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


def embed_fc(fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The C-major flatten of x through `fc`, in float32."""
    x = torch.flatten(x, 1)
    with f32_region(x.device.type):
        return fc(x.float())


class _SphereBlock(nn.Module):
    """cosface2018.py:7-16: x + prelu(conv(prelu(conv(x))))."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = conv3x3(planes, planes)
        self.prelu1 = PReLU(planes)
        self.conv2 = conv3x3(planes, planes)
        self.prelu2 = PReLU(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.prelu2(self.conv2(self.prelu1(self.conv1(x))))


class Sphere(nn.Module):
    """SphereFace trunk (cosface2018.py:19-73), `net_type` 20 or 64:
    forward(x (B, 3, H, W)) -> (B, dim_feature) float32."""

    def __init__(self, net_type: int = 20, input_size=(112, 96),
                 dim_feature: int = 512):
        super().__init__()
        if net_type == 20:
            layers = (1, 2, 4, 1)
        elif net_type == 64:
            layers = (3, 7, 16, 3)
        else:
            raise ValueError(f"sphere{net_type} IS NOT SUPPORTED!")
        self.input_size = tuple(input_size)
        inplanes = 3
        for li, (planes, blocks) in enumerate(zip(PLANES, layers)):
            self.add_module(f"layer{li + 1}", nn.Sequential(
                conv3x3(inplanes, planes, 2, bias=True), PReLU(planes),
                *[_SphereBlock(planes) for _ in range(blocks)]))
            inplanes = planes
        h, w = final_map(self.input_size)
        self.fc = nn.Linear(PLANES[-1] * h * w, dim_feature)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return embed_fc(self.fc, x)


def cosface2018(input_size=(112, 96)) -> Sphere:
    """cosface2018.py:190-201 factory."""
    return Sphere(net_type=20, input_size=input_size)


class _BasicBlock(nn.Module):
    """torchvision BasicBlock (resnet.py): conv-bn-relu-conv-bn + skip."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = batch_norm(planes)
        self.downsample = (
            nn.Sequential(conv1x1(inplanes, planes, stride),
                          batch_norm(planes))
            if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet28": (3, 4, 3, 3),
    "resnet34": (3, 4, 6, 3),
}


class ResNet(nn.Module):
    """Vanilla BasicBlock ResNet embedding model (backbones/frb/resnet.py)
    on face crops: forward(x) -> (B, dim_feature) float32."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 dim_feature: int = 512, input_size=(112, 112)):
        super().__init__()
        self.conv1 = conv3x3(3, PLANES[0])
        self.bn1 = batch_norm(PLANES[0])
        inplanes = PLANES[0]
        for li, (planes, blocks) in enumerate(zip(PLANES, layers)):
            self.add_module(f"layer{li + 1}", nn.Sequential(*[
                _BasicBlock(inplanes if b == 0 else planes, planes,
                            2 if b == 0 else 1) for b in range(blocks)]))
            inplanes = planes
        self.bn2 = batch_norm(PLANES[-1])
        h, w = final_map(input_size)
        self.fc = nn.Linear(PLANES[-1] * h * w, dim_feature)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return embed_fc(self.fc, self.bn2(x))


def resnet28(dim_feature: int = 512, input_size=(112, 112)) -> ResNet:
    return ResNet(RESNET_LAYERS["resnet28"], dim_feature, input_size)
