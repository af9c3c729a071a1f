"""Shared NN building blocks, NCHW.

Counterpart of `msml_tpu/nn/common.py`. Convolutions use torch's symmetric
padding (`backbones/frb/iresnet.py:17-35`, `backbones/osb/unet.py:41-59`);
BatchNorm uses eps 1e-5 and momentum 0.1; PReLU is per channel with init
0.25. Parameter names are the reference's torch names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class PReLU(nn.Module):
    """Per-channel PReLU (`nn.PReLU(C)` parity, parameter `weight`).

    The slope is cast to the input's dtype, so the op also runs on the
    bf16 activations that autocast produces."""

    def __init__(self, num_parameters: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def conv3x3(in_planes: int, out_planes: int, stride: int = 1,
            bias: bool = False) -> nn.Conv2d:
    """3x3 conv, torch padding=1 (`iresnet.py:17-26`)."""
    return nn.Conv2d(in_planes, out_planes, 3, stride, 1, bias=bias)


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    """1x1 conv (`iresnet.py:29-35`)."""
    return nn.Conv2d(in_planes, out_planes, 1, stride, 0, bias=False)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    """BatchNorm with torch defaults: eps 1e-5, momentum 0.1."""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def conv_transpose(in_planes: int, out_planes: int, kernel_size: int,
                   stride: int = 2, padding: int = 1) -> nn.ConvTranspose2d:
    """The U-Net decoders' transposed conv (`backbones/osb/unet.py:141-156`)."""
    return nn.ConvTranspose2d(in_planes, out_planes, kernel_size, stride,
                              padding, bias=False)


def dap(x: torch.Tensor, num_classes: int = 2, k: int = 3) -> torch.Tensor:
    """Displacement-Aware Pooling head (`backbones/osb/unet.py:158-161`).

    PixelShuffle(k) + AvgPool(k, k) is exactly a per-pixel mean over each
    class's k*k channel group; in NCHW the channel index is c*k*k + d.
    x: (N, num_classes * k**2, H, W) -> (N, num_classes, H, W)."""
    n, c, h, w = x.shape
    if c != num_classes * k * k:
        raise ValueError(f"dap expects {num_classes * k * k} channels, got {c}")
    return x.view(n, num_classes, k * k, h, w).mean(2)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation of every parameter and buffer of `model`.

    Mirrors the reference flax initialisers: lecun-normal conv and dense
    kernels, he-normal transposed-conv kernels, zero biases, unit BN scale,
    BN running statistics (0, 1), PReLU slope 0.25. Draws on the CPU from
    `generator`, then copies onto the parameters' device."""

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            # flax kernel (k, k, out, in): fan_in = k * k * out
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            normal_(m.weight, math.sqrt(2.0 / fan_in))
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            normal_(m.weight, math.sqrt(1.0 / m.weight[0].numel()))
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
