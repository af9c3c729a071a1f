"""Shared NN building blocks, NCHW.

Counterpart of `msml_tpu/nn/common.py`. Convolutions use torch's symmetric
padding (`backbones/frb/iresnet.py:17-35`, `backbones/osb/unet.py:41-59`);
BatchNorm uses eps 1e-5 and momentum 0.1 and updates its running variance
as flax does; PReLU is per channel with init 0.25 and runs the Triton
kernels of `kernels/prelu.py`; the 64 -> 64 3x3 stride-1 convs run the
CUDA kernels of `kernels/conv3x3.py`. Parameter names are the reference's
torch names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from msml_torch.heads.margin import MarginHead, SoftmaxHead
from msml_torch.kernels import conv3x3 as conv3x3_kernels
from msml_torch.kernels.prelu import prelu


class PReLU(nn.Module):
    """Per-channel PReLU (`nn.PReLU(C)` names, parameter `weight`).

    `kernels.prelu.prelu`: the Triton kernels on CUDA, the plain version on
    the CPU, in eval and train alike. The slope is cast to the input's
    dtype, so it runs on the bf16 activations that autocast produces, and
    the gradient at x == 0 is the JAX one (`F.prelu`'s differs there)."""

    def __init__(self, num_parameters: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.weight)


class Conv3x3(nn.Conv2d):
    """3x3 conv with padding 1 that runs `kernels.conv3x3` where the kernel
    applies: 64 channels in and out, stride 1, no bias (`routed`). Every
    other configuration is `nn.Conv2d`'s own forward.

    Under autocast the routed forward casts x and the weight to the
    autocast dtype, as `F.conv2d` would there, and runs the Function with
    autocast off; the weight's gradient comes back in its own dtype."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 bias: bool = False):
        super().__init__(in_planes, out_planes, 3, stride, 1, bias=bias)
        self.routed = (in_planes == out_planes == conv3x3_kernels.C
                       and stride == 1 and not bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.routed:
            return super().forward(x)
        w = self.weight
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            dtype = torch.get_autocast_dtype(dev)
            x, w = x.to(dtype), w.to(dtype)
        with torch.autocast(dev, enabled=False):
            return conv3x3_kernels.conv3x3(x, w)


def conv3x3(in_planes: int, out_planes: int, stride: int = 1,
            bias: bool = False) -> Conv3x3:
    """3x3 conv, torch padding=1 (`iresnet.py:17-26`)."""
    return Conv3x3(in_planes, out_planes, stride, bias)


def routed_conv_sites(model: nn.Module):
    """Names of the modules of `model` that run the conv3x3 kernels."""
    return [name for name, m in model.named_modules()
            if isinstance(m, Conv3x3) and m.routed]


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    """1x1 conv (`iresnet.py:29-35`)."""
    return nn.Conv2d(in_planes, out_planes, 1, stride, 0, bias=False)


class _FlaxRunningVar:
    """Train-mode running variance as flax updates it, from the biased
    batch variance (`nn.BatchNorm(momentum=0.9)`, msml_tpu/nn/common.py:
    56-61); torch's own update uses the unbiased one, n / (n - 1) larger.

    torch's update of a copy gives rv' = (1 - m) rv + m v n / (n - 1);
    rv' (n - 1) / n + (1 - m) rv / n is flax's (1 - m) rv + m v. The copy
    is what the backward keeps, so the buffer itself may change in place."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        m = self.momentum
        torch_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, torch_var, self.weight,
                         self.bias, True, m, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1 - m) / n).add_(torch_var,
                                                    alpha=(n - 1) / n)
        return y


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    pass


def batch_norm(channels: int) -> BatchNorm2d:
    """BatchNorm with torch defaults: eps 1e-5, momentum 0.1 (flax 0.9)."""
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


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
    kernels, he-normal transposed-conv kernels, xavier-uniform head weights,
    zero biases, unit BN scale, BN running statistics (0, 1), PReLU slope
    0.25. Draws on the CPU from `generator`, then copies onto the
    parameters' device."""

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            # flax kernel (k, k, out, in): fan_in = k * k * out
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            normal_(m.weight, math.sqrt(2.0 / fan_in))
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            normal_(m.weight, math.sqrt(1.0 / m.weight[0].numel()))
        elif isinstance(m, (MarginHead, SoftmaxHead)):
            limit = math.sqrt(6.0 / sum(m.weight.shape))
            m.weight.copy_((torch.rand(m.weight.shape, generator=generator)
                            * 2 - 1) * limit)
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
