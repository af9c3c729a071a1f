"""Feature-Masking operators: the OSB->FRB fusion CNNs, NCHW, eval only.

Counterpart of `msml_tpu/nn/fm.py`. Parity target
`backbones/fm/fmoperator.py:35-325`:
  * `resblock_bottle` (35-68): 1x1 -> BN -> PReLU -> 3x3 -> BN -> PReLU ->
    1x1 -> BN, residual add, PReLU; bottleneck width in/2 when in <= 128
    else 128.
  * `FMCnn.forward` (277-311): concat(Yf, Yo[18ch]) -> 3x3 (or 1x1) conv ->
    N bottleneck resblocks -> tanh/sigmoid mask -> arith add/sub/div/mul
    with identity -> skip connection. The peer-guided path (`use_ori`) is
    not ported yet.
  * `FMNone` (314-325): identity pass-through.
"""

from __future__ import annotations

import torch
from torch import nn

from msml_torch.nn.common import PReLU, batch_norm, conv1x1, conv3x3


class ResblockBottle(nn.Module):
    """`fmoperator.py:35-68`."""

    def __init__(self, channels: int):
        super().__init__()
        bottle = channels // 2 if channels <= 128 else 128
        self.conv1 = conv1x1(channels, bottle)
        self.bn1 = batch_norm(bottle)
        self.prelu1 = PReLU(bottle)
        self.conv2 = conv3x3(bottle, bottle)
        self.bn2 = batch_norm(bottle)
        self.prelu2 = PReLU(bottle)
        self.conv3 = conv1x1(bottle, channels)
        self.bn3 = batch_norm(channels)
        self.prelu3 = PReLU(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prelu1(self.bn1(self.conv1(x)))
        out = self.prelu2(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.prelu3(out + x)


class FMCnn(nn.Module):
    """`fmoperator.py:84-311` without the peer path. forward(yf, yo) -> z_f."""

    def __init__(self, channel_f: int, seg_channels: int = 18,
                 kernel_size: int = 3, resblocks: int = 2,
                 activation: str = "tanh", arith_strategy: str = "add",
                 use_ori: bool = False):
        super().__init__()
        if use_ori:
            raise NotImplementedError(
                "the peer-guided FM path (use_ori) is not ported yet")
        if activation not in ("tanh", "sigmoid"):
            raise ValueError(f"activation {activation}")
        if arith_strategy not in ("add", "sub", "div", "mul"):
            raise ValueError(f"arith {arith_strategy}")
        self.activation = activation
        self.arith_strategy = arith_strategy
        conv = conv1x1 if kernel_size == 1 else conv3x3
        self.same_conv = conv(channel_f + seg_channels, channel_f)
        self.res_block = nn.Sequential(
            *[ResblockBottle(channel_f) for _ in range(resblocks)])

    def forward(self, yf: torch.Tensor, yo: torch.Tensor) -> torch.Tensor:
        identity = yf
        x = self.res_block(self.same_conv(torch.cat([identity, yo], 1)))
        x = torch.tanh(x) if self.activation == "tanh" else torch.sigmoid(x)
        if self.arith_strategy == "add":
            x = identity + x
        elif self.arith_strategy == "sub":
            x = identity - x
        elif self.arith_strategy == "div":
            x = identity / x
        else:
            x = identity * x
        return x + identity  # skip connection (fmoperator.py:310)


class FMNone(nn.Module):
    """`fmoperator.py:314-325`: do nothing."""

    def forward(self, yf: torch.Tensor, yo=None) -> torch.Tensor:
        return yf
