"""Feature-Masking operators: the OSB->FRB fusion CNNs, NCHW.

Counterpart of `msml_tpu/nn/fm.py`. Parity target
`backbones/fm/fmoperator.py:35-325`:
  * `resblock_bottle` (35-68): 1x1 -> BN -> PReLU -> 3x3 -> BN -> PReLU ->
    1x1 -> BN, residual add, PReLU; bottleneck width in/2 when in <= 128
    else 128.
  * `FMCnn.forward` (277-311): concat(Yf, Yo[18ch]) -> 3x3 (or 1x1) conv ->
    N bottleneck resblocks -> tanh/sigmoid mask -> optional peer-guided
    path (`use_ori`: the `conv_m` mask transform or `1 - mask`, the
    `conv1` tower on m_bar * Yf, and in training with a teacher feature
    the `conv2` tower on m_bar * Yt and the float32 MSE KD term) -> arith
    add/sub/div/mul with identity -> (+ f_out) -> skip connection.
  * `FMNone` (314-325): identity pass-through.
"""

from __future__ import annotations

from typing import Optional

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


def _conv_tower(channels: int) -> nn.Sequential:
    """conv3x3 (bias) -> BN -> PReLU, twice (`fmoperator.py:136-151`); torch
    names .0 to .5. The convs carry a bias, so no conv3x3 kernel runs
    here."""
    return nn.Sequential(
        conv3x3(channels, channels, bias=True), batch_norm(channels),
        PReLU(channels), conv3x3(channels, channels, bias=True),
        batch_norm(channels), PReLU(channels))


class FMCnn(nn.Module):
    """`fmoperator.py:84-311`. forward(yf, yo, yt=None) -> (z_f, kd or None).

    With `use_ori` the module holds `conv_m` (`mask_trans: conv`: conv3x3
    with bias + BN, torch names .0 and .1) and, with `use_conv`, the
    towers `conv1` and `conv2`. `conv2` is held even with `kd_metric`
    off, as the JAX package creates its parameters at init
    (`msml_tpu/nn/fm.py:131`), so checkpoints carry it either way. The
    towers and `conv_m` run at eval too; `conv2` and the KD term only when
    a teacher feature `yt` is given and `kd_metric` is on."""

    def __init__(self, channel_f: int, seg_channels: int = 18,
                 kernel_size: int = 3, resblocks: int = 2,
                 activation: str = "tanh", arith_strategy: str = "add",
                 use_ori: bool = False, use_conv: bool = False,
                 mask_trans: str = "conv", kd_metric: bool = True):
        super().__init__()
        if activation not in ("tanh", "sigmoid"):
            raise ValueError(f"activation {activation}")
        if arith_strategy not in ("add", "sub", "div", "mul"):
            raise ValueError(f"arith {arith_strategy}")
        if use_ori and mask_trans not in ("conv", "invert"):
            raise ValueError("mask_trans type error")
        self.activation = activation
        self.arith_strategy = arith_strategy
        self.use_ori, self.use_conv = use_ori, use_conv
        self.mask_trans, self.kd_metric = mask_trans, kd_metric
        conv = conv1x1 if kernel_size == 1 else conv3x3
        self.same_conv = conv(channel_f + seg_channels, channel_f)
        self.res_block = nn.Sequential(
            *[ResblockBottle(channel_f) for _ in range(resblocks)])
        if use_ori and mask_trans == "conv":
            self.conv_m = nn.Sequential(
                conv3x3(channel_f, channel_f, bias=True),
                batch_norm(channel_f))
        if use_ori and use_conv:
            self.conv1 = _conv_tower(channel_f)
            self.conv2 = _conv_tower(channel_f)

    def forward(self, yf: torch.Tensor, yo: torch.Tensor,
                yt: Optional[torch.Tensor] = None):
        identity = yf
        x = self.res_block(self.same_conv(torch.cat([identity, yo], 1)))
        x = torch.tanh(x) if self.activation == "tanh" else torch.sigmoid(x)

        f_out, kd = None, None
        if self.use_ori:
            m_bar = self.conv_m(x) if self.mask_trans == "conv" else 1.0 - x
            f_out = m_bar * identity
            if self.use_conv:
                f_out = self.conv1(f_out)
            if yt is not None and self.kd_metric:
                f_occ = m_bar * yt
                if self.use_conv:
                    f_occ = self.conv2(f_occ)
                diff = f_occ.float() - f_out.float()
                kd = torch.mean(diff * diff)

        if self.arith_strategy == "add":
            x = identity + x
        elif self.arith_strategy == "sub":
            x = identity - x
        elif self.arith_strategy == "div":
            x = identity / x
        else:
            x = identity * x
        if f_out is not None:
            x = x + f_out
        return x + identity, kd  # skip connection (fmoperator.py:310)


class FMNone(nn.Module):
    """`fmoperator.py:314-325`: do nothing."""

    def forward(self, yf: torch.Tensor, yo=None, yt=None):
        return yf, None
