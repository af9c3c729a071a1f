"""DeepMind-VQVAE-style recover decoder, NCHW.

Counterpart of `msml_tpu/nn/decoder.py`. Parity target
`backbones/decoder/deepmind.py:20-103`: reconstructs a 112 x 112 image from
the 7 x 7 x 512 output of the FRB's `bn2` through four transposed-conv
upsampling stages (7 -> 14 -> 28 -> 56 -> 112), each after a conv3x3 +
ReLU and two residual blocks, and an L2 recover loss against the
unoccluded original, in float32.

Every conv carries a bias (flax's `nn.Conv` default), so no conv3x3 kernel
runs here. The torch names follow the flax names: `conv_in{s}`,
`res{s}a` / `res{s}b` (`conv0`, `conv1`), `deconv{s}`, `deconv_out`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msml_torch.nn.common import conv_transpose


class _ResBlock(nn.Module):
    """conv3x3 -> ReLU -> conv1x1, residual, ReLU (`deepmind.py:20-34`)."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.conv0 = nn.Conv2d(channels, hidden, 3, 1, 1, bias=True)
        self.conv1 = nn.Conv2d(hidden, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv1(F.relu(self.conv0(x))) + x)


class DeepMindDecoder(nn.Module):
    """`deepmind.py:60-103`. forward(x, ori=None) -> (recover, l2 loss);
    the loss is 0.0 without `ori`."""

    def __init__(self, n_init: int = 512, n_hid: int = 64,
                 out_channels: int = 3):
        super().__init__()
        h2, h = 2 * n_hid, n_hid
        for s in range(3):
            self.add_module(f"conv_in{s}", nn.Conv2d(n_init if s == 0 else h,
                                                     h2, 3, 1, 1, bias=True))
            self.add_module(f"res{s}a", _ResBlock(h2, h2 // 4))
            self.add_module(f"res{s}b", _ResBlock(h2, h2 // 4))
            self.add_module(f"deconv{s}", conv_transpose(h2, h, 4, 2, 1,
                                                         bias=True))
        self.deconv_out = conv_transpose(h, out_channels, 4, 2, 1, bias=True)

    def forward(self, x: torch.Tensor, ori: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor | float]:
        for s in range(3):
            x = F.relu(getattr(self, f"conv_in{s}")(x))
            x = getattr(self, f"res{s}b")(getattr(self, f"res{s}a")(x))
            x = F.relu(getattr(self, f"deconv{s}")(x))
        recover = self.deconv_out(x)
        loss = 0.0
        if ori is not None:
            diff = recover.float() - ori.float()
            loss = torch.mean(diff * diff)
        return recover, loss
