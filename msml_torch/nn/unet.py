"""Occlusion Segmentation Branch: U-Net with iResNet encoder + Global Conv
Modules, NCHW.

Counterpart of `msml_tpu/nn/unet.py`. Parity target
`backbones/osb/unet.py:16-279`:
  * `_GlobalConvModule` (16-38): (k x 1 -> 1 x k) + (1 x k -> k x 1), each
    conv padded only along its long axis.
  * `Unet.forward` (189-240): stride-2 stem (stages at 56/28/14/7/4 for a
    112 input), 5 GCMs + 5 transposed-conv decoders with skip concats
    `(seg_k, gcm(x_k))`, and the DAP head. deconv1 has kernel 4 for a 128
    input, 3 for 112 (`unet.py:141-148`).
  * Returns [seg0(7), seg1(14), seg2(28), seg3(56), seg5(112, 2ch)]; seg0..3
    are detached (the "detach link", `unet.py:225-236`), seg5 is float32.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from msml_torch.core.precision import f32_region
from msml_torch.nn.common import PReLU, batch_norm, conv_transpose, dap
from msml_torch.nn.iresnet import ResStage


class GlobalConvModule(nn.Module):
    """`unet.py:16-38`."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 7):
        super().__init__()
        k, p = kernel_size, (kernel_size - 1) // 2
        self.conv_l1 = nn.Conv2d(in_dim, out_dim, (k, 1), padding=(p, 0))
        self.conv_l2 = nn.Conv2d(out_dim, out_dim, (1, k), padding=(0, p))
        self.conv_r1 = nn.Conv2d(in_dim, out_dim, (1, k), padding=(0, p))
        self.conv_r2 = nn.Conv2d(out_dim, out_dim, (k, 1), padding=(p, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.conv_l2(self.conv_l1(x))
                + self.conv_r2(self.conv_r1(x)))


class Unet(nn.Module):
    """`unet.py:94-240`. forward(x) -> [seg0, seg1, seg2, seg3, seg5]."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 2, kernel_size: int = 7, dap_k: int = 3,
                 input_size: int = 112):
        super().__init__()
        self.num_classes, self.dap_k = num_classes, dap_k
        seg_ch = num_classes * dap_k ** 2  # 18
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = batch_norm(64)
        self.prelu = PReLU(64)
        self.layer1 = ResStage(64, 64, layers[0], 2)
        self.layer2 = ResStage(64, 128, layers[1], 2)
        self.layer3 = ResStage(128, 256, layers[2], 2)
        self.layer4 = ResStage(256, 512, layers[3], 2)
        self.bn2 = batch_norm(512)
        self.gcm1 = GlobalConvModule(512, num_classes * 4, kernel_size)
        self.deconv1 = conv_transpose(num_classes * 4, seg_ch,
                                      4 if input_size == 128 else 3)
        self.gcm2 = GlobalConvModule(256, seg_ch, kernel_size)
        self.deconv2 = conv_transpose(2 * seg_ch, seg_ch, 4)
        self.gcm3 = GlobalConvModule(128, seg_ch, kernel_size)
        self.deconv3 = conv_transpose(2 * seg_ch, seg_ch, 4)
        self.gcm4 = GlobalConvModule(64, seg_ch, kernel_size)
        self.deconv4 = conv_transpose(2 * seg_ch, seg_ch, 4)
        self.gcm5 = GlobalConvModule(64, seg_ch, kernel_size)
        self.deconv5 = conv_transpose(2 * seg_ch, seg_ch, 4)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x0 = self.prelu(self.bn1(self.conv1(x)))         # 56 | 64
        x1 = self.layer1(x0)                             # 28 | 32
        x2 = self.layer2(x1)                             # 14 | 16
        x3 = self.layer3(x2)                             # 7 | 8
        x4 = self.layer4(x3)                             # 4 | 4
        xx = self.bn2(x4)

        seg0 = self.deconv1(self.gcm1(xx))                                # 7
        seg1 = self.deconv2(torch.cat([seg0, self.gcm2(x3)], 1))          # 14
        seg2 = self.deconv3(torch.cat([seg1, self.gcm3(x2)], 1))          # 28
        seg3 = self.deconv4(torch.cat([seg2, self.gcm4(x1)], 1))          # 56
        seg5_ = self.deconv5(torch.cat([seg3, self.gcm5(x0)], 1))         # 112

        with f32_region(x.device.type):  # seg logits in f32 (consensus loss)
            seg5 = dap(seg5_.float(), self.num_classes, self.dap_k)
        return [seg0.detach(), seg1.detach(), seg2.detach(), seg3.detach(),
                seg5]
