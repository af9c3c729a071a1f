"""MSML composite model: OSB -> FM operators -> FRB -> classification head.

Counterpart of `msml_tpu/nn/msml.py`. Parity target `backbones/msml.py:15-174`:
  * shape negotiation per FRB type (`_prepare_shapes`, msml.py:47-67)
  * FM operator construction from `fm_layers` 0/1 flags (msml.py:69-89)
  * OSB output ordering: the OSB returns [seg0..seg3, seg5] small->big;
    reversed, final_seg = seg5 and segs = [seg3, seg2, seg1, seg0] big->small
    feed FM stages 1..4 (msml.py:150-158)
  * eval forward returns (feature, final_seg) (msml.py:173-174); the
    training forward returns (final_cls, final_seg, kd) with
    final_cls = head(feature, label) + kd, the reference's constant logit
    shift (msml.py:171; `msml_tpu/nn/msml.py:180-183`). The peer teacher is
    not ported, so kd is 0.0 (`msml_tpu/nn/iresnet.py:185`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from msml_torch import resolve_device
from msml_torch.core.precision import DEFAULT_POLICY, Policy, \
    policy_from_config
from msml_torch.heads.margin import MarginHead, SoftmaxHead
from msml_torch.nn import iresnet
from msml_torch.nn.common import init_parameters
from msml_torch.nn.fm import FMCnn, FMNone
from msml_torch.nn.unet import Unet


def frb_shapes(frb_type: str):
    """`msml.py:47-67`: (input_size, gray, heights, f_channels, dim_feature)."""
    if "lightcnn" in frb_type:
        return 128, True, (64, 32, 16, 8), (48, 96, 192, 128), 256
    if "iresnet" in frb_type:
        return 112, False, (56, 28, 14, 7), (64, 128, 256, 512), 512
    raise ValueError("FRB type error")


class MSML(nn.Module):
    def __init__(self, frb_type: str = "iresnet18", osb_type: str = "unet",
                 fm_layers: Sequence[int] = (1, 1, 1, 1),
                 fm_params: Sequence = (3, 2, "tanh", "add"),
                 use_osb: bool = True, use_ori: bool = False,
                 use_decoder: bool = False, width_mult: int = 1,
                 num_classes: Optional[int] = None,
                 header_type: str = "AMArcFace",
                 header_params: Sequence[float] = (64.0, 0.5, 0.0, 0.0),
                 policy: Policy = DEFAULT_POLICY):
        """num_classes=None builds no classification head (eval only)."""
        super().__init__()
        if len(fm_layers) != 4:
            raise ValueError("fm_layers needs four entries")
        if not use_osb and any(fm_layers):
            raise ValueError(
                "fm_layers requires use_osb=True (FM operators consume OSB "
                "segmentation features; the reference crashes on this "
                "combination too, fmoperator.py:285)")
        if "lightcnn" in frb_type:
            raise NotImplementedError("the LightCNN FRB is not ported yet")
        if use_ori:
            raise NotImplementedError("the peer teacher is not ported yet")
        input_size, _gray, _heights, f_channels, dim_feature = frb_shapes(
            frb_type)
        if not isinstance(width_mult, int):
            raise NotImplementedError(
                "only an integer width_mult is ported so far")
        self.policy = policy
        self.dim_feature = dim_feature
        f_channels = tuple(c * width_mult for c in f_channels)

        kernel_size, num_res, act, arith = fm_params
        fm_ops = []
        for flag, channels in zip(fm_layers, f_channels):
            if flag == 0:
                fm_ops.append(FMNone())
            elif flag == 1:
                fm_ops.append(FMCnn(channels, kernel_size=kernel_size,
                                    resblocks=num_res, activation=act,
                                    arith_strategy=arith))
            else:
                raise ValueError("FM Operators type error")

        self.frb = iresnet.IResNet(layers=iresnet.IRESNET_LAYERS[frb_type],
                                   dim_feature=dim_feature, fm_ops=fm_ops,
                                   width_mult=width_mult,
                                   use_decoder=use_decoder)
        self.osb: Optional[Unet] = None
        if use_osb:
            if "unet" not in osb_type:
                raise ValueError("OSB type error")
            self.osb = Unet(input_size=input_size)

        self.classification: Optional[nn.Module] = None
        if num_classes is not None:
            if "Softmax" in header_type:
                self.classification = SoftmaxHead(num_classes, dim_feature)
            else:
                s, m, a, k = header_params
                self.classification = MarginHead(num_classes, dim_feature,
                                                 header_type, s, m, a, k)

    def forward(self, x: torch.Tensor, label: Optional[torch.Tensor] = None,
                train: bool = False):
        """x: (B, 3, 112, 112) float32.

        train=False -> (feature (B, 512) f32, final_seg (B, 2, 112, 112)
        f32 or None). train=True (the module in train mode, so BatchNorm
        uses and updates batch statistics; needs the head and `label`) ->
        (final_cls (B, num_classes) f32, final_seg, kd)."""
        if train and not (self.training and self.classification is not None
                          and label is not None):
            raise ValueError("the training forward needs model.train(), a "
                             "classification head and labels")
        with self.policy.autocast(x.device.type):
            # Part 1: OSB (`msml.py:150-158`)
            if self.osb is not None:
                seg_list = self.osb(x)
                seg_list.reverse()            # [seg5, seg3, seg2, seg1, seg0]
                final_seg = seg_list[0]
                segs = seg_list[1:]           # big -> small
            else:
                segs = (None, None, None, None)
                final_seg = None
            # Part 2: FRB (`msml.py:163-167`)
            feature = self.frb(x, segs)
        feature = self.policy.cast_to_output(feature)
        if not train:
            return feature, final_seg
        kd = 0.0
        final_cls = self.classification(feature, label) + kd
        return final_cls, final_seg, kd


def msml_from_config(cfg, policy: Policy | None = None, device="cuda",
                     seed: int = 0, head: bool = False) -> MSML:
    """Build an MSML from a derived Config (see core/config.py), with every
    parameter drawn from a `torch.Generator` seeded with `seed`, on
    `device`, in eval mode. head=True adds the classification head of
    `num_classes`, `header_type` and `header_params`, for training."""
    dev = resolve_device(device)
    if policy is None:
        policy = policy_from_config(bool(cfg.get("fp16", True)))
    if float(cfg.get("dropout", 0.0)) != 0.0:
        raise NotImplementedError("dropout is not ported yet")
    pp = cfg.get("peer_params") or {}
    with torch.device("meta"):  # no draws from the global RNG
        model = MSML(
            frb_type=cfg.frb_type,
            osb_type=cfg.osb_type,
            fm_layers=tuple(cfg.fm_layers),
            fm_params=tuple(cfg.fm_params),
            use_osb=bool(cfg.use_osb),
            use_ori=bool(pp.get("use_ori", False)),
            use_decoder=bool(pp.get("use_decoder", False)),
            width_mult=cfg.get("width_mult", 1),
            num_classes=cfg.num_classes if head else None,
            header_type=cfg.get("header_type", "AMArcFace"),
            header_params=tuple(cfg.get("header_params",
                                        (64.0, 0.5, 0.0, 0.0))),
            policy=policy,
        )
    model.to_empty(device=dev)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
