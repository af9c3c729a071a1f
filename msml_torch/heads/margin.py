"""Margin-softmax classification heads.

Counterpart of `msml_tpu/heads/margin.py:27-151` (reference
`headers/margin_losses.py`):
  * Softmax   — plain FC layer (`margin_losses.py:18-68`)
  * AMCosFace — logit cos(theta) - (m - k (theta_y - a)) at the target class
                (`margin_losses.py:203-305`)
  * AMArcFace — logit cos(theta + m - k (theta_y - a)) at the target class
                (`margin_losses.py:318-418`)

All three honour the `label == -1` rule of PartialFC
(`margin_losses.py:275-299,390-417`): such rows get no margin. The margins
are functions of a cosine matrix with a one-hot select, as in the JAX
package. The heads compute in float32, outside autocast.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from msml_torch.core.precision import f32_region


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), with the clamp inside the sqrt: the values of
    `F.normalize`, and a finite gradient at x = 0 (the clamp routes none to
    the sum of squares), as `msml_tpu/heads/margin.py:27-39`."""
    sq = (x * x).sum(dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def cosine_logits(embedding: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """cos(theta) = normalize(emb) @ normalize(W)^T in float32; weight is
    (num_classes, dim) like the reference Parameter."""
    with f32_region(embedding.device.type):
        return l2_normalize(embedding.float()) @ l2_normalize(
            weight.float()).t()


def _target_margin(cosine: torch.Tensor, label: torch.Tensor, m: float,
                   a: float, k: float):
    """Per-row margin m - k (theta_y - a) and its one-hot mask; rows with
    label == -1 get a zero mask."""
    valid = label >= 0
    safe = torch.where(valid, label, 0).long()
    cos_y = cosine.gather(1, safe[:, None])[:, 0]
    theta_y = torch.acos(torch.clamp(cos_y, -1.0, 1.0))
    margin = m - k * (theta_y - a)
    one_hot = F.one_hot(safe, cosine.shape[1]).to(cosine.dtype)
    return margin, one_hot * valid[:, None].to(cosine.dtype)


def amcos_margin(cosine: torch.Tensor, label: torch.Tensor, s: float = 64.0,
                 m: float = 0.4, a: float = 1.2,
                 k: float = 0.1) -> torch.Tensor:
    """AMCosFace: s (cos(theta) - (m - k (theta_y - a))) at the target."""
    margin, one_hot = _target_margin(cosine, label, m, a, k)
    return (cosine - one_hot * margin[:, None]) * s


def amarc_margin(cosine: torch.Tensor, label: torch.Tensor, s: float = 64.0,
                 m: float = 0.5, a: float = 1.2,
                 k: float = 0.1) -> torch.Tensor:
    """AMArcFace: s cos(theta + (m - k (theta_y - a))) at the target, with
    the reference's arccos -> add -> cos round trip on every entry."""
    margin, one_hot = _target_margin(cosine, label, m, a, k)
    theta = torch.acos(torch.clamp(cosine, -1.0, 1.0))
    return torch.cos(theta + one_hot * margin[:, None]) * s


def softmax_margin(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Identity margin (plain softmax head)."""
    del label
    return logits


def get_margin_fn(header_type: str, header_params) -> Callable:
    """(logits, label) -> logits margin by config name (reference
    `backbones/msml.py:124-148`)."""
    s, m, a, k = header_params
    if "Softmax" in header_type:
        return softmax_margin
    if "AMCosFace" in header_type:
        return lambda cosine, label: amcos_margin(cosine, label, s, m, a, k)
    if "AMArcFace" in header_type:
        return lambda cosine, label: amarc_margin(cosine, label, s, m, a, k)
    raise ValueError(f"Header type error: {header_type}")


class SoftmaxHead(nn.Module):
    """Plain FC head (`margin_losses.py:18-68`): weight (num_classes, dim)
    xavier-uniform, bias zeros (drawn by `nn.common.init_parameters`)."""

    def __init__(self, num_classes: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_classes, dim))
        self.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, embedding: torch.Tensor,
                label: torch.Tensor) -> torch.Tensor:
        del label
        with f32_region(embedding.device.type):
            return embedding.float() @ self.weight.t() + self.bias


class MarginHead(nn.Module):
    """AMCosFace / AMArcFace full-class head (`margin_losses.py:203-428`):
    normalise -> matmul -> margin -> scale."""

    def __init__(self, num_classes: int, dim: int,
                 header_type: str = "AMArcFace", s: float = 64.0,
                 m: float = 0.5, a: float = 0.0, k: float = 0.0):
        super().__init__()
        if header_type not in ("AMArcFace", "AMCosFace"):
            raise ValueError(f"Header type error: {header_type}")
        self.margin_fn = get_margin_fn(header_type, (s, m, a, k))
        self.weight = nn.Parameter(torch.empty(num_classes, dim))

    def forward(self, embedding: torch.Tensor,
                label: torch.Tensor) -> torch.Tensor:
        with f32_region(embedding.device.type):
            return self.margin_fn(cosine_logits(embedding, self.weight),
                                  label)
