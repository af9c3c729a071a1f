"""SGD with the reference's learning-rate groups, in torch.optim.

Counterpart of `msml_tpu/train/optim.py:27-96`:
  * the LR groups of `train.py:152-178`: 'osb.' parameters at
    0.01 B / 512, 'frb.fm_ops.' at 0.1 B / 512 and 'classification.' at
    10 lr B / 512 when pretrained, the rest at lr B / 512, with B the batch
    per GPU times the world size; 'peer' parameters are frozen (lr 0, no
    gradient) and left out of the optimizer;
  * `torch.optim.SGD(momentum=0.9, weight_decay=5e-4)` is the JAX update
    exactly: g += wd p; buf = mu buf + g (buf = g on the first step);
    p -= lr buf;
  * the LambdaLR epoch factor multiplies every group's `base_lr` (the
    train step sets each group's lr to it);
  * the clip (`clip_by_global_norm`) is `clip_grad_norm_(..., 5)`'s scale
    max_norm / (norm + 1e-6), capped at 1 (`optim.py:63-68`), with the norm
    taken as JAX takes it, the root of the summed squares.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn


def lr_scale(name: str, cfg, world_size: int = 1) -> float:
    """Absolute lr of the parameter called `name` before the epoch factor
    (`build_lr_scales`, keyed on the port's names)."""
    batch_world = cfg.batch_size * world_size
    base = cfg.lr / 512.0 * batch_world
    if "peer" in name:
        return 0.0  # frozen teacher
    if name.startswith("osb."):
        return 0.01 / 512.0 * batch_world
    if not cfg.pretrained:
        return base
    if name.startswith("classification."):
        return 10.0 * base
    if name.startswith("frb.fm_ops."):
        return 0.1 / 512.0 * batch_world
    return base


def param_groups(model: nn.Module, cfg, world_size: int = 1) -> List[Dict]:
    """One SGD param group per lr, each with its `base_lr`; frozen
    parameters (lr 0 or requires_grad False) are left out."""
    groups: Dict[float, List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        lr = lr_scale(name, cfg, world_size)
        if lr == 0.0:
            p.requires_grad_(False)
        if p.requires_grad:
            groups.setdefault(lr, []).append(p)
    return [{"params": ps, "lr": lr, "base_lr": lr}
            for lr, ps in groups.items()]


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of `params` by min(1, max_norm / (norm + 1e-6))
    in place; -> the norm before the clip. Not `clip_grad_norm_`: on the
    CPU its float32 `vector_norm` is 5e-4 low over the 12.8M entries of
    frb.fc.weight, while `sum` sums in a cascade."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    torch._foreach_mul_(grads, torch.clamp(max_norm / (norm + 1e-6),
                                           max=1.0))
    return norm
