"""Classification loss (reference `train.py:230,262`).

Counterpart of `msml_tpu/losses/ce.py:9-13`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss: the batch mean of -log p_y, in float32."""
    return F.cross_entropy(logits.float(), label.long())
