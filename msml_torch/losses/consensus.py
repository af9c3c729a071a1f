"""Structure-via-consensus segmentation loss (CVPR'20), NCHW.

Counterpart of `msml_tpu/losses/consensus.py:33-92`: the closed form of
`tricks/consensus_loss.py:28-179` with alpha 10, beta 5 and reduce 'idx'
(the reference's training setting, `train.py:229`). The blob ids are the
fixed enumeration 0..num_blob_ids-1 (binary occlusion masks, blobs ==
target, `train.py:255-258`); an absent blob is skipped as the reference's
`unique()` loop skips it.

Per blob s, with prob = softmax(logit, channel) and t the per-(n, c) blob
mean of prob (0 where sample n lacks s):
  loss_avg = mean_n of -log t[n, s] (0 for samples without the blob)
  loss_dev = sum over in-blob pixels of sum_c t (log t - log prob), divided
             by the in-blob entries; since t is constant over the blob this
             is cnt * sum_c t log t - sum_c t * (sum over the blob of log p)
  loss_s   = alpha * loss_avg + beta * loss_dev
total = sum_s present(s) * loss_s / sum_s present(s)
"""

from __future__ import annotations

import torch


def _blob_loss(p: torch.Tensor, logp: torch.Tensor, in_blob: torch.Tensor,
               s: int, alpha: float, beta: float):
    """(loss, present) of blob s; p, logp (N, C, H, W), in_blob (N, H, W)."""
    mask = in_blob[:, None].to(p.dtype)                       # (N,1,H,W)
    cnt = mask.sum((2, 3))                                    # (N,1)
    has_blob = cnt[:, 0] > 0
    total_p = (p * mask).sum((2, 3))                          # (N,C)
    total_logp = (logp * mask).sum((2, 3))                    # (N,C)
    m = torch.where(cnt > 0, total_p / torch.clamp(cnt, min=1.0), 0.0)
    loss_avg = torch.where(
        has_blob, -torch.log(torch.clamp(m[:, s], min=1e-30)), 0.0).mean()
    logm = torch.where(m > 0, torch.log(torch.clamp(m, min=1e-30)), 0.0)
    dev = (cnt[:, 0] * (m * logm).sum(-1) - (m * total_logp).sum(-1)).sum()
    loss_dev = dev / torch.clamp(cnt.sum() * p.shape[1], min=1.0)
    return alpha * loss_avg + beta * loss_dev, has_blob.any()


def structure_consensus_loss(logit: torch.Tensor, blobs: torch.Tensor,
                             alpha: float = 10.0, beta: float = 5.0,
                             num_blob_ids: int = 2) -> torch.Tensor:
    """`StructureConsensuLossFunction(10.0, 5.0, 'idx', 'idx')`.

    logit: (N, C, H, W) pre-softmax seg logits (C = 2); blobs: (N, H, W)
    integer map, for MSML the occlusion mask (1 = clean, 0 = occluded)."""
    logp = torch.log_softmax(logit.float(), dim=1)
    p = logp.exp()
    total = logit.new_zeros((), dtype=torch.float32)
    count = logit.new_zeros((), dtype=torch.float32)
    for s in range(num_blob_ids):
        loss_s, present = _blob_loss(p, logp, blobs == s, s, alpha, beta)
        w = present.float()
        total = total + w * loss_s
        count = count + w
    return total / torch.clamp(count, min=1.0)
