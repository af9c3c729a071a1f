"""On-device occlusion sweep: the qeval_mxnet protocol with block occlusion
and normalization fused into one kernel on the card.

Counterpart of `msml_tpu/eval/occ_sweep_device.py`: sweep lo in {0..90},
protocol 'BB', `repeats` repeats per nonzero ratio, flip-sum features,
evaluate + TAR@FAR. Both copies of the data move to the device once; each
batch goes through `kernels.augment.augment_batch` with its draws (and, for
the gauss fill, its noise) taken from a `torch.Generator` on the device
seeded with `seed`. The draws differ from the JAX sweep's `jax.random`
stream, so only the no-occlusion row is comparable number for number.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from msml_torch import resolve_device
from msml_torch.eval import verification as ver
from msml_torch.eval.occ_sweep import FAR_VALS, roc_acc_and_tarfar
from msml_torch.eval.verification import l2_normalize_np
from msml_torch.kernels.augment import augment_batch


def pil_gray(d: torch.Tensor) -> torch.Tensor:
    """Host-sweep gray convention: PIL 'L' (ITU-R 601-2 in fixed point,
    (R*19595 + G*38470 + B*7471 + 0x8000) >> 16) before the block, then
    [0, 1]. Inputs are integer-valued [0, 255] floats (load_bin output), so
    every intermediate is an integer below 2^24 and exact in float32.
    (N, H, W, 3) -> (N, H, W, 1)."""
    l24 = d[..., 0] * 19595. + d[..., 1] * 38470. + d[..., 2] * 7471. \
        + 32768.
    return (torch.floor(l24 / 65536.0) / 255.0).unsqueeze(-1)


def occlusion_sweep_device(data_list: List[np.ndarray],
                           issame: Sequence[bool],
                           extract_fn: Callable[[torch.Tensor], object],
                           fill_type: str = "black", use_norm: bool = True,
                           is_gray: bool = False, no_occ: bool = False,
                           repeats: int = 10, batch_size: int = 512,
                           seed: int = 0, verbose: bool = True,
                           device="cuda"):
    """data_list: [orig, flipped] (N, H, W, 3) float arrays in [0, 255]
    (data/bin_loader.load_bin output). extract_fn: (B, C, H, W) float32
    tensor on `device` -> (B, D) features (tensor or array)."""
    dev = resolve_device(device)
    lo_list = [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]
    hi_list = [1, 11, 21, 31, 41, 51, 61, 71, 81, 91]
    if no_occ:
        lo_list, hi_list = [0], [1]

    # move both copies to the device once, in [0, 1]
    host = [torch.as_tensor(np.asarray(d), dtype=torch.float32, device=dev)
            for d in data_list]
    data = [pil_gray(d) for d in host] if is_gray else [d / 255.0
                                                        for d in host]
    del host
    n = data[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)

    results = []
    for lo, hi in zip(lo_list, hi_list):
        repeat_time = 1 if lo == 0 else repeats
        noisy = fill_type == "gauss" and (hi > 1 or lo > 0)
        avg_acc = 0.0
        avg_roc = 0.0
        fars = np.zeros(len(FAR_VALS))
        for _rep in range(repeat_time):
            feats = None
            for flip in (0, 1):
                for s in range(0, n, batch_size):
                    batch = data[flip][s:s + batch_size]
                    draws = torch.rand((batch.shape[0], 6), generator=gen,
                                       device=dev)
                    noise = (torch.randn(batch.shape, generator=gen,
                                         device=dev) if noisy else None)
                    img = augment_batch(batch, draws, noise, lo=lo, hi=hi,
                                        fill=fill_type, use_norm=use_norm)
                    f = extract_fn(img)
                    if isinstance(f, torch.Tensor):
                        f = f.detach().float().cpu().numpy()
                    if feats is None:
                        feats = np.zeros((n, f.shape[1]))
                    feats[s:s + batch.shape[0]] += f
            norm_feats = l2_normalize_np(feats)
            _, _, accuracy, _, _, _ = ver.evaluate(norm_feats, issame)
            avg_acc += float(np.mean(accuracy))
            racc, tf = roc_acc_and_tarfar(feats, issame)
            avg_roc += racc
            fars += tf
        row = {"lo": lo, "hi": hi, "avg_acc": avg_acc / repeat_time,
               "roc_acc": avg_roc / repeat_time,
               "tar_at_far": (fars / repeat_time).tolist()}
        results.append(row)
        if verbose:
            print("[%d ~ %d] | [avg_acc]: %.4f" % (lo, hi, row["avg_acc"]))
    return results
