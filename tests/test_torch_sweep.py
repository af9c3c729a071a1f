"""The port's on-device sweep and its metrics against the JAX package, on
the CPU.

With no occlusion there is no randomness, so `occlusion_sweep_device` of
both packages must give the same features, accuracy and TAR@FAR from the
same `.bin` (built as in tests/test_device_augment.py:110-166).
"""

import pickle

import numpy as np
import pytest
import torch

from msml_tpu.data.bin_loader import load_bin as jax_load_bin
from msml_tpu.data.recordio import imencode
from msml_tpu.eval.occ_sweep import roc_acc_and_tarfar as jax_roc
from msml_tpu.eval.occ_sweep_device import \
    occlusion_sweep_device as jax_sweep
from msml_tpu.eval.occ_sweep_device import pil_gray as jax_pil_gray
from msml_torch.data.bin_loader import load_bin
from msml_torch.eval.occ_sweep import roc_acc_and_tarfar
from msml_torch.eval.occ_sweep_device import occlusion_sweep_device, pil_gray


def write_bin(path, pairs=40, seed=0):
    """`pairs` pairs (10-fold KFold needs same + diff pairs per fold)."""
    rng = np.random.RandomState(seed)
    bins, issame = [], []
    for p in range(pairs):
        a = rng.randint(0, 255, (112, 112, 3), np.uint8)
        bins.append(imencode(a))
        if p % 2 == 0:
            bins.append(imencode(np.clip(a.astype(int) + 3, 0,
                                         255).astype(np.uint8)))
            issame.append(True)
        else:
            bins.append(imencode(rng.randint(0, 255, (112, 112, 3),
                                             np.uint8)))
            issame.append(False)
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return path


def subsample(x: np.ndarray) -> np.ndarray:
    """A deterministic stand-in for the model: 64 NHWC pixels per image."""
    return x.reshape(x.shape[0], -1)[:, ::97][:, :64]


@pytest.mark.parametrize("is_gray", [False, True])
def test_no_occ_sweep_matches_jax(tmp_path, is_gray):
    path = write_bin(str(tmp_path / "t.bin"))
    data_list, issame = load_bin(path)
    jdata, jissame = jax_load_bin(path)
    assert issame == jissame
    for a, b in zip(data_list, jdata):
        np.testing.assert_array_equal(a, b)

    feats = {"jax": [], "port": []}

    def jax_extract(x):
        f = subsample(np.asarray(x, np.float32))
        feats["jax"].append(f)
        return f

    def port_extract(x):
        assert isinstance(x, torch.Tensor) and x.shape[1] == (
            1 if is_gray else 3)
        f = subsample(x.permute(0, 2, 3, 1).numpy())  # NCHW -> NHWC
        feats["port"].append(f)
        return torch.from_numpy(f)

    want = jax_sweep(jdata, jissame, jax_extract, no_occ=True,
                     is_gray=is_gray, use_norm=True, batch_size=10,
                     verbose=False)
    got = occlusion_sweep_device(data_list, issame, port_extract,
                                 no_occ=True, is_gray=is_gray,
                                 use_norm=True, batch_size=10,
                                 verbose=False, device="cpu")
    np.testing.assert_array_equal(np.concatenate(feats["port"]),
                                  np.concatenate(feats["jax"]))
    assert len(got) == len(want) == 1
    assert got[0]["avg_acc"] == want[0]["avg_acc"]
    assert got[0]["roc_acc"] == want[0]["roc_acc"]
    assert got[0]["tar_at_far"] == want[0]["tar_at_far"]


def test_pil_gray_matches_jax_and_pil():
    from PIL import Image

    a = np.random.RandomState(0).randint(0, 256, (3, 17, 23, 3), np.uint8)
    got = pil_gray(torch.from_numpy(a.astype(np.float32))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pil_gray(a)))
    ref = np.stack([np.asarray(Image.fromarray(x).convert("L"), np.float32)
                    for x in a]) / 255.0
    np.testing.assert_array_equal(got[..., 0], ref)


@pytest.mark.parametrize("seed,levels", [(0, None), (1, None), (2, 4),
                                         (3, 2)])
def test_roc_acc_and_tarfar_matches_sklearn(seed, levels):
    """Own ROC curve vs the sklearn-based JAX-package function, on random
    features; quantized features make tied distances (the collinear-point
    dropping of roc_curve matters there)."""
    rs = np.random.RandomState(seed)
    feats = rs.randn(600, 16)
    feats[1::2] += rs.uniform(0, 2) * feats[0::2]
    if levels is not None:
        feats = np.round(feats * levels) / levels
    issame = list(rs.rand(300) < 0.5)
    acc, tarfar = roc_acc_and_tarfar(feats, issame)
    want_acc, want_tarfar = jax_roc(feats, issame)
    assert acc == want_acc
    np.testing.assert_array_equal(tarfar, want_tarfar)
