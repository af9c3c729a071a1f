"""The port's train-then-sweep round trip on the CPU.

A folder that `msml_torch.cli.train` wrote (`config.yaml` and
`ckpt/<step>.pt`, no `backbone.pth`) is a weight folder: `load_weight_folder`
restores its latest checkpoint, as `msml_tpu/core/weight_folder.py` restores
the latest orbax checkpoint, and `msml_torch.cli.test --device-sweep` runs
on it. A folder with only `backbone.pth` still loads; one with neither
raises and names both. arc18_msml's structure with one block per iResNet
stage, float32, 16 classes, batch 2, synthetic data, `--device cpu`.

The `.bin` pair files here hold binary PPM images, which the port decodes
without OpenCV (the card's machine has none) into the arrays the JAX
package's loader gives.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from msml_tpu.data.bin_loader import load_bin as jax_load_bin
from msml_torch.cli import test as cli_test
from msml_torch.cli import train as cli_train
from msml_torch.core import checkpoint
from msml_torch.core.config import Config
from msml_torch.core.weight_folder import load_weight_folder, weights_path
from msml_torch.data.bin_loader import load_bin, ppm_encode
from msml_torch.nn.iresnet import IRESNET_LAYERS

SMALL = dict(chip_smoke.ARC18_MSML, dataset="synthetic", batch_size=2,
             num_classes=16, fp16=False)


def write_ppm_bin(path, pairs=20, seed=0):
    """`pairs` pairs of 112 x 112 PPM images: same pairs differ by +3."""
    rng = np.random.RandomState(seed)
    bins, issame = [], []
    for p in range(pairs):
        a = rng.randint(0, 256, (112, 112, 3)).astype(np.uint8)
        b = (np.clip(a.astype(int) + 3, 0, 255).astype(np.uint8)
             if p % 2 == 0 else
             rng.randint(0, 256, (112, 112, 3)).astype(np.uint8))
        bins += [ppm_encode(a), ppm_encode(b)]
        issame.append(p % 2 == 0)
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return path


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """-> (train state, the folder of a 3-step `cli.train` run)."""
    out = tmp_path_factory.mktemp("train")
    args = cli_train.parse_args(["--device", "cpu", "--seed", "0",
                                 "--steps", "3"])
    state = cli_train.main(args, Config.from_dict(dict(SMALL,
                                                       out_folder=str(out))))
    return state, os.path.join(str(out), "arc18_msml_1")


def _features(model, seed=1):
    x = np.random.RandomState(seed).randn(2, 3, 112, 112).astype(np.float32)
    model.eval()
    with torch.inference_mode():
        feature, seg = model(torch.from_numpy(x))
    return feature, seg


def _config_only(folder, tmp_path):
    shutil.copy(os.path.join(folder, "config.yaml"), tmp_path)
    return str(tmp_path)


def test_trained_folder_reads_its_latest_checkpoint(trained):
    _, folder = trained
    assert checkpoint.all_steps(folder) == [3]
    assert not os.path.exists(os.path.join(folder, "backbone.pth"))
    assert weights_path(folder) == checkpoint.checkpoint_path(folder, 3)


def test_trained_folder_gives_the_trained_features(trained):
    """The loaded model has no head, is in eval mode, and its eval forward
    equals the trained model's own."""
    state, folder = trained
    cfg, model = load_weight_folder(folder, device="cpu")
    assert model.classification is None and not model.training
    assert cfg.num_classes == 16
    got, want = _features(model), _features(state.model)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_cli_sweep_on_the_trained_folder(trained, tmp_path):
    _, folder = trained
    bin_path = write_ppm_bin(str(tmp_path / "t.bin"))
    rows = cli_test.main(cli_test.parse_args(
        ["--device-sweep", "--no-occ", "--device", "cpu", "--weight_folder",
         folder, "--bin", bin_path]))
    assert len(rows) == 1 and np.isfinite(rows[0]["avg_acc"])
    assert 0.0 <= rows[0]["avg_acc"] <= 1.0


@pytest.mark.parametrize("wrapped", [False, True],
                         ids=["state_dict", "under_state_dict_key"])
def test_backbone_only_folder_still_loads(trained, tmp_path, wrapped):
    """An exported backbone.pth (the head's weight included), bare or under
    "state_dict", loads strict and gives the trained features."""
    state, folder = trained
    sd = state.model.state_dict()
    torch.save({"state_dict": sd} if wrapped else sd,
               str(tmp_path / "backbone.pth"))
    path = _config_only(folder, tmp_path)
    assert weights_path(path) == os.path.join(path, "backbone.pth")
    _, model = load_weight_folder(path, device="cpu")
    for g, w in zip(_features(model), _features(state.model)):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_folder_without_weights_names_both_paths(trained, tmp_path):
    path = _config_only(trained[1], tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        load_weight_folder(path, device="cpu")
    assert os.path.join(path, "ckpt") in str(err.value)
    assert os.path.join(path, "backbone.pth") in str(err.value)


def test_ppm_bin_loads_as_the_jax_loader_reads_it(tmp_path, monkeypatch):
    """Without OpenCV the port reads a PPM `.bin` to the arrays that the
    JAX package's loader (OpenCV) reads from it."""
    path = write_ppm_bin(str(tmp_path / "t.bin"), pairs=6, seed=3)
    want, want_same = jax_load_bin(path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got, same = load_bin(path)
    assert same == want_same
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
