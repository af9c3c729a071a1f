"""The LightCNN-29v2 gray recipe (configs/lightcnn_msml.yaml) through the
port's entry points on the CPU, as a user runs it: `cli.train --config`
on the yaml (here with a small batch, float32 and a synthetic dataset of
4 classes written into a copy of it), then on the folder it writes
`cli.test` (the on-device sweep's code path and the host sweep, gray
128 x 128 pairs), `cli.serve`'s runner and its int8 copy, `cli.embed`
and `tools.export_serving`, each on gray input of shape (..., 128, 128, 1).

The recipe at full width and depth (LightCNN layers (1, 2, 3, 4), the
1-channel U-Net OSB, four FMCnn [3, 2, tanh, add], Softmax), batch 2; the
kernels run their plain versions. Tolerances: a runner's or an
artifact's float features against the live model's forward rtol and atol
1e-5 (tests/test_torch_peer_cli.py's); the int8 features' cosine to the
float ones > 0.99 (its bound).
"""

import os
import pickle
import re

import numpy as np
import pytest
import torch
import yaml

from msml_torch.cli import test as cli_test
from msml_torch.cli import train as cli
from msml_torch.data.bin_loader import ppm_encode
from msml_torch.nn.lightcnn import LightCNN29v2
from msml_torch.train import train_step
from test_torch_lightcnn_msml import LIGHT_YAML

RUN = dict(dataset="synthetic", batch_size=2, fp16=False, num_classes=4)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of `cli.train --config <the yaml with RUN>`, the batches
    the step saw recorded; -> (state, folder, log, batches, the yaml)."""
    base = tmp_path_factory.mktemp("light")
    with open(LIGHT_YAML) as f:
        user = yaml.safe_load(f)
    user.update(RUN, out_folder=str(base / "out"))
    path = str(base / "lightcnn_msml.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(user, f)
    seen = []
    real = train_step.make_train_step

    def spy(cfg):
        step = real(cfg)

        def wrapped(state, batch, lr_factor):
            seen.append({k: (v.dtype, tuple(v.shape))
                         for k, v in batch.items()})
            return step(state, batch, lr_factor)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_step, "make_train_step", spy)
        state = cli.main(cli.parse_args(
            ["--config", path, "--device", "cpu", "--seed", "0",
             "--steps", "2", "--log-every", "1"]))
    folder = str(base / "out" / "light_msml_1")
    with open(os.path.join(folder, "training.log")) as f:
        return state, folder, f.read(), seen, path


def test_cli_train_takes_the_yaml(trained):
    """The yaml trains: LightCNN with the 1-channel OSB, float32 gray
    128 x 128 batches from the host (no device_light in the yaml), finite
    losses, the yaml copied into the folder, a checkpoint."""
    state, folder, log, seen, path = trained
    assert isinstance(state.model.frb, LightCNN29v2) and state.step == 2
    assert len(seen) == 2
    for b in seen:
        assert b["img"] == (torch.float32, (2, 128, 128, 1))
        assert b["msk"][1] == (2, 128, 128)
    losses = [float(v) for v in re.findall(r" Loss (\S+) Epoch", log)]
    assert losses and all(np.isfinite(losses))
    with open(os.path.join(folder, "config.yaml")) as f, open(path) as g:
        assert f.read() == g.read()
    assert os.path.exists(os.path.join(folder, "ckpt", "2.pt"))


def test_resume_continues_the_folder(trained, tmp_path):
    """--resume on a copy of the folder restores the LightCNN checkpoint
    (model, optimizer, step) and runs on to step 3."""
    import shutil

    _, folder, _, _, path = trained
    out = tmp_path / "out"
    shutil.copytree(folder, out / "light_msml_1")
    with open(path) as f:
        user = yaml.safe_load(f)
    user["out_folder"] = str(out)
    cfg_path = str(tmp_path / "lightcnn_msml.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(user, f)
    state = cli.main(cli.parse_args(
        ["--config", cfg_path, "--device", "cpu", "--seed", "0", "--steps",
         "3", "--resume"]))
    with open(out / "light_msml_1" / "training.log") as f:
        assert "backbone resume successfully! step=2" in f.read()
    assert state.step == 3


def gray_pairs(path, pairs=20, seed=0):
    """A .bin of `pairs` 128 x 128 PPM pairs, half of them near copies."""
    rng = np.random.RandomState(seed)
    bins, issame = [], []
    for p in range(pairs):
        a = rng.randint(0, 255, (128, 128, 3), np.uint8)
        b = (np.clip(a.astype(int) + 3, 0, 255).astype(np.uint8)
             if p % 2 == 0 else rng.randint(0, 255, (128, 128, 3), np.uint8))
        bins += [ppm_encode(a), ppm_encode(b)]
        issame.append(p % 2 == 0)
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return path


def test_cli_test_sweeps_the_folder(trained, tmp_path):
    """cli.test on the folder: the on-device sweep's path and the host
    sweep (BB and NB), without occlusion, on 20 gray pairs."""
    _, folder, _, _, _ = trained
    bin_path = gray_pairs(str(tmp_path / "pairs.bin"))
    for extra in (["--device-sweep"], ["--protocol", "BB"],
                  ["--protocol", "NB"]):
        rows = cli_test.main(cli_test.parse_args(
            extra + ["--no-occ", "--weight_folder", folder, "--bin",
                     bin_path, "--device", "cpu", "--repeats", "1"]))
        assert len(rows) == 1 and np.isfinite(rows[0]["avg_acc"]), extra


def live(state, x):
    """The trained model's eval forward on NHWC images, taken to NCHW as
    the entry points take them."""
    from msml_torch.train.train_step import nchw_float

    model = state.model.eval()
    with torch.inference_mode():
        return model(nchw_float(torch.from_numpy(x)))[0].numpy()


def test_serve_runner_on_the_folder(trained):
    """cli.serve's weight-folder runner on gray (2, 128, 128, 1) input:
    the float features are the live model's, the int8 copy's close."""
    from msml_torch.cli.serve import runner_from_weight_folder

    state, folder, _, _, _ = trained
    x = np.random.RandomState(0).uniform(0, 1, (2, 128, 128, 1)) \
        .astype(np.float32)
    runner = runner_from_weight_folder(folder, device="cpu", flip=False,
                                       l2_norm=False)
    want = live(state, x)
    assert want.shape == (2, 256)
    np.testing.assert_allclose(runner.infer(x), want, rtol=1e-5, atol=1e-5)
    q = runner_from_weight_folder(folder, device="cpu", quant="int8",
                                  flip=False, l2_norm=False).infer(x)
    cos = (q * want).sum(1) / np.linalg.norm(q, axis=1) / np.linalg.norm(
        want, axis=1)
    assert np.isfinite(q).all() and cos.min() > 0.99, cos


def test_serve_preprocesses_gray_images(trained):
    """A served image goes through the JAX package's gray folder transform
    (`msml_tpu/eval/folder_eval.py::tensorize_folder_img`, the reference's
    qeval_folder gray): an RGB PPM becomes the (128, 128, 1) input of the
    model, without input normalization (`use_norm` is off for LightCNN)."""
    from msml_tpu.eval.folder_eval import tensorize_folder_img
    from msml_torch.cli.serve import runner_from_weight_folder

    _, folder, _, _, _ = trained
    runner = runner_from_weight_folder(folder, device="cpu", flip=False,
                                       l2_norm=False)
    assert runner.input_shape == (128, 128, 1)
    img = np.random.RandomState(2).randint(0, 255, (128, 128, 3), np.uint8)
    x = runner.preprocess_image(ppm_encode(img))
    assert x.shape == (128, 128, 1)
    from PIL import Image

    want = tensorize_folder_img(Image.fromarray(img), (128, 128), False,
                                True, flip=False)
    np.testing.assert_array_equal(x, want)


def test_embed_on_the_folder(trained, tmp_path):
    """cli.embed over gray-converted PPM files: the flip-summed,
    normalized features of the folder's model."""
    from msml_torch.cli import embed
    from msml_torch.eval.folder_eval import tensorize_folder_img
    from msml_torch.eval.verification import l2_normalize_np

    state, folder, _, _, _ = trained
    src = tmp_path / "src"
    src.mkdir()
    rs = np.random.RandomState(3)
    imgs = [rs.randint(0, 255, (128, 128, 3), np.uint8) for _ in range(2)]
    for i, im in enumerate(imgs):
        (src / f"{i}.ppm").write_bytes(ppm_encode(im))
    feats, names = embed.main(embed.parse_args(
        ["--weight_folder", folder, "--src", str(src), "--out",
         str(tmp_path / "f.npy"), "--device", "cpu"]))
    assert names == ["0.ppm", "1.ppm"] and feats.shape == (2, 256)
    want = sum(live(state, np.stack([tensorize_folder_img(
        im, (128, 128), False, True, flip=flip) for im in imgs])
        .astype(np.float32)) for flip in (False, True))
    np.testing.assert_allclose(feats, l2_normalize_np(want), rtol=1e-4,
                               atol=1e-5)


def test_export_serving_on_the_folder(trained, tmp_path):
    """tools.export_serving on the folder: a (b, 128, 128, 1) program whose
    server answers as the weight-folder runner does."""
    import json

    from msml_torch.cli.serve import (runner_from_artifact,
                                      runner_from_weight_folder)
    from msml_torch.tools import export_serving

    _, folder, _, _, _ = trained
    out = str(tmp_path / "model.pt2")
    export_serving.main(export_serving.parse_args(
        ["--weight_folder", folder, "--out", out, "--device", "cpu"]))
    with open(out + ".json") as f:
        meta = json.load(f)
    assert meta["input_hwc"] == [128, 128, 1] and meta["dim"] == 256
    assert meta["use_norm"] is False and meta["network"] == "lightcnn"
    x = np.random.RandomState(1).uniform(0, 1, (2, 128, 128, 1)) \
        .astype(np.float32)
    got = runner_from_artifact(out, device="cpu").infer(x)
    want = runner_from_weight_folder(folder, device="cpu").infer(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gray_input_runs_in_nchw(trained):
    """A gray NHWC batch permuted to (B, 1, H, W) counts as contiguous but
    carries channels_last strides, which cuDNN would follow through every
    conv after it (and a `torch.export` program then meets views it cannot
    take): the entry points copy it to NCHW strides first
    (`train_step.nchw_float`), so the convs see NCHW."""
    from msml_torch.tools.export_serving import EvalForward
    from msml_torch.train.train_step import make_eval_step, nchw_float

    state, _, _, _, _ = trained
    model = state.model.eval()
    x = np.random.RandomState(4).uniform(0, 1, (2, 128, 128, 1)) \
        .astype(np.float32)
    assert nchw_float(torch.from_numpy(x)).stride() == (128 * 128,) * 2 + (
        128, 1)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(out.is_contiguous()))
        for m in (model.osb.conv1, model.frb.conv1.filter)]
    try:
        with torch.inference_mode():
            EvalForward(model)(torch.from_numpy(x))
        make_eval_step(model)(x)
    finally:
        for h in hooks:
            h.remove()
    assert seen == [True] * 4
