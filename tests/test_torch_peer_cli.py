"""The peer-KD recipe (configs/arc18_msml_peer_dec.yaml) through the port's
entry points on the CPU, as a user runs it: `cli.train` on a procedural
rec (no `device_light`: the dataset's float batches, normalized on the
host, with `ori`), `tools.export_frb` of that folder as the next run's
`peer_weights` (the reference's workflow: the trained model becomes the
teacher), two steps and a `--resume`; then `cli.test` (the on-device
sweep's code path and the host sweep), `cli.serve`'s runner and its int8
copy on the folder.

The recipe's structure at one block per iResNet stage, float32, batch 2,
a 4-id rec of 4 views (8 train images) written by the port's
`tools/make_synthetic_rec.py`, with procedural occluders.
"""

import os
import re

import numpy as np
import pytest
import torch

from msml_torch.cli import test as cli_test
from msml_torch.cli import train as cli
from msml_torch.core import checkpoint
from msml_torch.core.config import Config
from msml_torch.nn import iresnet
from msml_torch.train import train_step
from test_torch_sweep import write_bin

RECIPE = {  # configs/arc18_msml_peer_dec.yaml on a 4-id rec, float32
    "fp16": False, "batch_size": 2, "frb_type": "iresnet18",
    "osb_type": "unet", "use_osb": True, "fm_layers": [1, 1, 1, 1],
    "fm_params": [3, 2, "sigmoid", "mul"],
    "peer_params": {"use_ori": True, "use_conv": True, "mask_trans": "conv",
                    "use_decoder": True},
    "header_type": "AMArcFace", "header_params": [64.0, 0.48, 0.0, 0.0],
    "exp_id": 1, "output_prefix": "arc18_msml_peer_dec",
    "dataset": "custom", "num_classes": 4, "nw": 0,
}
PEER = "frb.peer."


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(iresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        yield


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    from msml_torch.tools.make_occluders import main as make_occluders
    from msml_torch.tools.make_synthetic_rec import write_dataset

    base = tmp_path_factory.mktemp("rec")
    write_dataset(str(base / "rec"), ids=4, per_id=4, val_pairs=0, seed=0,
                  log_every=0)
    make_occluders(str(base / "occ"), num=2, seed=0)
    return str(base / "rec"), str(base / "occ")


def run(out, rec, *argv, **over):
    """cli.train's main() on the recipe; -> (state, folder, log)."""
    args = cli.parse_args(["--device", "cpu", "--seed", "0",
                           "--log-every", "1", *argv])
    cfg = Config.from_dict(dict(RECIPE, rec=rec[0], occluder_root=rec[1],
                                out_folder=str(out), **over))
    state = cli.main(args, cfg)
    folder = os.path.join(str(out), "arc18_msml_peer_dec_1")
    with open(os.path.join(folder, "training.log")) as f:
        return state, folder, f.read()


def saved(folder):
    """The model state dict of the folder's latest checkpoint."""
    from msml_torch.core.weight_folder import read_state_dict, weights_path

    return read_state_dict(weights_path(folder))


@pytest.fixture(scope="module")
def first(rec, tmp_path_factory):
    """Two steps of the recipe from scratch, the batches the step saw
    recorded."""
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
        state, folder, log = run(tmp_path_factory.mktemp("first"), rec,
                                 "--steps", "2")
    return state, folder, log, seen


@pytest.fixture(scope="module")
def second(first, rec, tmp_path_factory):
    """The next run: `peer_weights` is the first folder's frb.npz; two
    steps, then a --resume to step 3."""
    from msml_torch.tools import export_frb

    _, folder, _, _ = first
    npz = export_frb.main(export_frb.parse_args(
        ["--weight_folder", folder, "--out",
         str(tmp_path_factory.mktemp("npz") / "frb.npz")]))
    out = tmp_path_factory.mktemp("second")
    state, folder2, log = run(out, rec, "--steps", "2", peer_weights=npz)
    after2 = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, _, log_resumed = run(out, rec, "--steps", "3", "--resume",
                                peer_weights=npz)
    return npz, folder2, log, after2, state, log_resumed


def losses(log):
    return [float(v) for v in re.findall(r" Loss (\S+) Epoch", log)]


def test_recipe_trains_on_host_float_batches(first):
    """The step receives float32 NHWC img and ori from the rec (no
    device_light), and the losses are finite."""
    state, folder, log, seen = first
    assert state.step == 2 and len(seen) == 2
    for b in seen:
        assert b["img"] == (torch.float32, (2, 112, 112, 3))
        assert b["ori"] == (torch.float32, (2, 112, 112, 3))
    assert "data: FaceByRandOccMask, 8 samples" in log
    assert losses(log) and all(np.isfinite(losses(log)))
    sd = saved(folder)
    assert any(k.startswith(PEER) for k in sd)
    assert any(k.startswith("frb.decoder.") for k in sd)


def test_peer_weights_from_export_frb(first, second):
    """The teacher of the second run is the first run's frb, bit for bit,
    after its steps; the log counts the npz's tensors as JAX does."""
    from msml_torch.tools.export_frb import load_npz
    from msml_torch.tools.convert import flatten

    _, folder, _, _ = first
    npz, _, log, after2, _, _ = second
    params = flatten(load_npz(npz)[0])
    n = len(params)
    assert f"loaded {n} peer tensors from {npz}" in log
    # export_frb keeps the frb subtree (its decoder too, as JAX's does) and
    # drops the teacher and the FMs
    assert any(k.startswith("decoder/") for k in params)
    assert not any(k.startswith(("peer", "fm_op")) for k in params)
    frb = saved(folder)
    keys = [k for k in after2 if k.startswith(PEER)
            and not k.endswith(("num_batches_tracked", "features.weight"))]
    assert len(keys) > 50
    for k in keys:
        assert torch.equal(after2[k], frb["frb." + k[len(PEER):]]), k


def test_resume_keeps_the_teacher(second):
    _, folder, _, after2, state, log = second
    assert "backbone resume successfully! step=2" in log
    assert state.step == 3
    sd = state.model.state_dict()
    for k in after2:
        if k.startswith(PEER):
            assert torch.equal(sd[k], after2[k]), k
    assert checkpoint.all_steps(folder) == [2, 3]


def test_cli_test_sweeps_the_folder(second, tmp_path):
    """cli.test on the recipe's folder: the on-device sweep's path and the
    host sweep, each without occlusion, on 20 pairs."""
    _, folder, _, _, _, _ = second
    bin_path = str(tmp_path / "pairs.bin")
    write_bin(bin_path, pairs=20)
    for extra in (["--device-sweep"], []):
        rows = cli_test.main(cli_test.parse_args(
            extra + ["--no-occ", "--weight_folder", folder, "--bin",
                     bin_path, "--device", "cpu", "--repeats", "1"]))
        assert len(rows) == 1 and np.isfinite(rows[0]["avg_acc"])


def test_serve_runner_on_the_folder(second):
    """cli.serve's weight-folder runner, float and int8, on the recipe's
    folder: the float features are the live model's eval forward."""
    from msml_torch.cli.serve import runner_from_weight_folder

    _, folder, _, _, state, _ = second
    x = np.random.RandomState(0).uniform(-1, 1, (2, 112, 112, 3)) \
        .astype(np.float32)
    runner = runner_from_weight_folder(folder, device="cpu", flip=False,
                                       l2_norm=False)
    model = state.model.eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(x).permute(0, 3, 1, 2)
                     .contiguous())[0].numpy()
    np.testing.assert_allclose(runner.infer(x), want, rtol=1e-5, atol=1e-5)
    q = runner_from_weight_folder(folder, device="cpu", quant="int8",
                                  flip=False, l2_norm=False).infer(x)
    cos = (q * want).sum(1) / np.linalg.norm(q, axis=1) / np.linalg.norm(
        want, axis=1)
    assert np.isfinite(q).all() and cos.min() > 0.99, cos


def test_export_serving_on_the_folder(second, tmp_path):
    """tools.export_serving on the recipe's folder: the artifact's server
    answers as the weight-folder runner does; the unused teacher and
    decoder do not enter the exported graph's computation."""
    from msml_torch.cli.serve import (runner_from_artifact,
                                      runner_from_weight_folder)
    from msml_torch.tools import export_serving

    _, folder, _, _, _, _ = second
    out = str(tmp_path / "model.pt2")
    export_serving.main(export_serving.parse_args(
        ["--weight_folder", folder, "--out", out, "--device", "cpu"]))
    x = np.random.RandomState(1).uniform(-1, 1, (2, 112, 112, 3)) \
        .astype(np.float32)
    got = runner_from_artifact(out, device="cpu").infer(x)
    want = runner_from_weight_folder(folder, device="cpu").infer(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
