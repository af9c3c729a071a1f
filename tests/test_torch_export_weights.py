"""Weights out of the port, held against the JAX package on the CPU.

`tools/convert.py::jax_from_state_dict` inverts `state_dict_from_jax`
exactly and gives what `msml_tpu.tools.import_torch.import_msml_checkpoint`
gives; the `backbone.pth` that `python -m msml_torch.tools.export_torch`
writes equals the JAX exporter's file for the same weights and loads into
JAX's trees and the port's weight folder; the `.npz` of `python -m
msml_torch.tools.export_frb` reads back through JAX's `load_npz`, and the
port's `load_npz` reads JAX's. arc18_msml's structure with one block per
iResNet stage and a 16-class head, numpy-drawn weights."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

import chip_smoke
from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
from msml_tpu.nn.msml import msml_from_config as jax_msml
from msml_tpu.tools import export_frb as jax_export_frb
from msml_tpu.tools.export_torch import export_msml_state_dict
from msml_tpu.tools.import_torch import import_msml_checkpoint
from msml_torch.core.config import save_yaml
from msml_torch.core.weight_folder import load_weight_folder
from msml_torch.nn.iresnet import IRESNET_LAYERS
from msml_torch.tools import export_frb, export_torch
from msml_torch.tools.convert import (flatten, jax_from_state_dict,
                                      state_dict_from_jax, unflatten)
from tests.test_torch_nn import arc18_configs, random_variables

CLASSES = 16


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        yield


def jax_trees(seed=0):
    """numpy-drawn flax (params, batch_stats) of shallow arc18_msml with a
    16-class head."""
    jcfg, _ = arc18_configs()
    model = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    v = random_variables(model, np.zeros((1, 112, 112, 3), np.float32),
                         train=False, seed=seed)
    params = dict(jax.device_get(v["params"]))
    params["classification"] = {"weight": np.random.RandomState(
        seed + 7).uniform(-0.1, 0.1, (CLASSES, 512)).astype(np.float32)}
    return params, jax.device_get(v["batch_stats"])


def assert_trees_equal(a, b):
    fa, fb = traverse_util.flatten_dict(a), traverse_util.flatten_dict(b)
    assert fa.keys() == fb.keys(), sorted(set(fa) ^ set(fb))[:5]
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


def assert_state_dicts_equal(a, b):
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:5]
    for k in a:
        x, y = torch.as_tensor(np.asarray(a[k])), torch.as_tensor(
            np.asarray(b[k]))
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert torch.equal(x, y), k


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


@pytest.fixture(scope="module")
def folder(trees, tmp_path_factory):
    """A port weight folder: config.yaml and ckpt/5.pt as `cli.train`
    writes them (the state dict under "model")."""
    out = tmp_path_factory.mktemp("folder")
    save_yaml(dict(chip_smoke.ARC18_MSML, dataset="synthetic",
                   num_classes=CLASSES, fp16=False),
              str(out / "config.yaml"))
    os.makedirs(out / "ckpt")
    torch.save({"model": state_dict_from_jax(*trees), "step": 5},
               str(out / "ckpt" / "5.pt"))
    return str(out)


@pytest.mark.parametrize("tree", ["params", "batch_stats"])
def test_inverse_round_trips_exactly(trees, tree):
    back = jax_from_state_dict(state_dict_from_jax(*trees))
    assert_trees_equal(trees[tree == "batch_stats"],
                       back[tree == "batch_stats"])


def test_state_dict_round_trips_exactly(trees):
    sd = state_dict_from_jax(*trees)
    assert_state_dicts_equal(sd, state_dict_from_jax(
        *jax_from_state_dict(sd)))


@pytest.mark.parametrize("seed", [0, 3])
def test_inverse_is_jax_import(seed):
    """On a state dict of the port's own model (perturbed running stats),
    the inverse gives JAX's importer's trees."""
    from msml_torch.nn.msml import msml_from_config

    _, tcfg = arc18_configs()
    tcfg.num_classes = CLASSES
    model = msml_from_config(tcfg, policy=None, device="cpu", seed=seed,
                             head=True)
    rs = np.random.RandomState(seed)
    sd = {k: (v + torch.from_numpy(rs.uniform(0.1, 0.5, v.shape).astype(
        np.float32)) if k.endswith(("running_mean", "running_var")) else v)
        for k, v in model.state_dict().items()}
    p, s = jax_from_state_dict(sd)
    jp, js = import_msml_checkpoint(sd)
    assert_trees_equal(p, jp)
    assert_trees_equal(s, js)


def test_flatten_is_flax_flatten(trees):
    params, _ = trees
    flat = flatten(params, "params")
    want = {"params/" + "/".join(k): v
            for k, v in traverse_util.flatten_dict(params).items()}
    assert flat.keys() == want.keys()
    assert_trees_equal(unflatten(flatten(params)), params)


def test_export_torch_is_jax_export(trees, folder, tmp_path):
    """The port's backbone.pth: float32, num_batches_tracked 0, features
    scale 1, key for key the JAX exporter's file of the same trees."""
    out = str(tmp_path / "backbone.pth")
    export_torch.main(export_torch.parse_args(
        ["--weight_folder", folder, "--out", out]))
    got = torch.load(out, map_location="cpu", weights_only=True)
    want = {k: torch.from_numpy(np.array(
        v, np.int64 if v.dtype == np.int64 else np.float32))
        for k, v in export_msml_state_dict(*trees).items()}
    assert_state_dicts_equal(got, want)
    assert got["frb.features.weight"].eq(1).all()
    assert all(v.dtype == torch.float32 for k, v in got.items()
               if not k.endswith("num_batches_tracked"))
    assert all(int(v) == 0 for k, v in got.items()
               if k.endswith("num_batches_tracked"))


def test_export_torch_read_by_jax_import(trees, folder, tmp_path):
    out = str(tmp_path / "backbone.pth")
    export_torch.main(export_torch.parse_args(
        ["--weight_folder", folder, "--out", out]))
    p, s = import_msml_checkpoint(torch.load(out, map_location="cpu"))
    assert_trees_equal(p, trees[0])
    assert_trees_equal(s, trees[1])


def test_export_torch_read_by_weight_folder(folder, tmp_path):
    """config.yaml + the exported backbone.pth load strict into the same
    model as the checkpoint did."""
    out = tmp_path / "exported"
    out.mkdir()
    shutil.copy(os.path.join(folder, "config.yaml"), out / "config.yaml")
    export_torch.main(export_torch.parse_args(
        ["--weight_folder", folder, "--out", str(out / "backbone.pth")]))
    _, want = load_weight_folder(folder, device="cpu")
    _, got = load_weight_folder(str(out), device="cpu")
    assert_state_dicts_equal(got.state_dict(), want.state_dict())


def test_export_frb_read_by_jax_load_npz(trees, folder, tmp_path):
    out = export_frb.main(export_frb.parse_args(
        ["--weight_folder", folder, "--out", str(tmp_path / "frb")]))
    assert out.endswith("frb.npz")
    p, s = jax_export_frb.load_npz(out)
    assert_trees_equal(p, trees[0]["frb"])
    assert_trees_equal(s, trees[1]["frb"])


def test_load_npz_reads_jax_save_npz(trees, tmp_path):
    path = str(tmp_path / "jax_frb.npz")
    jax_export_frb.save_npz(path, *jax_export_frb.extract_frb(*trees))
    p, s = export_frb.load_npz(path)
    assert_trees_equal(p, trees[0]["frb"])
    assert_trees_equal(s, trees[1]["frb"])


def test_save_npz_is_jax_save_npz(trees, tmp_path):
    mine, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    export_frb.save_npz(mine, *export_frb.extract_frb(*trees))
    jax_export_frb.save_npz(theirs, *jax_export_frb.extract_frb(*trees))
    a, b = np.load(mine), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_extract_frb_needs_an_frb(trees):
    with pytest.raises(KeyError, match="frb"):
        export_frb.extract_frb({"osb": trees[0]["osb"]}, {})
