"""Weights of the LightCNN-29v2 gray recipe (configs/lightcnn_msml.yaml) in
the port against the JAX package: `convert.py` both ways for the LightCNN
FRB and its frozen teacher, `tools/export_torch` and `tools/export_frb`
(the JAX exporter's names and values), `pretrained_backbone` and
`peer_weights` from each of the four sources (a LightCNN `.npz`, a
`backbone.pth`, a vanilla LightCNN `.pth`, a `ckpt/<step>.pt`) with JAX's
results and counts, JAX's warning for a `pretrained` recipe without
weights, and the learning rate of every parameter against JAX's
`build_lr_scales` (the recipe's derived `pretrained` is true).

numpy-drawn flax trees of the recipe with the teacher (`use_ori`) at one
resblock per LightCNN stage, full width, a 16-class Softmax head, float32,
on the CPU. Exact equality throughout: no arithmetic touches the weights.
"""

import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import lightcnn as jlightcnn
from msml_tpu.nn import msml as jmsml
from msml_tpu.tools import export_frb as jax_export_frb
from msml_tpu.tools.export_torch import export_msml_state_dict
from msml_tpu.tools.load_weights import load_pretrained as jax_load
from msml_tpu.train import optim as joptim
from msml_torch.core.config import save_yaml
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn import lightcnn
from msml_torch.nn.msml import msml_from_config
from msml_torch.tools import export_frb, export_torch
from msml_torch.tools.convert import jax_from_state_dict, state_dict_from_jax
from msml_torch.tools.load_weights import load_pretrained
from msml_torch.train import optim, train_step
from test_torch_export_weights import (assert_state_dicts_equal,
                                       assert_trees_equal)
from test_torch_lightcnn_msml import CLASSES, LIGHT_YAML, recipe_configs
from test_torch_load_weights import messages, records
from test_torch_nn import random_variables
from test_torch_peer_weights import JaxState, torch_sd

SOURCES = ["npz", "jax_pth", "vanilla_pth", "port_ckpt"]
PEER = {"use_ori": True, "use_conv": False, "mask_trans": "conv",
        "use_decoder": False}
COUNT = {"peer_weights": re.compile(r"loaded (\d+) peer tensors from"),
         "pretrained_backbone": re.compile(
             r"loaded (\d+) pretrained backbone tensors from")}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    """One resblock per LightCNN stage in both packages."""
    layers = (1, 1, 1, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmsml, "LightCNN29v2", functools.partial(
            jlightcnn.LightCNN29v2, layers=layers))
        mp.setattr(jmsml, "PeerLightCNN", functools.partial(
            jlightcnn.PeerLightCNN, layers=layers))
        mp.setattr(lightcnn, "LIGHTCNN29_LAYERS", layers)
        yield


def configs(**over):
    return recipe_configs(peer_params=dict(PEER), **over)


def light_trees(seed=0):
    """numpy-drawn flax (params, batch_stats) of the shallow recipe with
    its teacher and a 16-class Softmax head."""
    jcfg, _ = configs()
    model = jmsml.msml_from_config(jcfg, policy=JAX_F32,
                                   external_header=True)
    x = np.zeros((1, 128, 128, 1), np.float32)
    v = random_variables(model, x, None, x, train=False, seed=seed)
    params = dict(jax.device_get(v["params"]))
    rs = np.random.RandomState(seed + 7)
    params["classification"] = {
        "weight": rs.uniform(-0.1, 0.1, (CLASSES, 256)).astype(np.float32),
        "bias": rs.uniform(-0.1, 0.1, (CLASSES,)).astype(np.float32)}
    return params, jax.device_get(v["batch_stats"])


@pytest.fixture(scope="module")
def template():
    return light_trees(seed=0)


@pytest.fixture(scope="module")
def donor():
    return light_trees(seed=1)


def port_model(cfg=None):
    return msml_from_config(cfg or configs()[1], policy=FULL_PRECISION,
                            device="cpu", head=True)


def test_convert_round_trip(template):
    """flax trees -> the port's state dict -> flax trees, exactly; the
    port's model takes the state dict strict, the teacher under
    `frb.peer.*` with the reference's LightCNN names."""
    params, stats = template
    sd = state_dict_from_jax(params, stats)
    for key in ("frb.conv1.filter.weight", "frb.group2.conv_a.filter.bias",
                "frb.block4.0.conv2.filter.weight", "frb.fc.weight",
                "frb.peer.group4.conv.filter.weight", "frb.peer.fc.bias",
                "classification.bias"):
        assert key in sd, key
    assert tuple(sd["frb.fc.weight"].shape) == (256, 128 * 8 * 8)
    assert not any(k.endswith(".features.weight") for k in sd)
    back_p, back_s = jax_from_state_dict(sd)
    assert_trees_equal(back_p, params)
    assert_trees_equal(back_s, stats)
    port_model().load_state_dict(sd, strict=True)


def test_fc_flattens_c_major(template):
    """frb.fc's columns are in the reference's C-major order: column
    c * 64 + h * 8 + w holds the flax row (h * 8 + w) * 128 + c."""
    params, stats = template
    sd = state_dict_from_jax(params, stats)
    kernel = params["frb"]["fc"]["kernel"]
    got = sd["frb.fc.weight"].numpy()
    for c, h, w in ((0, 0, 0), (5, 3, 7), (127, 7, 7), (64, 1, 2)):
        np.testing.assert_array_equal(got[:, c * 64 + h * 8 + w],
                                      kernel[(h * 8 + w) * 128 + c])


def write_folder(out, trees):
    os.makedirs(os.path.join(out, "ckpt"))
    with open(LIGHT_YAML) as f:
        import yaml
        user = yaml.safe_load(f)
    save_yaml(dict(user, dataset="synthetic", num_classes=CLASSES,
                   fp16=False, peer_params=dict(PEER)),
              os.path.join(out, "config.yaml"))
    torch.save({"model": state_dict_from_jax(*trees), "step": 5},
               os.path.join(out, "ckpt", "5.pt"))
    return out


def test_export_torch_equals_jax(template, tmp_path):
    """The port's backbone.pth of a LightCNN folder has the JAX exporter's
    names and values, the teacher and the head included."""
    folder = write_folder(str(tmp_path / "f"), template)
    out = str(tmp_path / "backbone.pth")
    export_torch.main(export_torch.parse_args(["--weight_folder", folder,
                                               "--out", out]))
    got = torch.load(out, weights_only=True)
    assert_state_dicts_equal(got, torch_sd(export_msml_state_dict(
        *template)))


def test_export_frb_equals_jax(template, tmp_path):
    """The port's frb.npz of a LightCNN folder: the JAX package's
    `load_npz` reads the flax frb trees of the weights."""
    folder = write_folder(str(tmp_path / "f"), template)
    out = export_frb.main(export_frb.parse_args(
        ["--weight_folder", folder, "--out", str(tmp_path / "frb.npz")]))
    p, s = jax_export_frb.load_npz(out)
    assert_trees_equal(p, template[0]["frb"])
    assert "conv1" in p and "filter" in p["conv1"]
    assert s == {}


def write_source(kind, donor, path_dir):
    """The donor as a weight file of `kind`."""
    if kind == "npz":
        path = os.path.join(path_dir, "frb.npz")
        jax_export_frb.save_npz(path, *jax_export_frb.extract_frb(*donor))
        return path
    sd = torch_sd(export_msml_state_dict(*donor))
    if kind == "jax_pth":
        path = os.path.join(path_dir, "backbone.pth")
        torch.save(sd, path)
    elif kind == "vanilla_pth":  # the reference's own LightCNN_29Layers_v2
        path = os.path.join(path_dir, "lightcnn.pth")
        torch.save({k[len("frb."):]: v for k, v in sd.items()
                    if k.startswith("frb.") and not k.startswith(
                        ("frb.fm_ops.", "frb.peer."))}, path)
    else:
        path = os.path.join(path_dir, "7.pt")
        torch.save({"model": state_dict_from_jax(*donor), "optimizer": {},
                    "step": 7}, path)
    return path


def load_both(template, key, path, jax_path=None):
    """`key: path` in both packages' configs, loaded onto the template;
    -> (JAX's result as a port state dict, the port's, JAX's log lines,
    the port's)."""
    jcfg, tcfg = configs(**{key: jax_path or path})
    with records("msml_tpu") as jrec:
        js = jax_load(JaxState(jax.device_put(template[0]),
                               jax.device_put(template[1])), jcfg)
    model = port_model(tcfg)
    model.load_state_dict(state_dict_from_jax(*template), strict=True)
    with records("msml_torch") as trec:
        ts = load_pretrained(train_step.init_train_state(model, tcfg, "cpu"),
                             tcfg)
    return (state_dict_from_jax(jax.device_get(js.params),
                                jax.device_get(js.batch_stats)),
            ts.model.state_dict(), messages(jrec), messages(trec))


@pytest.fixture(scope="module")
def loaded(template, donor, tmp_path_factory):
    out, paths = {}, {}
    for kind in SOURCES:  # jax_pth comes before port_ckpt
        paths[kind] = write_source(kind, donor,
                                   str(tmp_path_factory.mktemp(kind)))
    for key in COUNT:
        for kind in SOURCES:
            # JAX reads the checkpoint's weights from the same backbone.pth
            out[key, kind] = load_both(
                template, key, paths[kind],
                paths["jax_pth"] if kind == "port_ckpt" else None)
    return out


def counts(lines, key):
    return [int(m.group(1)) for m in map(COUNT[key].search, lines) if m]


@pytest.mark.parametrize("key", list(COUNT))
@pytest.mark.parametrize("kind", SOURCES)
def test_load_weights_equal_jax(loaded, key, kind):
    """The overlaid model equals JAX's, tensor for tensor."""
    want, got, _, _ = loaded[key, kind]
    assert_state_dicts_equal(got, want)


@pytest.mark.parametrize("key", list(COUNT))
@pytest.mark.parametrize("kind", SOURCES)
def test_load_weights_count_equals_jax(loaded, donor, key, kind):
    """The count logged is JAX's: for the backbone, the source's groups
    (frb, the FMs, osb, the head, where it has them); for the teacher, the
    source's frb trunk plus its own teacher."""
    _, _, jlog, tlog = loaded[key, kind]
    jn, tn = counts(jlog, key), counts(tlog, key)
    assert len(tn) == 1 and jn == tn
    p = donor[0]
    trunk = len(jax.tree.leaves(p["frb"]))
    if key == "peer_weights":
        want = trunk + (len(jax.tree.leaves(p["peer"]))
                        if kind in ("jax_pth", "port_ckpt") else 0)
    elif kind in ("npz", "vanilla_pth"):
        want = trunk
    else:
        want = len(jax.tree.leaves({k: v for k, v in p.items()
                                    if k != "peer"}))
    assert tn[0] == want


@pytest.mark.parametrize("kind", SOURCES)
def test_peer_weights_fill_the_teacher_only(loaded, template, donor, kind):
    """`peer_weights` changes the teacher alone: from the donor's frb trunk
    (npz, vanilla) or the donor's own teacher (backbone.pth, ckpt)."""
    _, got, _, _ = loaded["peer_weights", kind]
    before = state_dict_from_jax(*template)
    new = state_dict_from_jax(*donor)
    own_peer = kind in ("jax_pth", "port_ckpt")
    for k, v in got.items():
        if not k.startswith("frb.peer."):
            assert torch.equal(v, before[k]), k
        else:
            src = k if own_peer else "frb." + k[len("frb.peer."):]
            assert torch.equal(v, new[src]), k


def test_pretrained_without_weights_warns_as_jax():
    """The recipe's derived `pretrained` with no weight file: both packages
    warn in the same words and train from scratch."""
    jcfg, tcfg = configs()
    assert jcfg.pretrained and tcfg.pretrained
    with records("msml_tpu") as jrec:
        jax_load(None, jcfg)
    model = port_model(tcfg)
    with records("msml_torch") as trec:
        state = train_step.init_train_state(model, tcfg, "cpu")
        assert load_pretrained(state, tcfg) is state
    assert messages(trec) == messages(jrec)
    assert len(messages(trec)) == 1 and "pretrained" in messages(trec)[0]


def test_lr_scales_equal_build_lr_scales(template):
    """Each parameter's lr is the one JAX's `build_lr_scales` gives its
    flax path under the recipe's `pretrained`: the FMs at 0.1, the head at
    10 x the base, the OSB at 0.01, the rest (LightCNN) at the base; the
    teacher has none and is not in the optimizer."""
    jcfg, tcfg = configs(batch_size=4)
    params = {k: v for k, v in template[0].items()}
    scales = joptim.build_lr_scales(params, jcfg, 1)
    scale_tree = jax.tree.map(lambda v, lr: np.full(v.shape, lr, np.float32),
                              params, scales)
    want = state_dict_from_jax(scale_tree, template[1])
    model = port_model(tcfg)
    seen = {}
    for name, p in model.named_parameters():
        lr = want[name].unique()
        assert lr.numel() == 1, name
        assert np.isclose(optim.lr_scale(name, tcfg), float(lr), rtol=1e-6,
                          atol=0), name
        seen[name] = float(lr)
    base = tcfg.lr / 512.0 * 4
    assert np.isclose(seen["classification.weight"], 10 * base)
    assert np.isclose(seen["frb.fm_ops.0.same_conv.weight"], 0.1 / 512 * 4)
    assert np.isclose(seen["frb.conv1.filter.weight"], base)
    assert seen["frb.peer.conv1.filter.weight"] == 0.0
    groups = optim.param_groups(model, tcfg)
    held = {id(p) for g in groups for p in g["params"]}
    assert not any(id(p) in held for p in model.frb.peer.parameters())
    assert len(groups) == 4
