"""Weights of the peer-KD recipe (configs/arc18_msml_peer_dec.yaml) in the
port against the JAX package: `convert.py` both ways, `tools/export_torch`
(names and values equal to JAX's `export_msml_state_dict`; a decoder
refused with JAX's message), `peer_weights` from each of the four sources
and `pretrained_backbone` from an `.npz` with the decoder (equal results,
JAX's counts), and `quantize_model`'s counts on the recipe's eval model
against JAX's `quantize_fn`.

numpy-drawn flax trees of the recipe at one block per iResNet stage with a
16-class head, float32, on the CPU. The `.pth` sources come from JAX's
exporter, which writes no decoder, so their donor has none.
"""

import os
import re

import flax
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from msml_tpu.core import quantize as jquant
from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import iresnet as jiresnet
from msml_tpu.nn.msml import msml_from_config as jax_msml
from msml_tpu.tools import export_frb as jax_export_frb
from msml_tpu.tools.export_torch import export_msml_state_dict
from msml_tpu.tools.load_weights import load_pretrained as jax_load
from msml_torch.core.config import save_yaml
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.core.quantize import quant_sites, quantize_model
from msml_torch.nn import iresnet
from msml_torch.nn.msml import msml_from_config
from msml_torch.tools import export_torch
from msml_torch.tools.convert import jax_from_state_dict, state_dict_from_jax
from msml_torch.tools.load_weights import load_pretrained
from msml_torch.train import train_step
from test_torch_export_weights import (assert_state_dicts_equal,
                                       assert_trees_equal)
from test_torch_load_weights import messages, records
from test_torch_nn import nchw, random_variables
from test_torch_peer_msml import CLASSES, WithoutLosses, recipe_configs

SOURCES = ["npz", "jax_pth", "vanilla_pth", "port_ckpt"]
PEER_COUNT = re.compile(r"loaded (\d+) peer tensors from")
BACKBONE_COUNT = re.compile(r"loaded (\d+) pretrained backbone tensors from")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(iresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        yield


@flax.struct.dataclass
class JaxState:
    params: dict
    batch_stats: dict


def recipe_trees(seed=0, decoder=True):
    """numpy-drawn flax (params, batch_stats) of the shallow recipe (with or
    without the decoder) and a 16-class head. The init is given `ori`, so
    that the teacher's parameters exist."""
    jcfg, _ = recipe_configs()
    jcfg.peer_params = dict(jcfg.peer_params, use_decoder=decoder)
    model = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    x = np.zeros((1, 112, 112, 3), np.float32)
    v = random_variables(WithoutLosses(model), x, None, x, train=False,
                         seed=seed)
    params = dict(jax.device_get(v["params"]))
    params["classification"] = {"weight": np.random.RandomState(
        seed + 7).uniform(-0.1, 0.1, (CLASSES, 512)).astype(np.float32)}
    return params, jax.device_get(v["batch_stats"])


def torch_sd(sd):
    """A numpy state dict as torch tensors, as the JAX exporter saves it."""
    return {k: torch.from_numpy(np.array(
        v, np.int64 if v.dtype == np.int64 else np.float32))
        for k, v in sd.items()}


@pytest.fixture(scope="module")
def template():
    return recipe_trees(seed=0)


@pytest.fixture(scope="module")
def donor():
    return recipe_trees(seed=1)


@pytest.fixture(scope="module")
def no_decoder():
    return recipe_trees(decoder=False)


@pytest.mark.parametrize("decoder", [True, False], ids=["decoder", "no_dec"])
def test_convert_round_trip(template, no_decoder, decoder):
    """flax trees -> the port's state dict -> flax trees, exactly; the
    port's recipe model takes the state dict strict, teacher, towers and
    decoder included."""
    params, stats = template if decoder else no_decoder
    sd = state_dict_from_jax(params, stats)
    assert any(k.startswith("frb.peer.layer4.") for k in sd)
    assert any(k.startswith("frb.fm_ops.3.conv2.5.") for k in sd)
    assert any(k.startswith("frb.decoder.") for k in sd) == decoder
    back_p, back_s = jax_from_state_dict(sd)
    assert_trees_equal(back_p, params)
    assert_trees_equal(back_s, stats)
    _, tcfg = recipe_configs()
    tcfg.peer_params = dict(tcfg.peer_params, use_decoder=decoder)
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    model.load_state_dict(sd, strict=True)


def write_folder(out, trees, decoder):
    os.makedirs(os.path.join(out, "ckpt"))
    _, tcfg = recipe_configs()
    save_yaml(dict(chip_smoke.ARC18_MSML, dataset="synthetic",
                   num_classes=CLASSES, fp16=False,
                   peer_params=dict(tcfg.peer_params, use_decoder=decoder)),
              os.path.join(out, "config.yaml"))
    torch.save({"model": state_dict_from_jax(*trees), "step": 5},
               os.path.join(out, "ckpt", "5.pt"))
    return out


def test_export_torch_equals_jax(no_decoder, tmp_path):
    """The port's backbone.pth of a folder with the teacher and the towers
    has the JAX exporter's names and values: `frb.peer.*`, `conv_m.0/1`,
    the towers' `.0` to `.5`."""
    trees = no_decoder
    folder = write_folder(str(tmp_path / "f"), trees, decoder=False)
    out = str(tmp_path / "backbone.pth")
    export_torch.main(export_torch.parse_args(["--weight_folder", folder,
                                               "--out", out]))
    got = torch.load(out, weights_only=True)
    want = torch_sd(export_msml_state_dict(*trees))
    assert_state_dicts_equal(got, want)
    for key in ("frb.peer.features.running_var", "frb.fm_ops.0.conv_m.1.bias",
                "frb.fm_ops.2.conv1.3.weight", "frb.fm_ops.1.conv2.5.weight"):
        assert key in got, key


def test_export_torch_refuses_the_decoder(template, tmp_path):
    """A folder with the recover decoder: the port's exporter raises JAX's
    NotImplementedError, word for word."""
    with pytest.raises(NotImplementedError) as jax_err:
        export_msml_state_dict(*template)
    folder = write_folder(str(tmp_path / "f"), template, decoder=True)
    with pytest.raises(NotImplementedError) as port_err:
        export_torch.main(export_torch.parse_args(
            ["--weight_folder", folder, "--out", str(tmp_path / "b.pth")]))
    assert str(port_err.value) == str(jax_err.value)
    assert not os.path.exists(tmp_path / "b.pth")


def without_decoder(trees):
    params = dict(trees[0], frb={k: v for k, v in trees[0]["frb"].items()
                                 if k != "decoder"})
    return params, trees[1]


def write_source(kind, donor, path_dir):
    """The donor as a weight file of `kind`; the .pth kinds without its
    decoder, which JAX's exporter refuses."""
    if kind == "npz":
        path = os.path.join(path_dir, "frb.npz")
        jax_export_frb.save_npz(path, *jax_export_frb.extract_frb(*donor))
        return path
    sd = torch_sd(export_msml_state_dict(*without_decoder(donor)))
    if kind == "jax_pth":
        path = os.path.join(path_dir, "backbone.pth")
        torch.save(sd, path)
    elif kind == "vanilla_pth":
        path = os.path.join(path_dir, "iresnet.pth")
        torch.save({k[len("frb."):]: v for k, v in sd.items()
                    if k.startswith("frb.") and not k.startswith(
                        ("frb.fm_ops.", "frb.peer."))}, path)
    else:  # the port's own checkpoint, decoder included
        path = os.path.join(path_dir, "7.pt")
        torch.save({"model": state_dict_from_jax(*donor), "optimizer": {},
                    "step": 7}, path)
    return path


def port_state(trees):
    _, tcfg = recipe_configs()
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    model.load_state_dict(state_dict_from_jax(*trees), strict=True)
    return train_step.init_train_state(model, tcfg, "cpu")


def load_both(template, key, path, jax_path=None):
    """`key: path` in both packages' recipe configs, loaded onto the
    template; -> (JAX's result as a port state dict, the port's, JAX's
    log lines, the port's)."""
    jcfg, tcfg = recipe_configs(**{key: jax_path or path})
    tcfg[key] = path
    with records("msml_tpu") as jrec:
        js = jax_load(JaxState(jax.device_put(template[0]),
                               jax.device_put(template[1])), jcfg)
    with records("msml_torch") as trec:
        ts = load_pretrained(port_state(template), tcfg)
    return (state_dict_from_jax(jax.device_get(js.params),
                                jax.device_get(js.batch_stats)),
            ts.model.state_dict(), messages(jrec), messages(trec))


@pytest.fixture(scope="module")
def peer_loaded(template, donor, tmp_path_factory):
    out, paths = {}, {}
    for kind in SOURCES:  # jax_pth comes before port_ckpt
        paths[kind] = write_source(kind, donor,
                                   str(tmp_path_factory.mktemp(kind)))
        # JAX reads the checkpoint's weights from the same backbone.pth
        out[kind] = load_both(template, "peer_weights", paths[kind],
                              paths["jax_pth"] if kind == "port_ckpt"
                              else None)
    return out


def counts(lines, pattern):
    return [int(m.group(1)) for m in map(pattern.search, lines) if m]


@pytest.mark.parametrize("kind", SOURCES)
def test_peer_weights_equal_jax(peer_loaded, kind):
    want, got, _, _ = peer_loaded[kind]
    assert_state_dicts_equal(got, want)


@pytest.mark.parametrize("kind", SOURCES)
def test_peer_weights_fill_the_teacher_only(peer_loaded, template, donor,
                                            kind):
    """The teacher takes the donor's frb trunk (the .npz and the vanilla
    iResNet) or, where the source has one, the donor's own teacher; every
    other tensor keeps the template's."""
    _, got, _, _ = peer_loaded[kind]
    before = state_dict_from_jax(*template)
    new = state_dict_from_jax(*donor)
    own_peer = kind in ("jax_pth", "port_ckpt")
    for k, v in got.items():
        if not k.startswith("frb.peer."):
            assert torch.equal(v, before[k]), k
        elif k.endswith(("num_batches_tracked", "features.weight")):
            assert torch.equal(v, before[k]), k
        else:
            src = k if own_peer else "frb." + k[len("frb.peer."):]
            assert torch.equal(v, new[src]), k


@pytest.mark.parametrize("kind", SOURCES)
def test_peer_weights_count_equals_jax(peer_loaded, donor, kind):
    """JAX's count: the source's frb leaves (its decoder too, in an .npz)
    plus its teacher's."""
    _, _, jlog, tlog = peer_loaded[kind]
    jn, tn = counts(jlog, PEER_COUNT), counts(tlog, PEER_COUNT)
    assert len(tn) == 1 and jn == tn
    frb = donor[0]["frb"]
    if kind in ("npz",):
        want = len(jax.tree.leaves(frb))
    else:
        trunk = len(jax.tree.leaves({k: v for k, v in frb.items()
                                     if k != "decoder"}))
        want = trunk + (len(jax.tree.leaves(donor[0]["peer"]))
                        if kind != "vanilla_pth" else 0)
    assert tn[0] == want
    assert counts(tlog, BACKBONE_COUNT) == []


def test_pretrained_backbone_npz_with_decoder(template, donor, tmp_path):
    """An `.npz` of a recipe's frb holds its decoder (JAX keeps it under
    `frb`): `pretrained_backbone` overlays the trunk and the decoder, as
    JAX does, with JAX's count."""
    path = write_source("npz", donor, str(tmp_path))
    want, got, jlog, tlog = load_both(template, "pretrained_backbone", path)
    assert_state_dicts_equal(got, want)
    new = state_dict_from_jax(*donor)
    assert torch.equal(got["frb.decoder.deconv_out.weight"],
                       new["frb.decoder.deconv_out.weight"])
    assert counts(tlog, BACKBONE_COUNT) == counts(jlog, BACKBONE_COUNT) == [
        len(jax.tree.leaves(donor[0]["frb"]))]


def test_quantize_counts_equal_jax(template):
    """`quantize_model` on the recipe's eval forward makes JAX's decisions:
    the towers' and conv_m's convs (with their bias) join the flagship's
    sites; the teacher, the KD tower and the decoder do not run at eval
    and are not quantized."""
    jcfg, tcfg = recipe_configs()
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    params = {k: v for k, v in template[0].items() if k != "classification"}
    variables = {"params": params, "batch_stats": template[1]}
    jstats, tstats = {}, {}

    def features(x):
        return jmodel.apply(variables, x, train=False)[0]

    x = np.random.RandomState(5).uniform(-1, 1, (1, 112, 112, 3)) \
        .astype(np.float32)
    jax.jit(jquant.quantize_fn(features, stats_out=jstats))(x)
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu")
    model.load_state_dict({k: v for k, v in state_dict_from_jax(
        *template).items() if not k.startswith("classification.")})
    qmodel = quantize_model(model, nchw(x), stats_out=tstats)
    assert tstats == jstats
    sites = quant_sites(qmodel)
    assert len(sites) == tstats["conv_quantized"] + tstats["dot_quantized"]
    for i in range(4):
        assert f"frb.fm_ops.{i}.conv_m.0" in sites
        assert f"frb.fm_ops.{i}.conv1.3" in sites
    assert not any(s.startswith(("frb.peer.", "frb.decoder.")) or ".conv2."
                   in s for s in sites)
