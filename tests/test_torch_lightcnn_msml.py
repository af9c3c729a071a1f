"""The LightCNN-29v2 gray recipe (configs/lightcnn_msml.yaml) as a whole model
in the port against the JAX package: its eval forward `(feature (B, 256),
final_seg (B, 2, 128, 128))`, its train forward with the frozen
`PeerLightCNN` teacher (`use_ori`: the FMs' KD terms summed), the kernel
sites the recipe gives the card, and what it refuses.

float32 on the CPU, the same numpy-drawn weights on both sides, a 16-class
Softmax head (webface's 10,572 at full size). The eval forward runs the
recipe at full width and depth, layers (1, 2, 3, 4), at B = 2; the train
forward at one resblock per stage and B = 4 (the FMs' BatchNorm in train
mode). Tolerances: the features relative L2 error <= 1e-5
(test_torch_lightcnn_nn's), final_seg atol 1e-4 (test_torch_peer_msml's),
kd rtol 1e-4, the logits relative L2 error <= 1e-5.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import lightcnn as jlightcnn
from msml_tpu.nn import msml as jmsml
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn import lightcnn
from msml_torch.nn.common import PReLU, routed_conv_sites
from msml_torch.tools import convert
from test_torch_lightcnn_nn import FEATURE_RTOL, rel_l2
from test_torch_nn import input_nhwc, nchw, random_variables, to_nhwc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT_YAML = os.path.join(REPO, "configs", "lightcnn_msml.yaml")
CLASSES = 16
ROUTED = ["frb.fm_ops.3.res_block.0.conv2", "frb.fm_ops.3.res_block.1.conv2",
          "osb.layer1.0.conv1", "osb.layer1.1.conv1", "osb.layer1.1.conv2"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def recipe_configs(**over):
    """configs/lightcnn_msml.yaml derived by both packages, with a 16-class
    head and `over`."""
    from msml_tpu.core.config import config_init as jax_init
    from msml_tpu.core.config import load_yaml as jax_yaml
    from msml_torch.core.config import config_init, load_yaml

    out = []
    for load, init in ((jax_yaml, jax_init), (load_yaml, config_init)):
        cfg = init(load(LIGHT_YAML), make_output_dir=False)
        cfg.num_classes = CLASSES
        cfg.update(over)
        out.append(cfg)
    return out


@pytest.fixture
def shallow_light(monkeypatch):
    """LightCNN cut to one resblock per stage in both packages (the JAX
    MSML builds its LightCNN and teacher with their default layers)."""
    layers = (1, 1, 1, 1)
    monkeypatch.setattr(jmsml, "LightCNN29v2", functools.partial(
        jlightcnn.LightCNN29v2, layers=layers))
    monkeypatch.setattr(jmsml, "PeerLightCNN", functools.partial(
        jlightcnn.PeerLightCNN, layers=layers))
    monkeypatch.setattr(lightcnn, "LIGHTCNN29_LAYERS", layers)


def recipe_models(b=2, ori=False, **over):
    """-> (JAX model, its variables, the port's model with them)."""
    from msml_torch.nn.msml import msml_from_config

    jcfg, tcfg = recipe_configs(**over)
    jmodel = jmsml.msml_from_config(jcfg, policy=JAX_F32)
    x = input_nhwc((b, 128, 128, 1))
    v = random_variables(jmodel, x, np.zeros((b,), np.int32),
                         x if ori else None, train=True)
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    model.load_state_dict(convert.state_dict_from_jax(v["params"],
                                                      v["batch_stats"]),
                          strict=True)
    return jmodel, v, model


def test_msml_eval_forward_of_the_recipe():
    """The recipe at full width and depth: (feature (2, 256), final_seg
    (2, 2, 128, 128)) against JAX's."""
    jmodel, v, model = recipe_models()
    x = input_nhwc((2, 128, 128, 1), seed=3)
    feat, seg = jmodel.apply(v, x, train=False)
    model.eval()
    with torch.inference_mode():
        tfeat, tseg = model(nchw(x))
    assert tuple(tfeat.shape) == (2, 256)
    assert tuple(tseg.shape) == (2, 2, 128, 128)
    assert rel_l2(tfeat.numpy(), np.asarray(feat)) <= FEATURE_RTOL
    np.testing.assert_allclose(to_nhwc(tseg), np.asarray(seg), atol=1e-4,
                               rtol=0)


def test_recipe_kernel_sites():
    """The five routed conv3x3 sites: the OSB's at 64^2 and 32^2 (its stem
    halves the 128 input) and the 128-channel FM's bottleneck convs at
    8^2; every LightCNN conv carries a bias and stays cuDNN. 33 PReLU
    sites: 9 in the OSB, 24 in the four FMs, none in LightCNN."""
    _, tcfg = recipe_configs()
    from msml_torch.nn.msml import msml_from_config

    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu")
    assert sorted(routed_conv_sites(model)) == ROUTED
    prelu = [n for n, m in model.named_modules() if isinstance(m, PReLU)]
    assert len(prelu) == 33
    assert sum(n.startswith("osb.") for n in prelu) == 9
    assert not any(n.startswith("frb.") and ".fm_ops." not in n
                   for n in prelu)
    sizes = {}
    hooks = [model.get_submodule(n).register_forward_pre_hook(
        lambda m, a, n=n: sizes.__setitem__(n, tuple(a[0].shape[2:])))
        for n in ROUTED]
    with torch.inference_mode():
        model(torch.zeros(1, 1, 128, 128))
    for h in hooks:
        h.remove()
    assert sizes == {ROUTED[0]: (8, 8), ROUTED[1]: (8, 8),
                     ROUTED[2]: (64, 64), ROUTED[3]: (32, 32),
                     ROUTED[4]: (32, 32)}


def test_msml_train_forward_with_the_teacher(shallow_light):
    """`use_ori`: the frozen PeerLightCNN on `ori` feeds the FMs, whose KD
    terms sum to kd; final_cls is the Softmax logits + kd."""
    peer = {"use_ori": True, "use_conv": True, "mask_trans": "conv",
            "use_decoder": False}
    jmodel, v, model = recipe_models(b=4, ori=True, peer_params=peer)
    assert isinstance(model.frb.peer, lightcnn.PeerLightCNN)
    x = input_nhwc((4, 128, 128, 1))
    ori = input_nhwc((4, 128, 128, 1), seed=5)
    label = np.array([3, 11, 0, 15], np.int32)
    (cls, seg, kd), _ = jmodel.apply(v, x, label, ori, train=True,
                                     mutable=["batch_stats", "losses"])
    model.train()
    assert not model.frb.peer.training
    tcls, tseg, tkd = model(nchw(x), torch.from_numpy(label).long(),
                            ori=nchw(ori), train=True)
    assert tkd.item() > 0
    np.testing.assert_allclose(tkd.item(), float(kd), rtol=1e-4, atol=0)
    assert rel_l2(tcls.detach().numpy(), np.asarray(cls)) <= FEATURE_RTOL
    np.testing.assert_allclose(to_nhwc(tseg.detach()), np.asarray(seg),
                               atol=1e-4, rtol=0)


def test_recipe_refuses_width_mult_as_jax_does():
    """width_mult is an iResNet knob: both packages raise the same
    ValueError for a LightCNN FRB (msml_tpu/nn/msml.py:88-93)."""
    from msml_torch.nn.msml import msml_from_config

    jcfg, tcfg = recipe_configs(width_mult=2)
    with pytest.raises(ValueError, match="iresnet-FRB knob") as jerr:
        jmodel = jmsml.msml_from_config(jcfg, policy=JAX_F32)
        jmodel.init(jax.random.PRNGKey(0),
                    np.zeros((1, 128, 128, 1), np.float32))
    with pytest.raises(ValueError, match="iresnet-FRB knob") as err:
        msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu")
    assert str(err.value) == str(jerr.value)
    _, ok = recipe_configs(width_mult=[1, 1, 1, 1])
    msml_from_config(ok, policy=FULL_PRECISION, device="cpu")


def test_recipe_builds_from_the_yaml():
    """The yaml's derived config: gray 128^2 without input normalization,
    a 256-d feature, the Softmax head, pretrained LR groups; the model has
    the 1-channel OSB stem and no teacher."""
    from msml_torch.nn.msml import msml_from_config

    _, tcfg = recipe_configs()
    assert tcfg.is_gray and not tcfg.use_norm and tcfg.pretrained
    assert tuple(tcfg.out_size) == (128, 128) and tcfg.dim_feature == 256
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    assert isinstance(model.frb, lightcnn.LightCNN29v2)
    assert model.frb.peer is None
    assert tuple(model.osb.conv1.weight.shape) == (64, 1, 3, 3)
    assert tuple(model.osb.deconv1.weight.shape[2:]) == (4, 4)
    assert tuple(model.classification.weight.shape) == (CLASSES, 256)


def test_chip_smoke_recipe_equals_the_yaml():
    """chip_smoke.py builds the recipe from a dict (the card's machine
    needs no PyYAML): the dict is the yaml."""
    import yaml

    import chip_smoke

    with open(LIGHT_YAML) as f:
        assert chip_smoke.LIGHTCNN_MSML == yaml.safe_load(f)
