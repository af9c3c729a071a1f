"""The recipe of configs/arc18_msml_peer_dec.yaml as a whole model in the
port against the JAX package: its train forward with the frozen teacher
(final_cls with the reference's + kd, final_seg, kd, and the weighted
recover loss with `decoder_loss_weight` > 0), its eval forward, and that
it and `default_config()` build every part.

float32 on the CPU, one block per iResNet stage, a 16-class head, the same
numpy-drawn weights on both sides. The train forward runs at B = 4: with
two samples the `features` BatchNorm1d normalizes each channel to about
+-1 and the logits keep only a few digits in float32 (as
tests/test_torch_train_step.py says). Tolerances: kd and the recover loss
rtol 1e-4; the logits atol 1e-3 (s = 64 scales them); final_seg atol
1e-4 and the eval feature by cosine >= 0.9999 (test_torch_nn's eval
forward).
"""

import os

import jax
import numpy as np
import pytest
import torch

from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import iresnet as jiresnet
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn import decoder, iresnet
from msml_torch.tools import convert
from test_torch_nn import input_nhwc, nchw, random_variables, to_nhwc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEER_YAML = os.path.join(REPO, "configs", "arc18_msml_peer_dec.yaml")
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
    """iresnet18 cut to one block per stage in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(iresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        yield


def recipe_configs(**over):
    """configs/arc18_msml_peer_dec.yaml derived by both packages, with a
    16-class head (its ms1m-retinaface-t2 has 93,431) and `over`."""
    from msml_tpu.core.config import config_init as jax_init
    from msml_tpu.core.config import load_yaml as jax_yaml
    from msml_torch.core.config import config_init, load_yaml

    out = []
    for load, init in ((jax_yaml, jax_init), (load_yaml, config_init)):
        cfg = init(load(PEER_YAML), make_output_dir=False)
        cfg.num_classes = CLASSES
        cfg.update(over)
        out.append(cfg)
    return out


class WithoutLosses:
    """A flax module whose `init` leaves out the 'losses' collection (the
    decoder sows its loss at init too), for `random_variables`."""

    def __init__(self, module):
        self.module = module

    def init(self, *args, **kwargs):
        variables = self.module.init(*args, **kwargs)
        return {k: v for k, v in variables.items() if k != "losses"}


def recipe_models(**over):
    """-> (JAX model, its variables, the port's model with them)."""
    from msml_tpu.nn.msml import msml_from_config as jax_msml
    from msml_torch.nn.msml import msml_from_config

    jcfg, tcfg = recipe_configs(**over)
    jmodel = jax_msml(jcfg, policy=JAX_F32)
    x = input_nhwc((2, 112, 112, 3))
    v = random_variables(WithoutLosses(jmodel), x, np.zeros((2,), np.int32),
                         x, train=True)
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    model.load_state_dict(convert.state_dict_from_jax(v["params"],
                                                      v["batch_stats"]),
                          strict=True)
    return jmodel, v, model


def cosine_min(a, b):
    return ((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                              * np.linalg.norm(b, axis=1))).min()


@pytest.mark.parametrize("rec_weight", [0.0, 0.5], ids=["rec_off", "rec_on"])
def test_msml_train_forward(rec_weight):
    """The recipe's train forward with a teacher: (final_cls with the
    reference's + kd, final_seg, kd), and with `decoder_loss_weight` > 0
    the weighted recover loss."""
    jmodel, v, model = recipe_models(decoder_loss_weight=rec_weight)
    x = input_nhwc((4, 112, 112, 3))
    ori = input_nhwc((4, 112, 112, 3), seed=5)
    label = np.array([3, 11, 0, 15], np.int32)
    (cls, seg, kd), mut = jmodel.apply(v, x, label, ori, train=True,
                                       mutable=["batch_stats", "losses"])
    model.train()
    losses = {}
    tcls, tseg, tkd = model(nchw(x), torch.from_numpy(label).long(),
                            ori=nchw(ori), train=True, losses=losses)
    np.testing.assert_allclose(tkd.item(), float(kd), rtol=1e-4, atol=0)
    assert tkd.item() > 0
    np.testing.assert_allclose(tcls.detach().numpy(), np.asarray(cls),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(to_nhwc(tseg.detach()), np.asarray(seg),
                               atol=1e-4, rtol=0)
    want_rec = jax.tree.leaves(mut.get("losses", {}))
    if rec_weight:
        assert len(want_rec) == 1
        np.testing.assert_allclose(losses["rec"].item(), float(want_rec[0]),
                                   rtol=1e-4, atol=0)
    else:
        assert losses == {} and want_rec == []


def test_msml_eval_forward_of_the_recipe():
    """The recipe's eval forward: (feature, final_seg); the towers and
    conv_m run, the teacher, the KD tower and the decoder do not."""
    jmodel, v, model = recipe_models()
    x = input_nhwc((2, 112, 112, 3))
    feat, seg = jmodel.apply(v, x, train=False)
    model.eval()
    with torch.inference_mode():
        tfeat, tseg = model(nchw(x))
    assert cosine_min(tfeat.numpy(), np.asarray(feat)) > 0.9999
    np.testing.assert_allclose(to_nhwc(tseg), np.asarray(seg), atol=1e-4,
                               rtol=0)


def test_recipe_builds_every_part():
    """The recipe and default_config() build with the teacher, the towers
    and the decoder, and without the refusals of earlier slices."""
    from msml_torch.core.config import config_init, default_config
    from msml_torch.nn.msml import msml_from_config

    _, tcfg = recipe_configs()
    cfg = default_config()
    cfg.dataset = "synthetic"
    for c in (tcfg, config_init(cfg, make_output_dir=False)):
        model = msml_from_config(c, policy=FULL_PRECISION, device="cpu",
                                 head=True)
        assert isinstance(model.frb.peer, iresnet.PeerIResNet)
        assert isinstance(model.frb.decoder, decoder.DeepMindDecoder)
        for op in model.frb.fm_ops:
            assert op.use_ori and op.use_conv and op.mask_trans == "conv"
            assert hasattr(op, "conv_m") and hasattr(op, "conv2")


def test_chip_smoke_recipe_equals_the_yaml():
    """chip_smoke.py builds the recipe from a dict (the card's machine
    needs no PyYAML): the dict is the yaml."""
    import yaml

    import chip_smoke

    with open(PEER_YAML) as f:
        assert chip_smoke.PEER_DEC == yaml.safe_load(f)
