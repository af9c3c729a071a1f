"""The eval-only baselines of `cli.test --network` in the port against
their flax counterparts: Sphere-20 (`cosface2018`, `nn/baselines.py`), the
BasicBlock `ResNet` and FROM's `LResNetOcc` / `From2021`
(`nn/from2021.py`), at 112 x 96 and 112 x 112 input.

Both sides run in float32 on the CPU from the same numpy-drawn weights
(`test_torch_nn.random_variables`: BN statistics, scales and PReLU slopes
drawn too, so that a permuted BN1d or fc row shows), carried into the port
by `tools/convert.py`, B = 2. Sphere-20 at its full depth; ResNet and
LResNetOcc at one block per stage, layers (1, 1, 1, 1), for time (one JAX
compile per network and input size). Tolerance: relative L2 error <= 1e-4
of every output (float32 sums in another order than XLA's; ~1e-6 seen).
`convert.py` carries each network's flax trees to a state dict and back
bit for bit; the networks' kernel sites are counted from their modules.
"""

import jax
import numpy as np
import pytest
import torch

from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import baselines as jbaselines
from msml_tpu.nn import from2021 as jfrom2021
from msml_torch.nn import baselines, from2021
from msml_torch.nn.common import PReLU, routed_conv_sites
from msml_torch.nn.iresnet import IRESNET_LAYERS, PeerIResNet
from msml_torch.tools import convert
from test_torch_nn import input_nhwc, nchw, random_variables, to_nhwc

SHALLOW = (1, 1, 1, 1)
RTOL = 1e-4  # relative L2 error of each output, float32
SIZES = [(112, 96), (112, 112)]
B = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def jax_modules(hw):
    return {
        "sphere": jbaselines.Sphere(input_size=hw, policy=JAX_F32),
        "resnet": jbaselines.ResNet(layers=SHALLOW, policy=JAX_F32),
        "lresnet_occ": jfrom2021.LResNetOcc(layers=SHALLOW, policy=JAX_F32),
    }


def port_module(network, hw):
    return {"sphere": lambda: baselines.Sphere(input_size=hw),
            "resnet": lambda: baselines.ResNet(SHALLOW, input_size=hw),
            "lresnet_occ": lambda: from2021.LResNetOcc(SHALLOW,
                                                       input_size=hw),
            }[network]().eval()


@pytest.fixture(scope="module")
def jax_runs():
    """network, (h, w) -> (variables, input, outputs), each computed once
    (one jit compile each)."""
    cache = {}

    def run(network, hw):
        if (network, hw) not in cache:
            x = input_nhwc((B,) + hw + (3,), seed=7)
            module = jax_modules(hw)[network]
            v = random_variables(module, x, seed=3)
            out = jax.jit(module.apply)(v, x)
            cache[network, hw] = v, x, jax.tree_util.tree_map(np.asarray,
                                                              out)
        return cache[network, hw]

    return run


def ported(network, hw, v):
    m = port_module(network, hw)
    m.load_state_dict(convert.state_dict_from_jax(
        v["params"], v.get("batch_stats", {}), network, hw), strict=True)
    return m


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("network", ["sphere", "resnet"])
def test_embedding_matches_jax(jax_runs, network, hw):
    v, x, want = jax_runs(network, hw)
    with torch.no_grad():
        got = ported(network, hw, v)(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (B, 512)
    assert rel_l2(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: "%dx%d" % s)
def test_lresnet_occ_outputs_match_jax(jax_runs, hw):
    """All four outputs: fc_mask, the FPN mask (B, 512, 7, w), the
    mask-pattern regressor's 226-vector and fc; and with a given mask."""
    v, x, want = jax_runs("lresnet_occ", hw)
    m = ported("lresnet_occ", hw, v)
    with torch.no_grad():
        got = m(nchw(x))
        given = m(nchw(x), mask=got[1] * 0.5)
    fmap_hw = baselines.final_map(hw)
    assert got[1].shape == (B, 512) + fmap_hw
    assert got[2].shape == (B, 226) and got[0].shape == got[3].shape == (
        B, 512)
    for name, g, w in zip(("fc_mask", "mask", "vec", "fc"), got, want):
        g = to_nhwc(g) if g.dim() == 4 else g.numpy()
        assert rel_l2(g, w) <= RTOL, name
    jm = jfrom2021.LResNetOcc(layers=SHALLOW, policy=JAX_F32)
    want_given = jm.apply(v, x, mask=np.asarray(want[1]) * 0.5)
    for name, g, w in zip(("fc_mask", "vec"), (given[0], given[2]),
                          (want_given[0], want_given[2])):
        assert rel_l2(g.numpy(), w) <= RTOL, name
    assert torch.equal(given[3], got[3])


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: "%dx%d" % s)
def test_from2021_fc_is_lresnet_occ_fc(jax_runs, hw, monkeypatch):
    """From2021's forward (trunk and plain fc only) gives LResNetOcc's fc
    on the same state dict, which a strict load takes."""
    monkeypatch.setattr(from2021, "FROM_LAYERS", SHALLOW)
    v, x, want = jax_runs("lresnet_occ", hw)
    sd = convert.state_dict_from_jax(v["params"], v["batch_stats"],
                                     "lresnet_occ", hw)
    m = from2021.From2021(input_size=hw).eval()
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        fc = m(nchw(x))
        full = ported("lresnet_occ", hw, v)(nchw(x))
    assert torch.equal(fc, full[3])
    assert rel_l2(fc.numpy(), want[3]) <= RTOL


@pytest.mark.parametrize("network", ["sphere", "resnet", "lresnet_occ",
                                     "from2021"])
def test_convert_round_trips(jax_runs, network):
    """flax trees -> state dict -> flax trees bit for bit (From2021's
    under `model`), at 112 x 96."""
    hw = SIZES[0]
    v, _, _ = jax_runs("lresnet_occ" if network == "from2021" else network,
                       hw)
    params, stats = v["params"], v.get("batch_stats", {})
    if network == "from2021":
        params, stats = {"model": params}, {"model": stats}
    sd = convert.state_dict_from_jax(params, stats, network, hw)
    p2, s2 = convert.jax_from_state_dict(sd, network, hw)
    for want, got in ((params, p2), (stats, s2)):
        flat_w, flat_g = convert.flatten(want), convert.flatten(got)
        assert sorted(flat_w) == sorted(flat_g)
        for k in flat_w:
            assert np.array_equal(np.asarray(flat_w[k]), flat_g[k]), k
    sd2 = convert.state_dict_from_jax(p2, s2, network, hw)
    assert sorted(sd) == sorted(sd2)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_convert_refuses_unknown_network():
    with pytest.raises(ValueError, match="unknown network 'vgg'"):
        convert.state_dict_from_jax({}, {}, "vgg")


def test_sphere_names_and_types():
    """The reference's Sequential names; net_type 64's depth; others
    refused."""
    keys = baselines.Sphere().state_dict()
    assert "layer1.0.bias" in keys and "layer1.1.weight" in keys
    assert "layer3.5.prelu2.weight" in keys and "layer3.6.conv1.weight" \
        not in keys
    assert not any(k.endswith("conv1.bias") for k in keys)
    assert keys["fc.weight"].shape == (512, 512 * 7 * 6)
    deep = baselines.Sphere(net_type=64).state_dict()
    assert "layer3.17.conv2.weight" in deep
    with pytest.raises(ValueError, match="sphere36 IS NOT SUPPORTED"):
        baselines.Sphere(net_type=36)
    assert baselines.RESNET_LAYERS["resnet28"] == (3, 4, 3, 3)
    assert baselines.resnet28().layer3[2].conv2.weight.shape == (
        256, 256, 3, 3)


def test_get_grids_matches_jax():
    got, want = from2021.get_grids(112, 96, 5), jfrom2021.get_grids(112, 96,
                                                                   5)
    assert len(got) == len(want) == 226
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def kernel_calls(model, hw):
    """(PReLU calls, routed conv3x3 calls with their input sizes) in one
    forward of `model` at B = 1."""
    calls = {"prelu": 0, "conv": []}
    routed = set(routed_conv_sites(model))
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, PReLU):
            hooks.append(m.register_forward_pre_hook(
                lambda *_: calls.__setitem__("prelu", calls["prelu"] + 1)))
        elif name in routed:
            hooks.append(m.register_forward_pre_hook(
                lambda _, a: calls["conv"].append(tuple(a[0].shape[2:]))))
    with torch.no_grad():
        model(torch.zeros((1, 3) + hw))
    for h in hooks:
        h.remove()
    return calls["prelu"], sorted(calls["conv"])


@pytest.mark.parametrize("network, prelu, convs", [
    ("cosface2018", 20, [(56, 48)] * 2),
    ("from2021", 25, [(56, 48)] * 4 + [(112, 96)]),
    ("iresnet18", 9, [(56, 56)] * 2 + [(112, 112)]),
    ("iresnet50", 25, [(56, 56)] * 4 + [(112, 112)]),
    ("iresnet100", 50, [(56, 56)] * 4 + [(112, 112)])])
def test_kernel_sites_per_forward(network, prelu, convs):
    """The PReLU kernel's and the conv3x3 kernel's launches in one eval
    forward of each network `cli.test --network` builds (FROM's mask head
    PReLU does not run in From2021's forward)."""
    if network == "cosface2018":
        model, hw = baselines.cosface2018(), (112, 96)
    elif network == "from2021":
        model, hw = from2021.From2021(), (112, 96)
    else:
        model, hw = PeerIResNet(IRESNET_LAYERS[network]), (112, 112)
    assert kernel_calls(model.eval(), hw) == (prelu, convs)
