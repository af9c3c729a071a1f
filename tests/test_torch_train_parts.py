"""The training slice's parts in the port against their JAX counterparts,
on the CPU, in float32 with the same inputs (numpy, seeded).

Covered: the uint8 input stage, the margin heads, the losses, the LR
schedule and groups, BatchNorm's train-mode running statistics, the
synthetic batches, the converter's head and the `+ kd` logit shift. Each
test states its tolerance; "float32 order" means the two frameworks sum in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from msml_tpu.core import config as jconfig
from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.data import synthetic as jsynthetic
from msml_tpu.heads import margin as jmargin
from msml_tpu.kernels.augment import device_input_stage as jax_input_stage
from msml_tpu.losses.ce import cross_entropy as jax_ce
from msml_tpu.losses.consensus import structure_consensus_loss as jax_seg
from msml_tpu.nn import common as jcommon
from msml_tpu.nn import iresnet as jiresnet
from msml_tpu.nn.msml import msml_from_config as jax_msml
from msml_tpu.train import optim as joptim
from msml_torch.core import config as tconfig
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.data.synthetic import synthetic_batch
from msml_torch.heads import margin
from msml_torch.kernels.augment import (augment_batch_reference,
                                        device_input_stage)
from msml_torch.losses.ce import cross_entropy
from msml_torch.losses.consensus import structure_consensus_loss
from msml_torch.nn import common
from msml_torch.nn import iresnet as tiresnet
from msml_torch.nn.msml import msml_from_config
from msml_torch.tools import convert
from msml_torch.train.optim import param_groups

ARC18 = {
    "dataset": "webface", "fp16": True, "batch_size": 128,
    "frb_type": "iresnet18", "osb_type": "unet", "use_osb": True,
    "fm_layers": [1, 1, 1, 1], "fm_params": [3, 2, "sigmoid", "mul"],
    "peer_params": {"use_ori": False, "use_conv": False,
                    "mask_trans": "conv", "use_decoder": False},
    "header_type": "AMArcFace", "header_params": [64.0, 0.48, 0.0, 0.0],
    "device_light": True, "exp_id": 1, "output_prefix": "arc18_msml",
}


def configs(**over):
    d = dict(ARC18, **over)
    return (jconfig.config_init(jconfig.Config.from_dict(d),
                                make_output_dir=False),
            tconfig.config_init(tconfig.Config.from_dict(d),
                                make_output_dir=False))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ input stage

@pytest.mark.parametrize("gauss_light", [True, False])
@pytest.mark.parametrize("use_norm", [True, False])
def test_input_stage_matches_jax(gauss_light, use_norm):
    """uint8 -> /255 -> relight -> normalize, with JAX's draws injected
    (augment.py:51-54); max abs <= 1e-6 (exp and division in another
    library; the light's scale, 0.7 + 0.7 u, cancels in the max)."""
    img = np.random.RandomState(0).randint(0, 256, (4, 112, 112, 3),
                                           dtype=np.uint8)
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax_input_stage(jnp.asarray(img), rng,
                                      gauss_light=gauss_light,
                                      use_norm=use_norm))
    draws = np.stack([np.asarray(jax.random.uniform(k, (4,)))
                      for k in jax.random.split(rng, 3)], 1)
    # one intra-op thread: the first parallel CPU torch.exp of a process
    # has come back up to 1.5e-4 off under load
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = device_input_stage(t(img), t(draws) if gauss_light else None,
                                 gauss_light, use_norm)
    finally:
        torch.set_num_threads(threads)
    assert got.shape == (4, 3, 112, 112) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("fill", ["black", "gauss"])
def test_uint8_input_equals_float_input(fill):
    """A uint8 image gives exactly what its f32 / 255 gives, through the
    block fill, the relight and the normalize."""
    rs = np.random.RandomState(1)
    img = t(rs.randint(0, 256, (3, 112, 112, 3), dtype=np.uint8))
    draws = t(rs.rand(3, 6).astype(np.float32))
    noise = t(rs.randn(3, 112, 112, 3).astype(np.float32))
    kw = dict(lo=20, hi=51, fill=fill, relight=True, use_norm=True)
    torch.testing.assert_close(
        augment_batch_reference(img, draws, noise, **kw),
        augment_batch_reference(img.float() / 255.0, draws, noise, **kw),
        rtol=0, atol=0)


# ------------------------------------------------------------ heads

def test_l2_normalize_and_cosine_logits_match_jax():
    """rtol 1e-5, atol 1e-6 (float32 order)."""
    rs = np.random.RandomState(2)
    emb = rs.randn(5, 16).astype(np.float32)
    w = rs.randn(9, 16).astype(np.float32)
    np.testing.assert_allclose(margin.l2_normalize(t(emb)).numpy(),
                               np.asarray(jmargin.l2_normalize(emb)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(margin.cosine_logits(t(emb), t(w)).numpy(),
                               np.asarray(jmargin.cosine_logits(emb, w)),
                               rtol=1e-5, atol=1e-6)


def test_zero_feature_has_finite_gradient():
    """A zero embedding row (the feature BN at one sample per device gives
    it): finite gradients, equal to JAX's (rtol 1e-6)."""
    emb = np.random.RandomState(3).randn(3, 8).astype(np.float32)
    emb[1] = 0.0
    te = t(emb).requires_grad_()
    margin.l2_normalize(te).sum().backward()
    want = np.asarray(jax.grad(lambda v: jmargin.l2_normalize(v).sum())(
        jnp.asarray(emb)))
    assert np.isfinite(te.grad.numpy()).all()
    np.testing.assert_allclose(te.grad.numpy(), want, rtol=1e-6, atol=0)


HEADS = {"AMArcFace": (64.0, 0.48, 0.0, 0.0),
         "AMCosFace": (64.0, 0.4, 1.2, 0.1),
         "Softmax": (64.0, 0.5, 0.0, 0.0)}


@pytest.mark.parametrize("header_type", sorted(HEADS))
def test_margins_match_jax(header_type):
    """get_margin_fn on the cosine matrix of normalized embeddings and
    weights, label -1 rows included: logits and their gradients w.r.t. the
    embedding and the weight, rtol 1e-4, atol 1e-4 (logits scale by 64)."""
    rs = np.random.RandomState(4)
    emb = rs.randn(6, 32).astype(np.float32)
    w = rs.randn(10, 32).astype(np.float32)
    label = np.array([3, -1, 0, 9, -1, 3], np.int32)
    g = rs.randn(6, 10).astype(np.float32)
    params = HEADS[header_type]

    def jfn(e, wt):
        fn = jmargin.get_margin_fn(header_type, params)
        return (fn(jmargin.cosine_logits(e, wt), jnp.asarray(label))
                * g).sum()

    val = jfn(jnp.asarray(emb), jnp.asarray(w))
    ge, gw = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    te, tw = t(emb).requires_grad_(), t(w).requires_grad_()
    fn = margin.get_margin_fn(header_type, params)
    tval = (fn(margin.cosine_logits(te, tw), t(label)) * t(g)).sum()
    tval.backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tval.item(), float(val), **tol)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **tol)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **tol)


def test_golden_6x8_fixture():
    """The reference's own fixture (margin_losses.py:431-439, the case of
    tests/test_margin_heads.py): both margins against JAX, rtol 1e-4 and
    atol 1e-5 as that test holds AMArcFace (acos and cos in another
    library), and the label -1 rows come back as s * cosine."""
    rng = np.random.RandomState(0)
    cosine = rng.randn(6, 8).astype(np.float32) / 100
    for i, (j, v) in enumerate([(2, .3), (4, .4), (6, .5), (5, .6), (3, .7),
                                (0, .8)]):
        cosine[i][j] = v
    label = np.array([-1, 4, -1, 5, 3, -1], dtype=np.int32)
    for fn, jfn, p in ((margin.amcos_margin, jmargin.amcos_margin,
                        (1.0, 0.35, 1.2, 0.1)),
                       (margin.amarc_margin, jmargin.amarc_margin,
                        (64.0, 0.48, 0.0, 0.0))):
        got = fn(t(cosine), t(label), *p).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(cosine, label, *p)),
                                   rtol=1e-4, atol=1e-5)
        rows = label == -1
        np.testing.assert_allclose(got[rows], p[0] * cosine[rows],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("header_type", ["Softmax", "AMArcFace"])
def test_head_modules_and_converter_match_jax(header_type):
    """SoftmaxHead / MarginHead with the flax head's weights carried by
    convert.state_dict_from_jax (weight, and bias for Softmax): logits
    rtol 1e-5, atol 1e-4."""
    rs = np.random.RandomState(5)
    emb = rs.randn(4, 16).astype(np.float32)
    label = np.array([1, 0, 6, 2], np.int32)
    s, m, a, k = HEADS[header_type]
    if header_type == "Softmax":
        jhead = jmargin.SoftmaxHead(7)
        head = margin.SoftmaxHead(7, 16)
    else:
        jhead = jmargin.MarginHead(7, header_type, s, m, a, k)
        head = margin.MarginHead(7, 16, header_type, s, m, a, k)
    v = jhead.init(jax.random.PRNGKey(0), emb, label)
    v = jax.tree.map(lambda x: np.asarray(x) + rs.uniform(
        -0.05, 0.05, x.shape).astype(np.float32), v)
    sd = convert.state_dict_from_jax(*_small_msml_tree(v["params"]))
    head_sd = {k[len("classification."):]: x for k, x in sd.items()
               if k.startswith("classification.")}
    assert sorted(head_sd) == sorted(v["params"])
    head.load_state_dict(head_sd, strict=True)
    want = np.asarray(jhead.apply(v, emb, label))
    np.testing.assert_allclose(head(t(emb), t(label)).detach().numpy(),
                               want, rtol=1e-5, atol=1e-4)


def _small_msml_tree(head_params):
    """(params, batch_stats) of a flax MSML without OSB and FM operators,
    zeros but for `head_params` as its head."""
    jcfg, _ = configs(use_osb=False, fm_layers=[0, 0, 0, 0])
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    x = np.zeros((2, 112, 112, 3), np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, None, None, train=True))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    params = dict(zeros["params"], classification=head_params)
    return params, zeros["batch_stats"]


# ------------------------------------------------------------ losses

def test_cross_entropy_matches_jax():
    """rtol 1e-6 (float32 order)."""
    rs = np.random.RandomState(6)
    logits = (rs.randn(8, 50) * 20).astype(np.float32)
    label = rs.randint(0, 50, 8).astype(np.int32)
    np.testing.assert_allclose(cross_entropy(t(logits), t(label)).item(),
                               float(jax_ce(logits, label)), rtol=1e-6)


def _blobs(case, rs):
    blobs = (rs.rand(3, 16, 16) > 0.6).astype(np.int32)
    if case == "one_sample_clean":
        blobs[0] = 1
    elif case == "all_clean":
        blobs[:] = 1
    elif case == "all_occluded":
        blobs[:] = 0
    return blobs


@pytest.mark.parametrize("case", ["both_present", "one_sample_clean",
                                  "all_clean", "all_occluded"])
def test_consensus_loss_matches_jax(case):
    """Value rtol 1e-5 and gradient w.r.t. the logits rtol 1e-4, atol 1e-7
    (float32 order), on NCHW against the JAX NHWC function. Masks: 1 =
    clean, 0 = occluded; an absent blob is skipped."""
    rs = np.random.RandomState(7)
    logit = rs.randn(3, 2, 16, 16).astype(np.float32)
    blobs = _blobs(case, rs)
    jl = jnp.asarray(logit.transpose(0, 2, 3, 1))
    val, grad = jax.value_and_grad(lambda v: jax_seg(v, blobs))(jl)
    tl = t(logit).requires_grad_()
    loss = structure_consensus_loss(tl, t(blobs))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(),
                               np.asarray(grad).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-7)


# ------------------------------------------------------------ schedule

def test_lr_step_factor_matches_jax():
    for over in ({}, {"warmup_epoch": 5}):
        jcfg, tcfg = configs()
        jcfg.update(over)
        tcfg.update(over)
        for epoch in range(40):
            assert tconfig.lr_step_factor(tcfg, epoch) == \
                jconfig.lr_step_factor(jcfg, epoch)


@pytest.mark.parametrize("pretrained", [False, True])
def test_lr_groups_match_build_lr_scales(pretrained):
    """Every port parameter lands in the group whose lr equals the scale
    `build_lr_scales` gives its flax path (the flax tree of scales carried
    to the port's names by the converter), at world size 2."""
    jcfg, tcfg = configs()
    jcfg.pretrained = tcfg.pretrained = pretrained
    jmodel = jax_msml(jcfg, policy=JAX_F32)
    x = np.zeros((2, 112, 112, 3), np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, np.zeros((2,), np.int32), None, train=True))
    scales = joptim.build_lr_scales(shapes["params"], jcfg, 2)
    scale_tree = jax.tree.map(
        lambda s, lr: np.full(s.shape, lr, np.float32), shapes["params"],
        scales)
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes["batch_stats"])
    want = convert.state_dict_from_jax(scale_tree, stats)

    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    names = {p: n for n, p in model.named_parameters()}
    seen = set()
    for group in param_groups(model, tcfg, world_size=2):
        for p in group["params"]:
            lr = want[names[p]].unique()
            assert lr.numel() == 1 and np.isclose(float(lr), group["lr"],
                                                  rtol=1e-6), names[p]
            seen.add(names[p])
    assert seen == {n for n, p in model.named_parameters()
                    if n != "frb.features.weight"}
    assert len({g["lr"] for g in param_groups(model, tcfg, 2)}) == \
        (3 if pretrained else 2)


# ------------------------------------------------------------ BatchNorm

def test_batch_norm_2d_running_stats_match_flax():
    """Fault 2 of the eval slice: one train-mode forward updates the
    running variance from the biased batch variance, as flax does (atol
    1e-6); torch's own BatchNorm2d lands n / (n - 1) higher. Output atol
    1e-5."""
    rs = np.random.RandomState(8)
    x = (rs.randn(2, 3, 3, 4) * 2 + 1).astype(np.float32)   # n = 18
    mod = jcommon.batch_norm(True)
    v = mod.init(jax.random.PRNGKey(0), x)
    want, upd = mod.apply(v, x, mutable=["batch_stats"])
    m = common.batch_norm(4).train()
    got = m(t(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               want, atol=1e-5, rtol=0)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(m.running_mean.numpy(), stats["mean"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(m.running_var.numpy(), stats["var"],
                               atol=1e-6, rtol=0)
    plain = torch.nn.BatchNorm2d(4).train()
    plain(t(x.transpose(0, 3, 1, 2)))
    biased = x.reshape(-1, 4).var(0)
    np.testing.assert_allclose(plain.running_var.numpy(),
                               0.9 + 0.1 * biased * 18 / 17, rtol=1e-5)


def test_features_batch_norm_1d_matches_flax():
    """The `features` BatchNorm1d (scale frozen at 1) at B = 4 over two
    train-mode steps: output atol 1e-5, running stats atol 1e-6 (at n = 4
    torch's own update would be 4/3 too high)."""
    rs = np.random.RandomState(9)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, use_scale=False, use_bias=True)
    xs = [rs.randn(4, 6).astype(np.float32) * 3 for _ in range(2)]
    v = mod.init(jax.random.PRNGKey(0), xs[0])
    m = common.BatchNorm1d(6, eps=1e-5).train()
    for x in xs:
        want, upd = mod.apply(v, x, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        np.testing.assert_allclose(m(t(x)).detach().numpy(), want,
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               v["batch_stats"]["mean"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(m.running_var.numpy(),
                               v["batch_stats"]["var"], atol=1e-6, rtol=0)


# ------------------------------------------------------------ data, model

def test_synthetic_batch_matches_jax():
    for uint8 in (True, False):
        want = jsynthetic.synthetic_batch(3, num_classes=17, seed=5,
                                          uint8=uint8)
        got = synthetic_batch(3, num_classes=17, seed=5, uint8=uint8)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_training_forward_adds_kd_to_logits(monkeypatch):
    """`final_cls = head(feature, label) + kd` (msml_tpu/nn/msml.py:182):
    the port's training forward against flax's on the same weights, kd 0.0
    on both sides for the peer-less model; logits rtol 1e-4, atol 1e-3
    (scale 64); BN in train mode. One block per stage, no OSB."""
    monkeypatch.setitem(jiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
    monkeypatch.setitem(tiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
    jcfg, tcfg = configs(use_osb=False, fm_layers=[0, 0, 0, 0],
                         dataset="synthetic", num_classes=12)
    jmodel = jax_msml(jcfg, policy=JAX_F32)
    rs = np.random.RandomState(10)
    x = rs.randn(3, 112, 112, 3).astype(np.float32)
    label = np.array([1, 11, 4], np.int32)
    v = jmodel.init({"params": jax.random.PRNGKey(1),
                     "dropout": jax.random.PRNGKey(1)}, x, label, None,
                    train=True)
    (cls, seg, kd), _ = jmodel.apply(v, x, label, None, train=True,
                                     mutable=["batch_stats"])
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    model.load_state_dict(convert.state_dict_from_jax(
        jax.device_get(v["params"]), jax.device_get(v["batch_stats"])),
        strict=True)
    model.train()
    tcls, tseg, tkd = model(t(x.transpose(0, 3, 1, 2)), t(label), train=True)
    assert kd == tkd == 0.0 and seg is None and tseg is None
    np.testing.assert_allclose(tcls.detach().numpy(), np.asarray(cls),
                               rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):
        model.eval()(t(x.transpose(0, 3, 1, 2)), t(label), train=True)
