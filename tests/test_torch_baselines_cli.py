"""`cli.test --network` (the baselines) in the port against the JAX
package on the CPU.

One `.pth` a network, drawn from numpy with the reference's torch names
(every tensor: conv and linear weights lecun-normal, biases, BN scales and
statistics and PReLU slopes drawn, the frozen `features` scale at 1), goes
through the JAX package's `_build_baseline` (`import_sphere` /
`import_from2021` / `import_iresnet_trunk` + `merge_into`, jitted in
FULL_PRECISION) and through the port's `_build_baseline` (a strict load):
both give the same float32 features (relative L2 error <= 1e-4) and the
same config. FROM at one block per stage and iResNet-18 at one block per
stage for time (both packages patched alike); Sphere-20 at full depth.
Then `cli.test --network ... --device cpu` end to end on a 4-pair `.bin`
(the host sweep with saved features against JAX's sweep with JAX's
forward, the device sweep's crop to 112 x 96, both with a stand-in for
insightface's `evaluate`, which `tests/test_torch_cli_parts.py` holds), the
refusals with JAX's messages, and one Sphere image through `--quant int8`
against JAX's `quantize_fn` on the same weights.
"""

import argparse
import functools
import os
import pickle

import numpy as np
import pytest
import torch

import msml_tpu.nn.from2021 as jax_from2021
import msml_tpu.tools.import_torch as jax_import
from msml_tpu.cli import test as jax_cli
from msml_tpu.eval import verification as jax_verification
from msml_tpu.eval.occ_sweep import occlusion_sweep as jax_sweep
from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
from msml_torch.cli import test as cli_test
from msml_torch.core.quantize import quant_sites, quantize_eval_model
from msml_torch.data.bin_loader import load_bin_pil, ppm_encode
from msml_torch.eval import verification
from msml_torch.nn import baselines, from2021
from msml_torch.nn.common import PReLU
from msml_torch.nn.iresnet import IRESNET_LAYERS, PeerIResNet

SHALLOW = (1, 1, 1, 1)
RTOL = 1e-4  # relative L2 error of the float32 features
QUANT_RTOL = 2e-3  # int8 features, port vs JAX: one int8 code off by one
PAIRS = 4
HW = {"cosface2018": (112, 96), "from2021": (112, 96),
      "iresnet18_v": (112, 112)}


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
    """FROM and iResNet-18 at one block per stage in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(from2021, "FROM_LAYERS", SHALLOW)
        mp.setattr(jax_from2021, "LResNetOcc", functools.partial(
            jax_from2021.LResNetOcc, layers=SHALLOW))
        mp.setattr(jax_import, "import_from2021", functools.partial(
            jax_import.import_from2021, layers=SHALLOW))
        mp.setitem(JAX_LAYERS, "iresnet18", SHALLOW)
        mp.setitem(IRESNET_LAYERS, "iresnet18", SHALLOW)
        yield


@pytest.fixture
def fast_evaluate(monkeypatch):
    """Both packages' `evaluate` -> an accuracy at the median distance."""

    def evaluate(embeddings, actual_issame, nrof_folds=10):
        dist = np.sum((embeddings[0::2] - embeddings[1::2]) ** 2, 1)
        acc = np.mean((dist < np.median(dist)) == np.asarray(actual_issame))
        return None, None, np.array([acc]), None, None, None

    for module in (verification, jax_verification):
        monkeypatch.setattr(module, "evaluate", evaluate)


def network_module(network):
    if network == "cosface2018":
        return baselines.cosface2018()
    if network == "from2021":
        return from2021.From2021()
    return PeerIResNet(IRESNET_LAYERS["iresnet18"])


@torch.no_grad()
def draw_reference_state_dict(model, seed):
    """Every tensor of `model`'s state dict drawn from numpy, under its
    names (the reference's): conv / linear weights N(0, 1 / fan_in),
    biases N(0, 0.05), BN scale U(0.5, 1.5), running mean N(0, 0.1) and
    variance U(0.5, 1.5), PReLU slopes U(0.1, 0.4); `features.weight` 1."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, m in model.named_modules():
        p = name + "." if name else ""
        if isinstance(m, PReLU):
            sd[p + "weight"] = rs.uniform(0.1, 0.4, m.weight.shape)
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            sd[p + "weight"] = rs.uniform(0.5, 1.5, m.weight.shape)
            sd[p + "bias"] = rs.randn(*m.bias.shape) * 0.05
            sd[p + "running_mean"] = rs.randn(*m.running_mean.shape) * 0.1
            sd[p + "running_var"] = rs.uniform(0.5, 1.5,
                                               m.running_var.shape)
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            fan_in = m.weight[0].numel()
            sd[p + "weight"] = rs.randn(*m.weight.shape) / np.sqrt(fan_in)
            if m.bias is not None:
                sd[p + "bias"] = rs.randn(*m.bias.shape) * 0.05
    out = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
           sd.items()}
    full = model.state_dict()
    out.update({k: v for k, v in full.items() if k not in out})
    if "features.weight" in out:
        out["features.weight"] = torch.ones_like(out["features.weight"])
    assert sorted(out) == sorted(full)
    return out


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    """network -> the path of its drawn reference `.pth` (FROM's under
    "state_dict", as its release keeps it)."""
    root = tmp_path_factory.mktemp("baselines")
    paths = {}
    for i, network in enumerate(HW):
        sd = draw_reference_state_dict(network_module(network), seed=10 + i)
        paths[network] = str(root / f"{network}.pth")
        torch.save({"state_dict": sd} if network == "from2021" else sd,
                   paths[network])
    return paths


def args_for(network, weight, quant=""):
    return argparse.Namespace(network=network, weight=weight, quant=quant)


@pytest.fixture(scope="module")
def jax_builds(pths):
    """network, quant -> JAX's (extract_fn, cfg), built once each."""
    cache = {}

    def build(network, quant=""):
        if (network, quant) not in cache:
            cache[network, quant] = jax_cli._build_baseline(
                args_for(network, pths[network], quant))
        return cache[network, quant]

    return build


def images(network, n=4, seed=4):
    h, w = HW[network]
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, h, w, 3)).astype(np.float32)


def port_features(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
                     )[0].numpy()


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("network", list(HW))
def test_features_match_jax(pths, jax_builds, network):
    """The same `.pth` through JAX's importer and the port's strict load:
    the same features, the same config."""
    extract_fn, jcfg = jax_builds(network)
    cfg, model = cli_test._build_baseline(
        args_for(network, pths[network]), torch.device("cpu"))
    assert not model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = images(network)
    got, want = port_features(model, x), np.asarray(extract_fn(x))
    assert got.shape == want.shape == (4, 512)
    assert rel_l2(got, want) <= RTOL
    for key in ("out_size", "use_norm", "is_gray", "dim_feature", "rec"):
        assert tuple(np.atleast_1d(cfg[key])) == tuple(
            np.atleast_1d(jcfg[key])), key
    assert tuple(cfg.out_size) == HW[network][::-1]


def test_vanilla_features_scale_warns_and_stays_one(pths, tmp_path):
    """A vanilla iResNet `.pth` whose frozen `features` scale is not 1:
    JAX's warning, and the scale kept at 1 (JAX's head has none)."""
    sd = torch.load(pths["iresnet18_v"])
    sd["features.weight"] = sd["features.weight"] * 2
    path = str(tmp_path / "scaled.pth")
    torch.save(sd, path)
    with pytest.warns(UserWarning, match="features BN scale != 1.0"):
        _, model = cli_test._build_baseline(args_for("iresnet18_v", path),
                                            torch.device("cpu"))
    assert torch.equal(model.features.weight,
                       torch.ones_like(model.features.weight))


def write_bin(path, pairs=PAIRS, seed=0):
    """`pairs` pairs of 112 x 112 RGB PPM images: same pairs differ by
    +3."""
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
    return str(path)


@pytest.mark.parametrize("network, extra", [
    ("cosface2018", ["--repeats", "1"]),
    ("from2021", ["--no-occ", "--protocol", "NB"]),
    ("iresnet18_v", ["--no-occ"])])
def test_cli_host_sweep_matches_jax(pths, jax_builds, fast_evaluate,
                                    tmp_path, network, extra):
    """`cli.test --network ... --device cpu` (the host sweep) against
    JAX's sweep with JAX's baseline forward: the saved features within
    RTOL, the same rows."""
    bin_path = write_bin(tmp_path / "pairs.bin")
    rows = cli_test.main(cli_test.parse_args(
        ["--network", network, "--weight", pths[network], "--bin", bin_path,
         "--device", "cpu", "--batch-size", "4", "--save-features",
         str(tmp_path / "port")] + extra))
    extract_fn, cfg = jax_builds(network)
    imgs, issame = load_bin_pil(bin_path)
    want = jax_sweep(
        imgs, issame, lambda x: np.asarray(extract_fn(x)),
        out_size=tuple(cfg.out_size), batch_size=4,
        no_occ="--no-occ" in extra, dim_feature=512,
        feature_dir=str(tmp_path / "jax"),
        protocol="NB" if "NB" in extra else "BB", repeats=1)
    assert [r["lo"] for r in rows] == [r["lo"] for r in want]
    assert len(rows) == (1 if "--no-occ" in extra else 10)
    for r, w in zip(rows, want):
        assert r["avg_acc"] == w["avg_acc"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert rel_l2(np.load(tmp_path / "port" / name),
                      np.load(tmp_path / "jax" / name)) <= RTOL, name


def test_cli_device_sweep_crops_to_112x96(pths, fast_evaluate, tmp_path,
                                          monkeypatch):
    """`--device-sweep` on Sphere-20: the `.bin`'s 112 x 112 images
    center-cropped to 112 x 96 on the host (PIL CenterCrop's columns,
    8 to 104), flipped after the crop, through the augment kernel's plain
    version on the CPU."""
    from msml_torch.eval import occ_sweep_device

    seen = []
    sweep = occ_sweep_device.occlusion_sweep_device

    def spy(data_list, issame, extract_fn, **kw):
        seen.append(data_list)
        return sweep(data_list, issame, extract_fn, **kw)

    monkeypatch.setattr(occ_sweep_device, "occlusion_sweep_device", spy)
    bin_path = write_bin(tmp_path / "pairs.bin")
    rows = cli_test.main(cli_test.parse_args(
        ["--network", "cosface2018", "--weight", pths["cosface2018"],
         "--bin", bin_path, "--device", "cpu", "--device-sweep",
         "--no-occ"]))
    imgs, _ = load_bin_pil(bin_path)
    orig, flipped = seen[0]
    assert orig.shape == (2 * PAIRS, 112, 96, 3)
    want = np.stack([np.asarray(im, np.float32)[:, 8:104] for im in imgs])
    assert np.array_equal(orig, want)
    assert np.array_equal(flipped, want[:, :, ::-1])
    assert len(rows) == 1 and 0.0 <= rows[0]["avg_acc"] <= 1.0


@pytest.mark.parametrize("argv, message", [
    (["--network", "cosface2018"],
     "^--network cosface2018 requires --weight .pth$"),
    (["--network", "vgg16", "--weight", "WEIGHT"],
     "^unknown --network vgg16$"),
    (["--network", "cosface2018", "--weight", "WEIGHT", "--vis"],
     r"^--vis is MSML-only \(FM internals\)$")])
def test_cli_refusals(pths, argv, message):
    argv = [pths["cosface2018"] if a == "WEIGHT" else a for a in argv]
    with pytest.raises(SystemExit, match=message):
        cli_test.main(cli_test.parse_args(argv + ["--device", "cpu"]))


def test_unknown_iresnet_depth_fails_as_jax(pths):
    """An iResNet depth with no layers fails in both packages with the
    same KeyError."""
    args = args_for("iresnet7_v", pths["iresnet18_v"])
    with pytest.raises(KeyError) as want:
        jax_cli._build_baseline(args)
    with pytest.raises(KeyError) as got:
        cli_test._build_baseline(args, torch.device("cpu"))
    assert got.value.args == want.value.args


def test_quant_int8_sphere_matches_jax(pths, jax_builds):
    """One Sphere-20 image through `--quant int8`: the port's
    `quantize_eval_model` (float32 ops, int8 codes; the CPU's plain
    kernels) against JAX's `quantize_fn` on the same weights: 19 of the 20
    convs and the fc quantized, the first conv (contraction 27) kept in
    float32 on both sides. Bit-equal here; the kept conv sums in another
    order than XLA's, which may move an int8 code of the next site by one,
    so the bound is QUANT_RTOL relative L2."""
    extract_fn, _ = jax_builds("cosface2018", "int8")
    _, model = cli_test._build_baseline(
        args_for("cosface2018", pths["cosface2018"]), torch.device("cpu"))
    qmodel = quantize_eval_model(model, (112, 96, 3))
    sites = quant_sites(qmodel)
    assert len(sites) == 20 and "net.layer1.0" not in sites
    x = images("cosface2018", n=1)
    got, want = port_features(qmodel, x), np.asarray(extract_fn(x))
    assert rel_l2(got, want) <= QUANT_RTOL
    assert rel_l2(got, port_features(model, x)) > 0
