"""The host (PIL) occlusion sweep and `cli.test`'s default protocol, held
against the JAX package on the CPU.

`load_bin_pil` decodes to JAX's pixels; with a deterministic numpy
extractor, `occlusion_sweep` gives JAX's rows and saved feature files
exactly, over both protocols, the three fills and gray input; with the
shallow arc18_msml model in float32 the port's forward sweeps as JAX's
does (features within 2e-5 relative, rows within one pair); `cli.test`
without `--device-sweep` gives the same rows by folder and by `--weight`,
passes `--protocol`, `--repeats`, `--batch-size` and `--save-features`
through, and keeps its refusals.

insightface's 10-fold `evaluate` takes ~1.5 s a call on a CPU, and a sweep
calls it once per ratio and repeat. Where a test holds the sweep's draws,
features and rows rather than that metric, both packages' `evaluate` is
replaced by the same cheap stand-in (`fast_evaluate`); the port's
`evaluate` is held against JAX's in `tests/test_torch_sweep.py`."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.data.bin_loader import load_bin_pil as jax_load_bin_pil
from msml_tpu.eval import verification as jax_verification
from msml_tpu.eval.occ_sweep import occlusion_sweep as jax_sweep
from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
from msml_tpu.nn.msml import msml_from_config as jax_msml
from msml_torch.cli import serve
from msml_torch.cli import test as cli_test
from msml_torch.core.config import save_yaml
from msml_torch.data.bin_loader import load_bin_pil, ppm_encode
from msml_torch.eval import verification
from msml_torch.eval.occ_sweep import occlusion_sweep
from msml_torch.nn.iresnet import IRESNET_LAYERS
from msml_torch.tools import export_torch
from msml_torch.tools.convert import state_dict_from_jax
from tests.test_torch_export_weights import CLASSES, jax_trees
from tests.test_torch_nn import arc18_configs

PAIRS = 20
FEATURE_RTOL = 2e-5  # port vs JAX float32 features, relative L2 per file


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


@pytest.fixture
def fast_evaluate(monkeypatch):
    """Both packages' `evaluate` -> an accuracy at the median distance."""

    def evaluate(embeddings, actual_issame, nrof_folds=10):
        dist = np.sum((embeddings[0::2] - embeddings[1::2]) ** 2, 1)
        acc = np.mean((dist < np.median(dist)) == np.asarray(actual_issame))
        return None, None, np.array([acc]), None, None, None

    for module in (verification, jax_verification):
        monkeypatch.setattr(module, "evaluate", evaluate)


def write_bin(path, encode, pairs=PAIRS, seed=0, size=(112, 112)):
    """`pairs` pairs of RGB images: same pairs differ by +3."""
    rng = np.random.RandomState(seed)
    bins, issame = [], []
    for p in range(pairs):
        a = rng.randint(0, 256, size + (3,)).astype(np.uint8)
        b = (np.clip(a.astype(int) + 3, 0, 255).astype(np.uint8)
             if p % 2 == 0 else
             rng.randint(0, 256, size + (3,)).astype(np.uint8))
        bins += [encode(a), encode(b)]
        issame.append(p % 2 == 0)
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return path


def jpeg(a):
    import cv2

    return cv2.imencode(".jpg", a[:, :, ::-1])[1].tobytes()


class Projection:
    """A deterministic numpy extractor: a fixed random projection of 64
    evenly strided values of each flattened image, recording the batch
    sizes it is given."""

    def __init__(self, dim=16):
        self.w = np.random.RandomState(5).randn(64, dim) / 10.0
        self.sizes = []

    def __call__(self, x):
        self.sizes.append(len(x))
        flat = x.reshape(len(x), -1)
        flat = flat[:, ::flat.shape[1] // 64][:, :64].astype(np.float64)
        return flat @ self.w


@pytest.mark.parametrize("encode", [ppm_encode, jpeg], ids=["ppm", "jpeg"])
def test_load_bin_pil_matches_jax(tmp_path, encode):
    path = write_bin(str(tmp_path / "p.bin"), encode, pairs=3,
                     size=(120, 116))
    got, got_same = load_bin_pil(path)
    want, want_same = jax_load_bin_pil(path)
    assert got_same == want_same and len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.mode == w.mode == "RGB" and g.size == w.size
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("fill", ["black", "white", "gauss"])
@pytest.mark.parametrize("protocol", ["BB", "NB"])
def test_sweep_matches_jax(tmp_path, fast_evaluate, protocol, fill, gray):
    """Rows and per-(ratio, repeat) feature files exactly JAX's, from the
    same PIL images through the same numpy extractor; 2 repeats, batches
    of 7, 8 x 8 crops of 12 x 10 images (the crop is the input size)."""
    path = write_bin(str(tmp_path / "p.bin"), ppm_encode, size=(12, 10))
    imgs, issame = load_bin_pil(path)
    kw = dict(out_size=(8, 8), fill_type=fill, batch_size=7, is_gray=gray,
              repeats=2, dim_feature=16, verbose=False, protocol=protocol)
    got = occlusion_sweep(imgs, issame, Projection(), feature_dir=str(
        tmp_path / "port"), **kw)
    want = jax_sweep(imgs, issame, Projection(), feature_dir=str(
        tmp_path / "jax"), **kw)
    assert got == want
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 1 + 9 * 2
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))


def test_nb_occludes_the_first_image_of_each_pair_only(tmp_path,
                                                       fast_evaluate):
    """At 90 % occlusion with a black fill, NB leaves the odd images as
    they are and blocks the even ones."""
    path = write_bin(str(tmp_path / "p.bin"), ppm_encode, pairs=2)
    imgs, issame = load_bin_pil(path)
    seen = []

    def extract(x):
        seen.append(x.copy())
        return np.zeros((len(x), 4))

    occlusion_sweep(imgs, issame, extract, fill_type="black", repeats=1,
                    dim_feature=4, verbose=False, protocol="NB")
    clean = (np.asarray(imgs, np.float32) / 255.0 - 0.5) / 0.5
    last = seen[-2]  # the 90 % ratio's unflipped pass
    np.testing.assert_array_equal(last[1::2], clean[1::2])
    assert ((last[0::2] == -1.0).all(-1).mean((1, 2)) >= 0.89).all()
    with pytest.raises(ValueError, match="unknown protocol"):
        occlusion_sweep(imgs, issame, extract, protocol="AB")


@pytest.fixture(scope="module")
def weights():
    return jax_trees(seed=2)


def test_shallow_model_sweep_matches_jax(weights, tmp_path, fast_evaluate):
    """The same weights in both packages, float32 on the CPU: the port's
    forward (`cli.serve.numpy_forward`, as `cli.test` runs it) against
    JAX's jitted eval apply, protocol BB, black fill, 1 repeat, 2 pairs."""
    from msml_torch.core.precision import FULL_PRECISION
    from msml_torch.nn.msml import msml_from_config
    from msml_torch.tools.export_serving import EvalForward

    jcfg, tcfg = arc18_configs()
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    params = {k: v for k, v in weights[0].items() if k != "classification"}
    variables = {"params": params, "batch_stats": weights[1]}
    fwd = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)[0])
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, weights[1]))

    pairs = 2
    imgs, issame = load_bin_pil(write_bin(str(tmp_path / "p.bin"),
                                          ppm_encode, pairs=pairs))
    kw = dict(repeats=1, verbose=False, batch_size=2 * pairs)
    got = occlusion_sweep(imgs, issame, serve.numpy_forward(
        EvalForward(model), torch.device("cpu")),
        feature_dir=str(tmp_path / "port"), **kw)
    want = jax_sweep(imgs, issame, lambda x: np.asarray(fwd(variables, x)),
                     feature_dir=str(tmp_path / "jax"), **kw)
    for name in os.listdir(tmp_path / "jax"):
        a, b = (np.load(tmp_path / d / name) for d in ("port", "jax"))
        assert np.linalg.norm(a - b) <= FEATURE_RTOL * np.linalg.norm(b), \
            name
    for g, w in zip(got, want):
        assert g["lo"] == w["lo"]
        assert abs(g["avg_acc"] - w["avg_acc"]) <= 1.0 / pairs, (g, w)


@pytest.fixture(scope="module")
def folder(weights, tmp_path_factory):
    """A weight folder as `cli.train` leaves it (config.yaml and
    ckpt/3.pt), and a folder with its config.yaml only."""
    out = tmp_path_factory.mktemp("folder")
    cfg = dict(chip_smoke.ARC18_MSML, dataset="synthetic",
               num_classes=CLASSES, fp16=False)
    save_yaml(cfg, str(out / "config.yaml"))
    os.makedirs(out / "ckpt")
    torch.save({"model": state_dict_from_jax(*weights), "step": 3},
               str(out / "ckpt" / "3.pt"))
    bare = tmp_path_factory.mktemp("config_only")
    save_yaml(cfg, str(bare / "config.yaml"))
    return str(out), str(bare)


def run_test(*argv):
    return cli_test.main(cli_test.parse_args(["--device", "cpu", *argv]))


def test_cli_rows_by_folder_and_by_weight(folder, tmp_path):
    """The host sweep by default, with insightface's `evaluate` (20 pairs
    for its 10 folds): the same rows from the folder's checkpoint and from
    its exported backbone.pth through `--weight` (no occlusion: one
    `evaluate` and 80 images each)."""
    trained, bare = folder
    bin_path = write_bin(str(tmp_path / "p.bin"), ppm_encode)
    pth = export_torch.main(export_torch.parse_args(
        ["--weight_folder", trained, "--out", str(tmp_path / "b.pth")]))
    argv = ["--bin", bin_path, "--no-occ", "--out-json",
            str(tmp_path / "rows.json")]
    by_folder = run_test("--weight_folder", trained, *argv)
    by_weight = run_test("--weight_folder", bare, "--weight", pth, *argv)
    assert len(by_folder) == 1 and by_folder == by_weight
    assert all(0.0 <= r["avg_acc"] <= 1.0 for r in by_folder)


def test_cli_passes_the_protocol_flags(folder, tmp_path, monkeypatch,
                                      fast_evaluate):
    """`--protocol NB --repeats 2 --batch-size 8 --save-features`: with the
    model's forward replaced by a numpy projection, the CLI's rows and
    files are `occlusion_sweep`'s with the same arguments."""
    trained, _ = folder
    fake = Projection(dim=512)
    monkeypatch.setattr(serve, "numpy_forward", lambda module, device: fake)
    path = write_bin(str(tmp_path / "p.bin"), ppm_encode)
    rows = run_test("--weight_folder", trained, "--bin", path, "--protocol",
                    "NB", "--repeats", "2", "--batch-size", "8",
                    "--fill_type", "gauss", "--save-features",
                    str(tmp_path / "feats"))
    assert max(fake.sizes) == 8
    want = occlusion_sweep(*load_bin_pil(path), Projection(dim=512),
                           fill_type="gauss", batch_size=8, repeats=2,
                           verbose=False, protocol="NB")
    assert rows == want
    assert len(os.listdir(tmp_path / "feats")) == 1 + 9 * 2


@pytest.mark.parametrize("argv, message", [
    (["--network", "iresnet18_v"], "not ported yet: --network"),
    (["--vis"], "not ported yet: --vis"),
    (["--network", "iresnet18_v", "--quant", "int8"],
     "not ported yet: --network iresnet18_v$"),
    (["--device-sweep", "--protocol", "NB"],
     "--device-sweep supports protocol BB only"),
    ([], "--weight_folder required")])
def test_cli_refusals(folder, argv, message):
    if argv and argv[0] == "--device-sweep":
        argv = argv + ["--weight_folder", folder[0]]
    with pytest.raises(SystemExit, match=message):
        run_test(*argv)
