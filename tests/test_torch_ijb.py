"""IJB-B / IJB-C 1:1 template verification (`msml_torch/eval/ijb.py`,
`msml_torch/cli/eval_ijb.py`) and the eval fixtures tool
(`msml_torch/tools/make_synthetic_eval_fixtures.py`) against the JAX
package's on the CPU.

Every numpy function on the same arrays: equal, or within 1e-12 where the
float order differs (the AUC's trapezoid, sklearn's `auc`). The alignment
against JAX's with its numpy Umeyama (JAX's native library, where built,
sums in another order). `tpr_at_fpr_table` on the port's ROC curve against
JAX's on sklearn's. The fixture tool writes JAX's files byte for byte.
`cli.eval_ijb --device cpu` on a tiny fixture from the port's tool and a
weight folder of arc18_msml at one block per stage: its aligned crops,
occlusion draws and features through JAX's `extract_ijb_features`, its
scores and table through JAX's protocol, once plain and once with
`--lo 40 --hi 41` (10 repeats); a gray folder is refused.
"""

import csv
import os

import numpy as np
import pytest
import torch
import yaml

import msml_tpu.tools.native as jax_native
from msml_tpu.cli import eval_ijb as jax_cli
from msml_tpu.data.rand_occ import RandomBlock as JaxBlock
from msml_tpu.eval import ijb as jijb
from msml_tpu.tools import make_synthetic_eval_fixtures as jax_fixtures
from msml_torch.cli import eval_ijb as cli
from msml_torch.data.rand_occ import RandomBlock
from msml_torch.eval import ijb
from msml_torch.tools import make_synthetic_eval_fixtures as fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_numpy_umeyama(monkeypatch):
    """JAX's alignment through its numpy Umeyama, as the port's."""
    monkeypatch.setattr(jax_native, "similar_transform",
                        jax_native._umeyama_np)


def test_umeyama_matches_jax():
    rs = np.random.RandomState(0)
    cases = [rs.randn(5, 2).astype(np.float32) * 20 + 50 for _ in range(4)]
    cases.append(ijb.ARCFACE_DST[:, ::-1].copy())  # a reflection
    cases.append(np.repeat(np.arange(5, dtype=np.float32)[:, None], 2,
                           1))  # collinear: rank 1
    assert np.array_equal(ijb.ARCFACE_DST, jax_native.ARCFACE_DST)
    for src in cases:
        dst = ijb.ARCFACE_DST * 1.5
        got, want = ijb.umeyama(src, dst), jax_native._umeyama_np(src, dst)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_lmk68_to_5_and_align_face_match_jax(jax_numpy_umeyama):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (130, 120, 3)).astype(np.uint8)
    lmk68 = rs.uniform(20, 100, (68, 2)).astype(np.float32)
    np.testing.assert_array_equal(ijb.lmk68_to_5(lmk68),
                                  jijb.lmk68_to_5(lmk68))
    lmk5 = (ijb.ARCFACE_DST + rs.randn(5, 2) * 3).astype(np.float32)
    for lmk, size in ((lmk68, 112), (lmk5, 112), (lmk5, 96)):
        got = ijb.align_face(img, lmk, size)
        assert got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, jijb.align_face(img, lmk, size))


def write_meta(tmp_path, n=12, templates=4, pairs=10, seed=2):
    rs = np.random.RandomState(seed)
    tid = rs.randint(0, templates, n)
    mid = tid * 10 + rs.randint(0, 2, n)
    (tmp_path / "tid_mid.txt").write_text("".join(
        f"img{i}.jpg {t} {m}\n" for i, (t, m) in enumerate(zip(tid, mid))))
    p = rs.randint(0, templates, (pairs, 2))
    (tmp_path / "pairs.txt").write_text("".join(
        f"{a} {b} {int(rs.rand() < 0.5)}\n" for a, b in p))
    return str(tmp_path / "tid_mid.txt"), str(tmp_path / "pairs.txt")


def test_readers_match_jax(tmp_path):
    tm, pairs = write_meta(tmp_path)
    for got, want in ((ijb.read_template_media_list(tm),
                       jijb.read_template_media_list(tm)),
                      (ijb.read_template_pair_list(pairs),
                       jijb.read_template_pair_list(pairs))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def projection(x):
    """A deterministic numpy extractor: 8 features of 64 strided values."""
    flat = x.reshape(len(x), -1)[:, ::977][:, :64].astype(np.float64)
    return flat @ np.random.RandomState(5).randn(flat.shape[1], 8)


@pytest.mark.parametrize("occlude", [False, True], ids=["plain", "occ"])
def test_extract_ijb_features_matches_jax(occlude):
    imgs = np.random.RandomState(3).randint(0, 256, (5, 112, 112, 3)
                                            ).astype(np.float32)
    kw = [dict(occ_block=block(40, 41), rng=np.random.RandomState(0))
          if occlude else {} for block in (RandomBlock, JaxBlock)]
    got = ijb.extract_ijb_features(imgs, projection, 2, **kw[0])
    want = jijb.extract_ijb_features(imgs, projection, 2, **kw[1])
    assert got.shape == (5, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prepare", [
    {}, {"use_flip_test": False}, {"use_norm_score": False},
    {"use_detector_score": False}])
def test_protocol_matches_jax(tmp_path, prepare):
    """prepare_image_feats, image2template_feature, verification_scores
    and run_ijb_protocol's table on the same features."""
    tm, pairs = write_meta(tmp_path)
    templates, medias = ijb.read_template_media_list(tm)
    p1, p2, label = ijb.read_template_pair_list(pairs)
    rs = np.random.RandomState(4)
    feats = rs.randn(len(templates), 16).astype(np.float32)
    faceness = rs.uniform(0.8, 1.0, len(templates)).astype(np.float32)
    np.testing.assert_array_equal(
        ijb.prepare_image_feats(feats, faceness, **prepare),
        jijb.prepare_image_feats(feats, faceness, **prepare))
    got_t, want_t = (m.image2template_feature(
        m.prepare_image_feats(feats, faceness, **prepare), templates, medias)
        for m in (ijb, jijb))
    np.testing.assert_array_equal(got_t[0], want_t[0])
    np.testing.assert_array_equal(got_t[1], want_t[1])
    np.testing.assert_array_equal(
        ijb.verification_scores(*got_t, p1, p2, batchsize=3),
        jijb.verification_scores(*want_t, p1, p2))
    got, want = (m.run_ijb_protocol(feats, faceness, templates, medias, p1,
                                    p2, label, **prepare)
                 for m in (ijb, jijb))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(4))
def test_tpr_at_fpr_table_matches_sklearn(seed):
    """The port's ROC against JAX's sklearn one, ties and all."""
    from sklearn.metrics import auc, roc_curve

    rs = np.random.RandomState(seed)
    n = 400
    label = (rs.rand(n) < 0.3).astype(int)
    score = np.round(rs.randn(n) + label, 1 if seed % 2 else 6)
    assert ijb.tpr_at_fpr_table(label, score) == jijb.tpr_at_fpr_table(
        label, score)
    fpr, tpr = ijb.roc_curve(label, score)
    want_fpr, want_tpr, _ = roc_curve(label, score)
    np.testing.assert_array_equal(fpr, want_fpr)
    np.testing.assert_array_equal(tpr, want_tpr)
    assert abs(ijb.roc_auc(fpr, tpr) - auc(want_fpr, want_tpr)) <= 1e-12


def test_save_roc_artifacts_matches_jax(tmp_path):
    rs = np.random.RandomState(6)
    label = (rs.rand(200) < 0.5).astype(int)
    score = rs.randn(200) + label
    got = ijb.save_roc_artifacts(str(tmp_path / "port"), "IJBB", label,
                                 score, method="m")
    want = jijb.save_roc_artifacts(str(tmp_path / "jax"), "IJBB", label,
                                   score, method="m")
    assert sorted(got) == sorted(want)
    assert os.path.basename(got["pdf"]) == "ijbb.pdf"
    assert os.path.getsize(got["pdf"]) > 0
    np.testing.assert_array_equal(np.load(got["npy"]), np.load(want["npy"]))
    with open(got["csv"]) as g, open(want["csv"]) as w:
        assert list(csv.reader(g)) == list(csv.reader(w))


def test_fixture_tool_writes_jax_files(tmp_path):
    argv = ["--ids", "2", "--per-template", "2", "--per-folder-id", "2",
            "--seed", "3"]
    fixtures.main(["--out", str(tmp_path / "port")] + argv)
    jax_fixtures.main(["--out", str(tmp_path / "jax")] + argv)
    files = {}
    for side in ("port", "jax"):
        root = tmp_path / side
        files[side] = {os.path.relpath(os.path.join(d, f), root):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(root) for f in fs}
    assert len(files["port"]) == 2 * 2 * 2 + 3 + 2 * 2 + 1
    assert files["port"] == files["jax"]


@pytest.fixture(scope="module")
def ijb_run(tmp_path_factory):
    """A tiny IJB root from the port's tool (3 ids, 2 templates of one
    image each) and a weight folder of arc18_msml at one block per stage
    (float32, seeded weights)."""
    from msml_torch.core.config import config_init, load_yaml
    from msml_torch.nn import iresnet
    from msml_torch.nn.msml import msml_from_config

    root = tmp_path_factory.mktemp("ijb")
    fixtures.main(["--out", str(root / "fx"), "--ids", "3",
                   "--per-template", "1", "--per-folder-id", "2"])
    folder = root / "arc18_msml_1"
    folder.mkdir()
    with open(os.path.join(REPO, "configs", "arc18_msml.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["fp16"] = False
    with open(folder / "config.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(iresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        cfg = config_init(load_yaml(str(folder / "config.yaml")),
                          make_output_dir=False)
        model = msml_from_config(cfg, device="cpu", seed=0)
        torch.save(model.state_dict(), folder / "backbone.pth")
        yield str(root / "fx" / "ijb"), str(folder)


@pytest.mark.parametrize("occ", [[], ["--lo", "40", "--hi", "41"]],
                         ids=["plain", "occ"])
def test_cli_eval_ijb_matches_jax_protocol(ijb_run, jax_numpy_umeyama,
                                           monkeypatch, tmp_path, occ):
    """`cli.eval_ijb --device cpu`: the crops it aligns equal JAX's
    `AlignedCrops`; each repeat's forward inputs (crops, occlusion draws,
    flips) and features equal JAX's `extract_ijb_features` with JAX's
    RandomBlock and the same draws, its forward replaying the port's
    outputs; the averaged scores (the npy) and the table equal JAX's
    protocol on those features; the csv and pdf are written."""
    from msml_torch.eval import ijb as port_ijb

    ijb_root, folder = ijb_run
    from msml_torch.nn import iresnet
    monkeypatch.setitem(iresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
    repeats = []
    jax_rng = np.random.RandomState(0)
    extract = port_ijb.extract_ijb_features

    def spy(imgs, extract_fn, batch_size, occ_block=None, rng=None):
        calls = []

        def recorded(x):
            calls.append((x.copy(), extract_fn(x)))
            return calls[-1][1]

        def replayed(x):  # the same inputs in the same order
            want_x, f = calls.pop(0)
            np.testing.assert_array_equal(x, want_x)
            return f

        got = extract(imgs, recorded, batch_size, occ_block, rng)
        jax_block = None if occ_block is None else JaxBlock(
            occ_block.lo, occ_block.hi)
        want = jijb.extract_ijb_features(
            jax_cli.AlignedCrops(imgs.root, imgs.names, imgs.lmks),
            replayed, batch_size, jax_block, jax_rng)
        assert not calls
        np.testing.assert_array_equal(got, want)
        repeats.append(got)
        return got

    monkeypatch.setattr(port_ijb, "extract_ijb_features", spy)
    art = tmp_path / "art"
    table = cli.main(cli.parse_args(
        ["--weight_folder", folder, "--ijb-root", ijb_root, "--device",
         "cpu", "--batch-size", "4", "--artifact-dir", str(art)] + occ))
    assert len(repeats) == (10 if occ else 1)
    meta = os.path.join(ijb_root, "meta")
    templates, medias = jijb.read_template_media_list(
        os.path.join(meta, "ijbc_face_tid_mid.txt"))
    p1, p2, label = jijb.read_template_pair_list(
        os.path.join(meta, "ijbc_template_pair_label.txt"))
    _, _, faceness = jax_cli.load_name_lmk_score(
        os.path.join(meta, "ijbc_name_5pts_score.txt"))
    score = sum(jijb.run_ijb_protocol(f, faceness, templates, medias, p1, p2,
                                      label, compute_table=False)[1]
                for f in repeats) / len(repeats)
    np.testing.assert_array_equal(np.load(art / "ijbc_scores.npy"), score)
    assert table == jijb.tpr_at_fpr_table(label, score)
    assert (art / "ijbc_tpr_fpr.csv").exists() and (art / "ijbc.pdf").exists()
    names, lmks, _ = cli.load_name_lmk_score(
        os.path.join(meta, "ijbc_name_5pts_score.txt"))
    crops = cli.AlignedCrops(os.path.join(ijb_root, "loose_crop"), names,
                             lmks)
    want = jax_cli.AlignedCrops(crops.root, names, lmks)
    assert len(crops) == 6
    np.testing.assert_array_equal(crops[1:4], want[1:4])
    np.testing.assert_array_equal(crops[5], want[5])


def test_cli_eval_ijb_refuses_a_gray_folder(tmp_path):
    folder = tmp_path / "light"
    folder.mkdir()
    with open(os.path.join(REPO, "configs", "lightcnn_msml.yaml")) as f:
        (folder / "config.yaml").write_text(f.read())
    with pytest.raises(SystemExit, match="evaluates RGB 112x112 crops; .* "
                                         "gray 128x128 input"):
        cli.main(cli.parse_args(["--weight_folder", str(folder),
                                 "--ijb-root", str(tmp_path), "--device",
                                 "cpu"]))
