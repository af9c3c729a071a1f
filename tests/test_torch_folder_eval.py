"""The port's folder-eval protocol and input transform
(`msml_torch/eval/folder_eval.py`) against the JAX package's
(`msml_tpu/eval/folder_eval.py`) on the CPU.

The port takes (H, W, 3) uint8 arrays where the JAX package takes PIL
images; both resize with Pillow's bilinear filter only when the size
differs, so the transform must be bit-equal. The protocol's metrics use
the port's own ROC curve and the JAX package's sklearn one, on the same
features: equal to 1e-12.
"""

import io

import numpy as np
import pytest
from PIL import Image

from msml_tpu.eval import folder_eval as jfe
from msml_tpu.eval.occ_sweep import center_crop as jax_center_crop
from msml_torch.data.bin_loader import ppm_encode
from msml_torch.eval import folder_eval as tfe

OUT_SIZE = (16, 12)  # (w, h), as the configs give out_size


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("mode", ["norm", "raw", "gray"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("hw", [(12, 16), (19, 23)], ids=["equal", "resized"])
def test_tensorize_folder_img_bit_equal(hw, flip, mode):
    img = _image(*hw)
    kw = dict(use_norm=mode == "norm", is_gray=mode == "gray", flip=flip)
    want = jfe.tensorize_folder_img(Image.fromarray(img), OUT_SIZE, **kw)
    got = tfe.tensorize_folder_img(img, OUT_SIZE, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (12, 16, 1 if mode == "gray" else 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(12, 16), (20, 25), (9, 13)],
                         ids=["same", "larger", "smaller"])
def test_center_crop_equals_pil_crop(hw):
    """The array crop against the JAX package's PIL crop, zeros where the
    box leaves a smaller image."""
    img = _image(*hw, seed=1)
    want = np.asarray(jax_center_crop(Image.fromarray(img), OUT_SIZE))
    np.testing.assert_array_equal(tfe.center_crop(img, OUT_SIZE), want)


@pytest.mark.parametrize("fmt", ["PPM", "PNG", "BMP"])
def test_decode_image_equals_pil(fmt):
    """Binary PPM by the port's reader, other formats by Pillow: the array
    Pillow gives the JAX package."""
    img = _image(7, 9, seed=2)
    if fmt == "PPM":
        data = ppm_encode(img)
    else:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(tfe.decode_image(data), want)


def write_pairs_folder(root):
    """3 identities x 3 images (PNG, one of them of another size), and
    pairs.txt with 4 same and 4 different lines."""
    rs = np.random.RandomState(3)
    for ident in ("alice", "bob", "carol"):
        (root / ident).mkdir(parents=True)
        base = rs.randint(0, 256, (16, 16, 3))
        for i in range(3):
            shape = (18, 20, 3) if (ident, i) == ("bob", 1) else (16, 16, 3)
            img = np.clip(base + rs.randint(-20, 21, (16, 16, 3)), 0, 255)
            img = np.resize(img, shape).astype(np.uint8)
            Image.fromarray(img).save(root / ident / f"{i:02d}.png")
    (root / "notes.txt").write_text("not an identity")
    lines = ["alice 1 2", "bob 1 3", "carol 2 3", "alice 3 1",
             "alice 1 bob 2", "bob 3 carol 1", "carol 1 alice 2",
             "bob 2 carol 3"]
    pairs = root / "pairs.txt"
    pairs.write_text("\n".join(lines) + "\n\n")
    return str(root), str(pairs)


def test_load_folder_pairs_equals_jax(tmp_path):
    folder, pairs = write_pairs_folder(tmp_path / "set")
    jimgs, jlabels = jfe.load_folder_pairs(folder, pairs)
    timgs, tlabels = tfe.load_folder_pairs(folder, pairs)
    np.testing.assert_array_equal(tlabels, jlabels)
    assert list(tlabels) == [0, 0, 0, 0, 1, 1, 1, 1]
    assert len(timgs) == len(jimgs) == 16
    for t, j in zip(timgs, jimgs):
        np.testing.assert_array_equal(t, np.asarray(j))


def test_evaluate_folder_equals_jax(tmp_path):
    """The whole protocol with one numpy extractor (a fixed random
    projection of the pixels to 16 features): accuracy and TAR@FAR."""
    folder, pairs = write_pairs_folder(tmp_path / "set")
    proj = np.random.RandomState(4).randn(12 * 16 * 3, 16)

    def extract(x):
        return x.reshape(x.shape[0], -1) @ proj

    kw = dict(out_size=OUT_SIZE, batch_size=3, dim_feature=16)
    jacc, jtar = jfe.evaluate_folder(folder, pairs, extract, **kw)
    tacc, ttar = tfe.evaluate_folder(folder, pairs, extract, **kw)
    assert np.isfinite(tacc) and len(ttar) == 3
    np.testing.assert_allclose(tacc, jacc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ttar, jtar, rtol=0, atol=1e-12)
