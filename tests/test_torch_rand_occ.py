"""The port's online occlusion transforms (`msml_torch/data/rand_occ.py`)
against the JAX package's (`msml_tpu/data/rand_occ.py`) on the CPU.

Each of the eight transforms runs on the same 112 x 112 PIL image (RGB and
L, a smooth random face stand-in) with a `RandomState(seed)` per package,
seeds 0, 1 and 2; the occluded image and the mask must be byte-equal, and
the draws must leave both generators in the same state. The pasted
transforms read procedural occluder PNGs written by the JAX package's
`make_occluders` (seed 0, 2 per pack).
"""

import os

import numpy as np
import pytest
from PIL import Image

from msml_tpu.data import rand_occ as jocc
from msml_tpu.tools.make_occluders import main as make_occluders
from msml_torch.data import rand_occ as tocc

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def occluders(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("occluders"))
    make_occluders(root, num=2, seed=0)
    return root


def _face(mode: str, seed: int = 7) -> Image.Image:
    small = (np.random.RandomState(seed).rand(8, 8, 3) * 255).astype(
        np.uint8)
    return Image.fromarray(small).resize((112, 112)).convert(mode)


def _factories(root):
    """name -> (module -> transform)."""
    glasses = [os.path.join(root, s) for s in ("glasses_crop",
                                               "eleglasses_crop")]
    return {
        "NoneOcc": lambda m: m.NoneOcc(),
        "RandomRect": lambda m: m.RandomRect(),
        "RandomEllipse": lambda m: m.RandomEllipse(),
        "RandomConnectedPolygon": lambda m: m.RandomConnectedPolygon(),
        "RandomGlasses": lambda m: m.RandomGlasses(glasses[0]),
        "RandomGlassesList": lambda m: m.RandomGlassesList(glasses),
        "RandomScarf": lambda m: m.RandomScarf(
            os.path.join(root, "scarf_crop")),
        "RandomRealObject": lambda m: m.RandomRealObject(
            os.path.join(root, "object_train")),
    }


def _outcome(transform, img, seed):
    """(image bytes, mode, size, mask bytes or None, generator state)."""
    r = np.random.RandomState(seed)
    out = transform(img, r)
    img_out, msk = out if isinstance(out, tuple) else (out, None)
    state = r.get_state()
    return (img_out.tobytes(), img_out.mode, img_out.size,
            None if msk is None else (msk.tobytes(), msk.mode),
            state[1].tobytes(), state[2])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("name", ["NoneOcc", "RandomRect", "RandomEllipse",
                                  "RandomConnectedPolygon", "RandomGlasses",
                                  "RandomGlassesList", "RandomScarf",
                                  "RandomRealObject"])
def test_transform_bytes_equal(occluders, name, mode, seed):
    build = _factories(occluders)[name]
    img = _face(mode)
    want = _outcome(build(jocc), img, seed)
    got = _outcome(build(tocc), img, seed)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("fill", ["black", "white", "gauss"])
def test_random_block_bytes_equal(fill, mode, seed):
    """The eval operator, at every fill; the gray gauss block keeps the
    reference's clipping paste (an 'F'-mode block)."""
    img = _face(mode)
    want = _outcome(jocc.RandomBlock(10, 51, fill), img, seed)
    got = _outcome(tocc.RandomBlock(10, 51, fill), img, seed)
    assert got[3] is None and got == want
    assert got[0] != img.tobytes()


def test_missing_assets_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="make_occluders"):
        tocc.RandomScarf(str(tmp_path / "absent"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no occluder images"):
        tocc.RandomScarf(str(tmp_path / "empty"))
