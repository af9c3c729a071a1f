"""Online random-occlusion transforms.

The port's own copy of `msml_tpu/data/rand_occ.py`. Parity target:
`datasets/augment/rand_occ.py:25-602` — the 8 transform families, each
`(PIL) -> (occluded PIL, mask PIL)` with mask 'L' where 255 = clean, 0 =
occluded:

  * RandomBlock (eval-only; returns only the image) — rand_occ.py:25-72
  * NoneOcc — 78-87
  * RandomRect — 96-139
  * RandomEllipse — 150-204
  * RandomConnectedPolygon (star polygons via cv2.fillPoly) — 217-325
  * RandomGlasses / RandomGlassesList (RGBA paste at the eye line) — 337-419
  * RandomScarf — 422-508
  * RandomRealObject — 511-602

Differences from the reference (documented):
  * every transform takes an optional numpy Generator (`rng`) so the input
    pipeline is deterministically seedable per-sample (SURVEY.md §7 PRNG
    plan); np.random module-state is the default to match reference behavior.
  * occluder *assets* (glasses/scarf/object PNGs) are user-supplied paths;
    `msml_torch/tools/make_occluders.py` synthesizes procedural stand-ins
    when the original asset packs are unavailable.

Sampling distributions (ranges, probabilities, offsets) match the reference
line-for-line; the masks keep its quirks (e.g. glasses paste uses alpha <= 10
as transparent while the mask uses alpha != 0, rand_occ.py:385-414).
Pillow is imported with the module; cv2 only inside the transforms that
draw with it.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np
from PIL import Image


def _rng(rng: Optional[np.random.RandomState]):
    return rng if rng is not None else np.random


def _white_mask(height: int, width: int) -> np.ndarray:
    return np.ones((height, width), dtype=np.uint8) * 255


class RandomBlock:
    """Square block occlusion with area ratio in [lo, hi)% — the eval
    occlusion-sweep operator (rand_occ.py:25-72). Returns only the image."""

    fill_list = ("black", "white", "gauss")

    def __init__(self, lo: int, hi: int, fill: str = "black"):
        assert fill in self.fill_list
        self.lo, self.hi, self.fill = lo, hi, fill

    def __call__(self, img: Image.Image, rng=None) -> Image.Image:
        r = _rng(rng)
        ratio = r.randint(self.lo, self.hi) * 0.01
        if ratio == 0:
            return img.copy()
        width, height = img.size
        bw = int((ratio * width * width) ** 0.5)
        if self.fill == "black":
            occ = Image.fromarray(np.zeros((bw, bw), dtype=np.uint8))
        elif self.fill == "white":
            occ = Image.fromarray(np.full((bw, bw), 255, dtype=np.uint8))
        else:  # gauss
            if img.mode == "L":
                # Faithful reference quirk (rand_occ.py:57-58): the gray
                # branch skips the uint8 cast, so the block is an 'F'-mode
                # float image and paste() CLIPS to [0,255] — unlike the RGB
                # branch's uint8 wraparound.
                occ = Image.fromarray(r.randn(bw, bw) * 255)
            else:
                occ = Image.fromarray(
                    (np.stack([r.randn(bw, bw) for _ in range(3)], axis=2)
                     * 255).astype(np.uint8))
        img_occ = img.copy()
        randx = r.randint(0, width - bw + 1)
        randy = r.randint(0, width - bw + 1)
        img_occ.paste(occ, (randx, randy))
        return img_occ


class NoneOcc:
    """rand_occ.py:78-87."""

    def __call__(self, img: Image.Image, rng=None):
        width, height = img.size
        return img, Image.fromarray(_white_mask(height, width))


class RandomRect:
    """rand_occ.py:96-139."""

    def __init__(self, lo: int = 0, hi: int = 36):
        self.lo, self.hi = lo, hi

    def __call__(self, img: Image.Image, rng=None):
        r = _rng(rng)
        width, height = img.size
        ratio = r.randint(self.lo, self.hi) * 0.01
        occ_size = int(width * height * ratio)
        occ_w = r.randint(int(width * ratio) + 1, width + 1)
        occ_h = int(occ_size / occ_w)
        x = r.randint(0, width - occ_w + 1)
        y = r.randint(0, height - occ_h + 1)

        arr = np.array(img, dtype=np.uint8)
        if img.mode == "L":
            arr[y:y + occ_h, x:x + occ_w] = r.randint(0, 256)
        else:
            for c in range(3):
                arr[y:y + occ_h, x:x + occ_w, c] = r.randint(0, 256)
        msk = _white_mask(height, width)
        msk[y:y + occ_h, x:x + occ_w] = 0
        return Image.fromarray(arr), Image.fromarray(msk)


class RandomEllipse:
    """rand_occ.py:150-204."""

    def __init__(self, lo_ratio: float = 0.2, hi_ratio: float = 0.4,
                 use_rand_color: bool = True):
        self.lo_ratio, self.hi_ratio = lo_ratio, hi_ratio
        self.use_rand_color = use_rand_color

    def __call__(self, img: Image.Image, rng=None):
        import cv2
        r = _rng(rng)
        arr = np.array(img)
        width, height = img.size
        channel = 1 if arr.ndim == 2 else 3

        ellipse = np.zeros((height, width), dtype=np.uint8)
        ch = r.randint(height // 5, 4 * height // 5)
        cw = r.randint(width // 5, 4 * width // 5)
        ah = r.randint(20, min(ch, height - ch)) if min(ch, height - ch) > 20 \
            else 20
        ratio = r.uniform(self.lo_ratio, self.hi_ratio)
        aw = int(height * width * ratio / (3.14 * ah))
        gray = r.randint(1, 256) if self.use_rand_color else 255
        cv2.ellipse(ellipse, (cw, ch), (aw, ah), 0, 0, 360, int(gray), -1)

        color = np.array((0, 0, 0), dtype=np.uint8)
        for c in range(channel):
            color[c] = r.randint(1, 256) if self.use_rand_color else 255
        arr[ellipse != 0] = color if channel == 3 else color[0]
        msk = _white_mask(height, width)
        msk[ellipse != 0] = 0
        return Image.fromarray(arr), Image.fromarray(msk)


class RandomConnectedPolygon:
    """Star polygon between two concentric circles (rand_occ.py:217-325)."""

    def __init__(self, use_rand_color: bool = True, lo_points_num: int = 4,
                 hi_points_num: int = 11, use_circle: bool = True,
                 is_training: bool = True):
        self.use_rand_color = use_rand_color
        self.lo_points_num, self.hi_points_num = lo_points_num, hi_points_num
        self.use_circle = use_circle
        self.is_training = is_training

    def __call__(self, img: Image.Image, rng=None):
        import cv2
        r = _rng(rng)
        arr = np.array(img)
        width, height = img.size
        channel = 1 if arr.ndim == 2 else 3

        polygon = np.zeros((height, width), dtype=np.uint8)
        point_cnt = r.randint(self.lo_points_num, self.hi_points_num)
        points = np.zeros((2 * point_cnt + 2, 2), dtype=np.int32)
        cx = r.randint(height // 5, 4 * height // 5)
        cy = r.randint(width // 5, 4 * width // 5)
        big_r = r.randint(height // 5, int(1.3 * height // 5))
        small_r = big_r / r.uniform(1.3, 2.6)

        def next_point(radius, angle):
            if self.use_circle:
                return np.array((int(cx + radius * math.cos(angle)),
                                 int(cy + radius * math.sin(angle))))
            ra = radius * r.uniform(0.5, 1.5)
            rb = radius * r.uniform(0.5, 1.5)
            return np.array((int(cx + ra * math.cos(angle)),
                             int(cy + rb * math.sin(angle))))

        big_angle = small_angle = 0.0
        points[0] = next_point(big_r, big_angle)
        small_i = 0
        big_i = 0
        for big_i in range(point_cnt):
            big_angle += 2 * math.pi / point_cnt * r.uniform(0.7, 1.3)
            points[big_i + small_i + 1] = next_point(big_r, big_angle)
            if r.random() > 0.5:
                small_i += 1
                small_angle += 2 * math.pi / point_cnt * r.uniform(0.6, 1.4)
                points[big_i + small_i + 1] = next_point(small_r, small_angle)
        points = points[:1 + big_i + small_i + 1]
        gray = r.randint(1, 256) if self.use_rand_color else 255
        cv2.fillPoly(polygon, np.array([points]), int(gray))

        color = np.array((0, 0, 0), dtype=np.uint8)
        for c in range(channel):
            color[c] = r.randint(1, 256) if self.use_rand_color else 255
        arr[polygon != 0] = color if channel == 3 else color[0]
        msk = _white_mask(height, width)
        msk[polygon != 0] = 0
        out = Image.fromarray(arr)
        if self.is_training:
            return out, Image.fromarray(msk)
        return out


class _PastedOccluder:
    """Shared RGBA-asset loader for glasses/scarf/object transforms."""

    def __init__(self, path: str, occ_height: int, occ_width: int,
                 center_crop: bool = False):
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"occluder asset dir {path!r} not found; generate procedural "
                f"assets with msml_torch/tools/make_occluders.py or point "
                f"to your own RGBA pngs (reference assets: "
                f"datasets/augment/occluder/)")
        names = sorted(os.listdir(path))
        if not names:
            raise FileNotFoundError(f"no occluder images in {path!r}")
        self.num = len(names)
        self.imgs = np.zeros((self.num, occ_height, occ_width, 4), np.uint8)
        for i, name in enumerate(names):
            obj = Image.open(os.path.join(path, name)).convert("RGBA")
            if center_crop:
                fw, fh = obj.size
                ratio = max(fw / occ_width, fh / occ_height)
                obj = obj.resize((int(fw / ratio), int(fh / ratio)))
                # torchvision CenterCrop((w, h)) semantics of the reference
                # (rand_occ.py:550-552): crop/pad to (occ_width, occ_height).
                # NOTE the reference swaps w/h here (CenterCrop takes (h, w))
                # and would crash for non-square occ sizes exactly like this
                # code does; only the square 55x55 default is ever used.
                canvas = Image.new("RGBA", (occ_height, occ_width))
                left = (occ_height - obj.size[0]) // 2
                top = (occ_width - obj.size[1]) // 2
                canvas.paste(obj, (left, top))
                obj = canvas
            else:
                obj = obj.resize((occ_width, occ_height))
            self.imgs[i] = np.array(obj, dtype=np.uint8)

    def pick(self, r) -> Image.Image:
        return Image.fromarray(self.imgs[r.randint(0, self.num)], mode="RGBA")


class RandomGlasses:
    """rand_occ.py:337-414."""

    def __init__(self, glasses_path: str, occ_height: int = 40,
                 occ_width: int = 80, height_scale: float = 1.1,
                 width_scale: float = 1.1):
        self.assets = _PastedOccluder(glasses_path, occ_height, occ_width)
        self.occ_height, self.occ_width = occ_height, occ_width
        self.height_scale, self.width_scale = height_scale, width_scale

    def __call__(self, img: Image.Image, rng=None):
        r = _rng(rng)
        mode = img.mode
        width, height = img.size
        occ_h = height * (self.occ_height / 120)
        occ_w = width * (self.occ_width / 120)

        glasses = self.assets.pick(r)
        occ_w = int(occ_w * r.uniform(1 / self.width_scale, self.width_scale))
        occ_h = int(occ_h * r.uniform(1 / self.height_scale,
                                      self.height_scale))
        glasses = glasses.resize((occ_w, occ_h))
        alpha = np.array(glasses)[:, :, -1].astype(np.uint8)
        glasses = glasses.convert(mode)

        x = int((0.12 + r.randint(-5, 6) * 0.02) * width)
        y = int((0.3 + r.randint(-5, 6) * 0.01) * height)

        face = np.array(img)
        garr = np.array(glasses)
        crop = face[y:y + occ_h, x:x + occ_w]
        garr = garr[:crop.shape[0], :crop.shape[1]]
        alpha = alpha[:crop.shape[0], :crop.shape[1]]
        garr[alpha <= 10] = crop[alpha <= 10]
        face[y:y + occ_h, x:x + occ_w] = garr

        msk_shape = (height, width) if mode == "L" else (height, width, 3)
        msk = np.ones(msk_shape, dtype=np.uint8) * 255
        garr[alpha != 0] = 0
        garr[alpha == 0] = 255
        msk[y:y + occ_h, x:x + occ_w] = garr
        return (Image.fromarray(face),
                Image.fromarray(msk).convert("L"))


class RandomGlassesList:
    """rand_occ.py:404-419: uniform choice over glasses asset packs."""

    def __init__(self, glasses_path_list: List[str]):
        self.trans = [RandomGlasses(p) for p in glasses_path_list]

    def __call__(self, img: Image.Image, rng=None):
        r = _rng(rng)
        return self.trans[r.randint(0, len(self.trans))](img, rng)


class _PasteAtOffset:
    """Shared scarf/object paste logic (rand_occ.py:470-508,560-602)."""

    def _paste(self, img, occ, alpha, x, y, thresh):
        mode = img.mode
        width, height = img.size
        face = np.array(img)
        occ = occ[: min(occ.shape[0], height - y),
                  : min(occ.shape[1], width - x)]
        alpha = alpha[: occ.shape[0], : occ.shape[1]]
        crop = face[y:y + occ.shape[0], x:x + occ.shape[1]]
        sel = alpha >= thresh if thresh > 0 else alpha != 0
        crop[sel] = occ[sel]
        face[y:y + occ.shape[0], x:x + occ.shape[1]] = crop

        msk_shape = (height, width) if mode == "L" else (height, width, 3)
        msk = np.ones(msk_shape, dtype=np.uint8) * 255
        occ2 = occ.copy()
        occ2[alpha != 0] = 0
        occ2[alpha == 0] = 255
        msk[y:y + occ.shape[0], x:x + occ.shape[1]] = occ2
        return Image.fromarray(face), Image.fromarray(msk).convert("L")


class RandomScarf(_PasteAtOffset):
    """rand_occ.py:422-508."""

    def __init__(self, scarf_path: str, occ_height: int = 90,
                 occ_width: int = 90, height_scale: float = 1.1,
                 width_scale: float = 1.1):
        self.assets = _PastedOccluder(scarf_path, occ_height, occ_width)
        self.occ_height, self.occ_width = occ_height, occ_width
        self.height_scale, self.width_scale = height_scale, width_scale

    def __call__(self, img: Image.Image, rng=None):
        r = _rng(rng)
        scarf = self.assets.pick(r)
        occ_w = int(self.occ_width * r.uniform(1 / self.width_scale, 1.0))
        occ_h = int(self.occ_height * r.uniform(1 / self.height_scale, 1.0))
        scarf = scarf.resize((occ_w, occ_h))
        alpha = np.array(scarf)[:, :, -1].astype(np.uint8)
        scarf = scarf.convert(img.mode)
        x = int((0.1 + r.randint(-5, 5) * 0.01) * img.size[0])
        y = int((0.6 + r.randint(-5, 5) * 0.01) * img.size[0])
        return self._paste(img, np.array(scarf), alpha, x, y, thresh=0)


class RandomRealObject(_PasteAtOffset):
    """rand_occ.py:511-602."""

    def __init__(self, object_path: str, occ_height: int = 55,
                 occ_width: int = 55, height_scale: float = 2.0,
                 width_scale: float = 2.0):
        self.assets = _PastedOccluder(object_path, occ_height, occ_width,
                                      center_crop=True)
        self.occ_height, self.occ_width = occ_height, occ_width
        self.height_scale, self.width_scale = height_scale, width_scale

    def __call__(self, img: Image.Image, rng=None):
        r = _rng(rng)
        obj = self.assets.pick(r)
        occ_w = int(self.occ_width * r.uniform(1.0, self.width_scale))
        occ_h = int(self.occ_height * r.uniform(1.0, self.height_scale))
        obj = obj.resize((occ_w, occ_h))
        alpha = np.array(obj)[:, :, -1].astype(np.uint8)
        obj = obj.convert(img.mode)
        x = int((r.randint(15, 51) * 0.01) * img.size[0])
        y = int((r.randint(15, 51) * 0.01) * img.size[1])
        return self._paste(img, np.array(obj), alpha, x, y, thresh=1)
