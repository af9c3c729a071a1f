"""Verification-set `.bin` loader (lfw.bin / cfp_fp.bin / agedb_30.bin).

The port's own copy of `msml_tpu/data/bin_loader.py` (`load_bin`,
`load_bin_pil`) and `msml_tpu/data/recordio.py::imdecode`. Parity target
`eval/verification.py:201-236`: a pickled (bins, issame_list) pair where
bins are encoded JPEGs; each image is decoded to (H, W, 3) RGB and a
horizontally flipped copy is produced. `cv2` is imported only to decode
JPEG or PNG; binary PPM images (`P6`, as `ppm_encode` writes them) decode
without it, for machines that have no OpenCV.
"""

from __future__ import annotations

import pickle
from typing import List, Tuple

import numpy as np


def ppm_encode(img_rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> a binary PPM (`P6`, maxval 255)."""
    h, w = img_rgb.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        img_rgb, np.uint8).tobytes()


def ppm_decode(buf: bytes) -> np.ndarray:
    """A binary PPM with maxval 255 -> (H, W, 3) uint8 RGB."""
    fields, pos = [], 2
    while len(fields) < 3:
        while buf[pos:pos + 1].isspace() or buf[pos:pos + 1] == b"#":
            if buf[pos:pos + 1] == b"#":
                pos = buf.index(b"\n", pos)
            pos += 1
        end = pos
        while buf[end:end + 1].isdigit():
            end += 1
        fields.append(int(buf[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"PPM maxval {maxval}: only 255 is read")
    data = np.frombuffer(buf, np.uint8, 3 * w * h, pos + 1)
    return data.reshape(h, w, 3)


def imdecode(buf: bytes, to_rgb: bool = True) -> np.ndarray:
    """mx.image.imdecode parity via cv2 (same OpenCV jpeg path); a binary
    PPM is decoded here, to the same array."""
    if buf[:2] == b"P6":
        img = ppm_decode(buf)
        return img if to_rgb else img[:, :, ::-1]
    import cv2

    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("image decode failed")
    return img[:, :, ::-1] if to_rgb else img


def _pairs(path: str) -> Tuple[List[bytes], List[bool]]:
    """The .bin's encoded images (2 per pair) and its issame list."""
    with open(path, "rb") as f:
        try:
            bins, issame_list = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            bins, issame_list = pickle.load(f, encoding="bytes")
    bufs = [b if isinstance(b, (bytes, bytearray)) else bytes(b)
            for b in bins[:len(issame_list) * 2]]
    return bufs, list(issame_list)


def load_bin(path: str, image_size=(112, 112)
             ) -> Tuple[List[np.ndarray], List[bool]]:
    """-> ([orig (N,H,W,3) f32 0..255, flipped ...], issame)."""
    bufs, issame = _pairs(path)
    data = np.empty((len(bufs), image_size[0], image_size[1], 3), np.float32)
    for i, buf in enumerate(bufs):
        img = imdecode(buf)
        if img.shape[0] != image_size[0]:
            img = _resize_short(img, image_size[0])
        data[i] = img
    flipped = data[:, :, ::-1, :].copy()
    return [data, flipped], issame


def load_bin_pil(path: str) -> Tuple[list, List[bool]]:
    """-> (RGB PIL images, issame): the variant of the host occlusion
    sweep, which composes PIL transforms (`datasets/load_dataset.py:
    431-467`). Pillow is imported here."""
    from PIL import Image

    bufs, issame = _pairs(path)
    # (H, W, 3) uint8 arrays: RGB images
    return [Image.fromarray(imdecode(buf)) for buf in bufs], issame


def _resize_short(img: np.ndarray, size: int) -> np.ndarray:
    """mx.image.resize_short parity (bilinear, short side -> size)."""
    import cv2

    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = size, int(w * size / h)
    else:
        new_h, new_w = int(h * size / w), size
    return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
