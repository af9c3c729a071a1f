"""Generate procedural RGBA occluder assets (glasses / scarves / objects).

The port's own copy of `msml_tpu/tools/make_occluders.py`, writing the same
PNGs from the same seed. The reference ships curated occluder PNG packs
(`datasets/augment/occluder/{glasses_crop,eleglasses_crop,scarf_crop,
object_train,object_test}`) consumed by RandomGlasses/RandomScarf/
RandomRealObject. When those packs are unavailable, this tool synthesizes
simple stand-ins with the same interface (RGBA with a meaningful alpha
channel) so training/eval pipelines run end to end. Swap in the real packs
for paper-parity augmentation statistics.

Usage: python -m msml_torch.tools.make_occluders [--out DIR] [--num 8]
(default DIR: msml_torch/data/occluder_assets, where the training dataset
looks unless the config's `occluder_root` or MSML_OCCLUDER_DIR says
otherwise). Pillow is imported only inside the drawing functions.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _glasses(rng, w=80, h=40):
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    color = tuple(int(c) for c in rng.randint(10, 120, 3)) + (255,)
    lw = rng.randint(2, 5)
    r = rng.randint(10, 16)
    cy = h // 2
    cx1, cx2 = w // 4, 3 * w // 4
    for cx in (cx1, cx2):
        d.ellipse([cx - r, cy - r, cx + r, cy + r], outline=color, width=lw)
        if rng.rand() < 0.5:  # tinted lenses
            fill = color[:3] + (rng.randint(60, 200),)
            d.ellipse([cx - r + lw, cy - r + lw, cx + r - lw, cy + r - lw],
                      fill=fill)
    d.line([cx1 + r, cy, cx2 - r, cy], fill=color, width=lw)  # bridge
    d.line([0, cy - 2, cx1 - r, cy], fill=color, width=lw)    # temples
    d.line([cx2 + r, cy, w, cy - 2], fill=color, width=lw)
    return img


def _scarf(rng, w=90, h=90):
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    color = tuple(int(c) for c in rng.randint(30, 220, 3)) + (255,)
    # triangular bandana covering the lower face
    top = rng.randint(0, h // 4)
    d.polygon([(0, top), (w, top), (w, h // 2), (w // 2, h), (0, h // 2)],
              fill=color)
    # fabric texture stripes
    stripe = tuple(int(c) for c in rng.randint(30, 220, 3)) + (255,)
    for y in range(top + 4, h, 8):
        d.line([(0, y), (w, y - rng.randint(0, 6))], fill=stripe, width=2)
    return img


def _object(rng, w=55, h=55):
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    d = ImageDraw.Draw(img)
    color = tuple(int(c) for c in rng.randint(0, 255, 3)) + (255,)
    kind = rng.randint(0, 3)
    if kind == 0:  # mug / cup
        d.rounded_rectangle([w // 4, h // 5, 3 * w // 4, 4 * h // 5],
                            radius=6, fill=color)
        d.arc([3 * w // 4 - 6, h // 3, w - 2, 2 * h // 3], -90, 90,
              fill=color, width=3)
    elif kind == 1:  # hand-ish blob
        for _ in range(5):
            x, y = rng.randint(w // 5, 4 * w // 5, 2)
            r = rng.randint(6, 14)
            d.ellipse([x - r, y - r, x + r, y + r], fill=color)
    else:  # phone
        d.rounded_rectangle([w // 3, h // 6, 2 * w // 3, 5 * h // 6],
                            radius=4, fill=color)
    return img


def main(out_dir: str, num: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    packs = {
        "glasses_crop": _glasses,
        "eleglasses_crop": _glasses,
        "scarf_crop": _scarf,
        "object_train": _object,
        "object_test": _object,
    }
    for name, fn in packs.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for i in range(num):
            fn(rng).save(os.path.join(d, f"{name}_{i:03d}.png"))
    print(f"wrote {num} synthetic occluders per pack under {out_dir}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str,
                   default=os.path.join(os.path.dirname(__file__), "..",
                                        "data", "occluder_assets"))
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    main(os.path.abspath(a.out), a.num, a.seed)
