"""Drive the PyTorch port (msml_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases:
  1. device: the card's name and power limit, torch / CUDA / Triton versions
     (the card must be an H100 80GB HBM3: the memory bound assumes it);
  2. kernel: the Triton `augment_batch` kernel against its plain PyTorch
     version at B = 512, 112 x 112, over every option it takes
     (max abs diff <= 1e-5), the exact block area, and its time;
  3. model: arc18_msml (configs/arc18_msml.yaml, random weights from the
     seed) in bf16 at B = 512 against the same model in float32 (TF32 off)
     and against the float32 model on the CPU; bf16 img/s;
  4. sweep: the main path, `occlusion_sweep_device` with the model as
     extract_fn over 1200 synthetic pairs, every occlusion ratio, 2 repeats;
     the kernel's launch count is read from this phase alone;
  5. a summary line, the JSON line of the kernels the run launched (with
     their times, bounds and launch counts), then the final JSON line.

Exits non-zero, without the final line, when CUDA is missing or any check
fails. Needs no network, PyYAML, OpenCV or Pillow.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# identical to configs/arc18_msml.yaml (a CPU test pins the equality)
ARC18_MSML = {
    "dataset": "webface",
    "fp16": True,
    "batch_size": 128,
    "frb_type": "iresnet18",
    "osb_type": "unet",
    "use_osb": True,
    "fm_layers": [1, 1, 1, 1],
    "fm_params": [3, 2, "sigmoid", "mul"],
    "peer_params": {"use_ori": False, "use_conv": False,
                    "mask_trans": "conv", "use_decoder": False},
    "header_type": "AMArcFace",
    "header_params": [64.0, 0.48, 0.0, 0.0],
    "remat": False,
    "device_light": True,
    "exp_id": 1,
    "output_prefix": "arc18_msml",
}

B, H, W = 512, 112, 112
KERNEL_TOL = 1e-5       # kernel vs plain version, max abs diff
BF16_MIN_COS = 0.99     # bf16 vs f32 feature cosine
CPU_MIN_COS = 0.9999    # card f32 (TF32 off) vs CPU f32 feature cosine
MAIN_PATH = dict(lo=40, hi=41, fill="black", relight=False, use_norm=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


CARD = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = 3.35e12  # the card's published memory rate


def time_ms(fn, windows: int = 5, per_window: int = 20) -> float:
    """Median over `windows` of the mean time of `per_window` back-to-back
    calls, by CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    return statistics.median(times)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    import triton
    print(smi)
    if smi.split(",")[0].strip() != CARD:
        fail(f"the memory bound is computed for the {CARD}, not for {smi}")
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton.__version__} python {sys.version.split()[0]}")
    return smi


def phase_kernel(seed: int) -> dict:
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err = 0.0
    for c in (3, 1):
        img = torch.rand((B, H, W, c), generator=gen, device="cuda")
        noise = torch.randn(img.shape, generator=gen, device="cuda")
        draws = torch.rand((B, 6), generator=gen, device="cuda")
        for fill, relight, use_norm, (lo, hi) in itertools.product(
                ("black", "white", "gauss"), (True, False), (True, False),
                ((0, 1), (40, 41), (20, 51))):
            kw = dict(lo=lo, hi=hi, fill=fill, relight=relight,
                      use_norm=use_norm)
            out = augment_batch(img, draws, noise, **kw)
            ref = augment_batch_reference(img, draws, noise, **kw)
            err = (out - ref).abs().max().item()
            if not err <= KERNEL_TOL:
                fail(f"kernel vs plain max abs diff {err} at C={c} {kw}")
            max_err = max(max_err, err)
        torch.cuda.synchronize()
    print(f"[2 kernel] 72 option sets, C in (3, 1): max abs diff {max_err} "
          f"(tolerance {KERNEL_TOL})")

    draws = torch.rand((B, 6), generator=gen, device="cuda")
    flat = torch.full((B, H, W, 3), 0.5, device="cuda")
    want = math.floor(math.sqrt(0.40) * W) ** 2
    for relight in (False, True):
        out = augment_batch(flat, draws, lo=40, hi=41, fill="black",
                            relight=relight, use_norm=False)
        area = (out == 0).all(dim=1).sum(dim=(1, 2))
        if not bool((area == want).all()):
            fail(f"block area {area.unique().tolist()} != {want} "
                 f"(relight={relight})")
    print(f"[2 kernel] block area at ratio 0.40: {want} px in all {B} "
          "images")

    img = torch.rand((B, H, W, 3), generator=gen, device="cuda")
    noise = torch.randn(img.shape, generator=gen, device="cuda")
    timed = {}
    for name, kw in (("main path", MAIN_PATH),
                     ("relight", dict(MAIN_PATH, relight=True)),
                     ("gauss", dict(MAIN_PATH, fill="gauss"))):
        moved = 2 * img.numel() * 4 + draws.numel() * 4 \
            + (noise.numel() * 4 if kw["fill"] == "gauss" else 0)
        ms = time_ms(lambda: augment_batch(img, draws, noise, **kw))
        plain_ms = time_ms(
            lambda: augment_batch_reference(img, draws, noise, **kw))
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        timed[name] = (ms, plain_ms, bound_ms)
        print(f"[2 kernel] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
              f"{moved / 1e6:.1f} MB moved, bound {bound_ms:.4f} ms = "
              f"{bound_ms / ms:.1%} of the memory rate")
    ms, plain_ms, bound_ms = timed["main path"]
    return {"name": "augment_batch", "route": "triton",
            "source": "msml_torch/kernels/augment.py",
            "replaces": "msml_tpu/kernels/augment.py:131",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def build_model(seed: int, policy=None, device="cuda"):
    from msml_torch.core.config import Config, config_init
    from msml_torch.nn.msml import msml_from_config

    cfg = Config.from_dict(ARC18_MSML)
    config_init(cfg, make_output_dir=False)
    return msml_from_config(cfg, policy=policy, device=device, seed=seed)


def cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(a.double().cpu(),
                                                 b.double().cpu(), dim=1)


def phase_model(seed: int):
    from msml_torch.core.precision import FULL_PRECISION
    from msml_torch.kernels.augment import augment_batch

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    raw = torch.rand((B, H, W, 3), generator=gen, device="cuda")
    x = augment_batch(raw, torch.rand((B, 6), generator=gen, device="cuda"))
    model = build_model(seed)
    with torch.inference_mode():
        feat, seg = model(x)
        torch.cuda.synchronize()
        if feat.shape != (B, 512) or seg.shape != (B, 2, H, W):
            fail(f"shapes {tuple(feat.shape)} {tuple(seg.shape)}")
        if not (torch.isfinite(feat).all() and torch.isfinite(seg).all()):
            fail("non-finite bf16 forward")
        ms = time_ms(lambda: model(x), windows=3, per_window=5)
    print(f"[3 model] arc18_msml bf16 eval forward, B={B}: {ms:.2f} ms "
          f"= {B / ms * 1e3:.1f} img/s")

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model32 = build_model(seed, policy=FULL_PRECISION)
        with torch.inference_mode():
            feat32, seg32 = model32(x[:64])
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    cos = cosines(feat[:64], feat32).min().item()
    if not cos >= BF16_MIN_COS:
        fail(f"bf16 vs f32 feature cosine {cos} < {BF16_MIN_COS}")
    print(f"[3 model] bf16 vs f32 (TF32 off), 64 images: min feature "
          f"cosine {cos:.6f} (>= {BF16_MIN_COS})")

    model_cpu = build_model(seed, policy=FULL_PRECISION, device="cpu")
    with torch.inference_mode():
        feat_cpu, seg_cpu = model_cpu(x[:4].cpu())
    cos = cosines(feat32[:4], feat_cpu).min().item()
    seg_err = ((seg32[:4].cpu() - seg_cpu).abs().max()
               / seg_cpu.abs().max()).item()
    if not (cos >= CPU_MIN_COS and seg_err <= 1e-3):
        fail(f"card f32 vs CPU f32: cosine {cos}, relative seg err "
             f"{seg_err}")
    print(f"[3 model] card f32 vs CPU f32, 4 images: min feature cosine "
          f"{cos:.8f}, relative seg err {seg_err:.2e}")
    return model, B / ms * 1e3


def synthetic_pairs(seed: int, pairs: int = 1200):
    """Same pairs: an image and the image + 3; different pairs: two
    independent images. Integer-valued float32 NHWC in [0, 255]."""
    rs = np.random.RandomState(seed)
    first = rs.randint(0, 256, (pairs, H, W, 3)).astype(np.float32)
    other = rs.randint(0, 256, (pairs, H, W, 3)).astype(np.float32)
    issame = [p % 2 == 0 for p in range(pairs)]
    second = np.where(np.asarray(issame)[:, None, None, None],
                      np.clip(first + 3, 0, 255), other)
    data = np.stack([first, second], 1).reshape(2 * pairs, H, W, 3)
    return [data, data[:, :, ::-1, :].copy()], issame


def phase_sweep(seed: int, model, repeats: int = 2):
    from msml_torch.eval.occ_sweep_device import occlusion_sweep_device
    from msml_torch.kernels import augment

    data_list, issame = synthetic_pairs(seed)

    @torch.inference_mode()
    def extract_fn(img):
        return model(img)[0]

    augment.augment_batch.launches = 0
    t0 = time.perf_counter()
    rows = occlusion_sweep_device(data_list, issame, extract_fn,
                                  fill_type="black", repeats=repeats,
                                  seed=seed, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = augment.augment_batch.launches
    n = data_list[0].shape[0]
    passes = 1 + 9 * repeats
    want = passes * 2 * math.ceil(n / 512)
    if len(rows) != 10:
        fail(f"{len(rows)} sweep rows, expected 10")
    for row in rows:
        vals = [row["avg_acc"], row["roc_acc"], *row["tar_at_far"]]
        if not all(math.isfinite(v) for v in vals):
            fail(f"non-finite sweep row {row}")
    if launches != want:
        fail(f"augment_batch launched {launches} times, expected {want}")
    print(f"[4 sweep] {len(issame)} pairs, 10 ratios, {repeats} repeats: "
          f"{seconds:.1f} s host clock for {passes * 2 * n} images "
          f"({passes * 2 * n / seconds:.1f} img/s incl. metrics), "
          f"{launches} kernel launches")
    print("[4 sweep] avg_acc by ratio: " + ", ".join(
        f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows))
    return launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    smi = phase_device()
    entry = phase_kernel(args.seed)
    model, img_s = phase_model(args.seed)
    entry["launches"] = phase_sweep(args.seed, model)
    print(f"[5 summary] {smi}: augment_batch {entry['ms']:.4f} ms at B={B} "
          f"(bound {entry['bound_ms']:.4f} ms), eval forward {img_s:.1f} "
          "img/s bf16")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
