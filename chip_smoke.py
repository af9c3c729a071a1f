"""Drive the PyTorch port (msml_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases:
  1. device: the card's name and power limit, torch / CUDA / Triton versions
     (the card must be an H100 80GB HBM3: the bounds assume it); then the
     build of the CUDA kernels (`nvcc` into msml_torch/_build/cuda, one
     process per source, side by side): each build's time, the `nvcc
     --version` line and ptxas's registers and spills (an augment, bf16
     forward or dW kernel that spills fails), and the augment kernel's
     shared memory and the clusters the card holds at once;
  2. kernel: each kernel against its plain PyTorch version, and its time
     beside its bound:
     a. `augment_batch` at B = 512, 112 x 112 f32, over every option it
        takes (max abs diff <= 1e-5), at odd shapes (W = 17; H = 9 with
        C = 1; H = 113) on aligned inputs and on inputs one element off,
        the exact block area with relight off and on, two runs bit-equal;
        times (CUDA graphs of the launches, so that the host's time per
        call is out of them) of the sweep's path, relight and gauss;
     b. `augment_batch` on uint8 images at B = 128, the training input
        stage: the same checks, and its time with and without relight;
     c. `prelu_fwd` / `prelu_bwd` at every distinct PReLU shape of
        arc18_msml at B = 128, bf16 and f32: y and dx exactly equal, dalpha
        relative L2 error <= 1e-5 (f32) or 1e-3 (bf16); times at the
        largest site beside `F.prelu` and its autograd backward;
     d. `conv3x3_fwd` (forward, and dX on flipped weights) and `conv3x3_dw`
        at the three C = 64 site shapes at B = 128, bf16 and f32, against
        the plain versions in f32 on the same inputs (relative L2 error:
        f32 forward / dX <= 1e-5, dW <= 1e-4; bf16 forward / dX <= 5e-3,
        dW <= 1e-3), two forward and two dW runs bit-equal; the bf16
        forward, dX and dW also at odd and wide shapes (W = 17, 28 with odd
        H, 57, 113, 200), the forward and dX on aligned tensors and on
        tensors one element off; bf16 times at every site beside the bound
        and cuDNN (`F.conv2d`, `conv2d_input`, `conv2d_weight`);
  3. model: arc18_msml (configs/arc18_msml.yaml, random weights from the
     seed) in bf16 at B = 512 against the same model in float32 (TF32 off)
     and against the float32 model on the CPU; bf16 img/s;
  4. sweep: the eval path, `occlusion_sweep_device` with the model as
     extract_fn over 1200 synthetic pairs, every occlusion ratio, 2 repeats;
     the launch counts of this path are read from this phase alone;
  5. train: the training step, `make_train_step` on arc18_msml with
     webface's 10572 classes, bf16, B = 128, synthetic uint8 batches: 30
     steps on one batch must lower total_loss, every metric finite, each
     kernel launched as often per step as the model has sites; then img/s
     over timed windows and a torch.profiler breakdown of device time by
     kernel; then one float32 step (TF32 off) at B = 4 on the card against
     the same step on the CPU (metrics rtol 1e-3, parameter updates
     relative L2 error <= 1e-2);
  6. cli: this slice's main path, `msml_torch.cli.train.main` on the
     arc18_msml Config with `dataset: synthetic` (10572 classes, bf16,
     B = 128) for 20 steps with a checkpoint every 10 into a temporary
     folder: every logged loss finite, Speed lines logged, the checkpoints
     written, each kernel launched as often as the steps and sites say;
     then a `--resume` run that continues from step 20 to 24; then the
     sweep on the folder it wrote: `load_weight_folder` gives the trained
     model's eval features, and `msml_torch.cli.test --device-sweep` runs
     on it over a `.bin` of 40 synthetic PPM pairs;
  7. a summary line, the JSON line of the kernels (with their times, bounds
     and launch counts), then the final JSON line.

Exits non-zero, without the final line, when CUDA is missing or any check
fails. Needs no network, PyYAML, OpenCV or Pillow.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
B_TRAIN = 128           # configs/arc18_msml.yaml batch_size
PRELU_SITES = 42        # 9 iResNet + 24 FMCnn + 9 U-Net encoder
CONV_SITES = 8          # 64 -> 64 3x3 stride-1 convs (nn.common.Conv3x3)
CONV_SHAPES = ((64, 112, 112), (64, 56, 56), (64, 28, 28))  # (C, H, W)
CONV_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (5e-3, 1e-3)}
ODD_SHAPES = ((4, 9, 17), (4, 27, 28), (4, 7, 57), (2, 5, 113),
              (2, 4, 200))  # (N, H, W) of the extra bf16 conv3x3 checks
KERNEL_TOL = 1e-5       # kernel vs plain version, max abs diff
DALPHA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}  # relative L2
BF16_MIN_COS = 0.99     # bf16 vs f32 feature cosine
CPU_MIN_COS = 0.9999    # card f32 (TF32 off) vs CPU f32 feature cosine
MAIN_PATH = dict(lo=40, hi=41, fill="black", relight=False, use_norm=True)
AUGMENT_ODD = ((4, 112, 17, 3), (4, 9, 112, 1), (4, 113, 112, 3))  # (B, H, W, C)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


CARD = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = 3.35e12  # the card's published memory rate
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak


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


def time_graph_ms(fns, windows: int = 5) -> float:
    """Device time per call of the calls `fns` (one per distinct input, so
    that the inputs and the outputs do not stay in L2), captured once in a
    CUDA graph: median over `windows` replays, by CUDA events. A kernel of
    tens of microseconds takes less than its wrapper's host time, so calls
    made back to back from Python would time the host."""
    for fn in fns:  # builds, compiles and the allocator's first blocks
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    del graph
    torch.cuda.empty_cache()
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


def phase_build():
    """Build the CUDA kernels (their first use would), one nvcc per source,
    all started together, and show each build."""
    from concurrent.futures import ThreadPoolExecutor

    from msml_torch.kernels import _nvcc, augment, conv3x3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda lib: lib(), (conv3x3._lib, augment._lib)))
    print(f"[1 build] csrc/conv3x3.cu and csrc/augment.cu loaded in "
          f"{time.perf_counter() - t0:.1f} s (built side by side)")
    spills = []
    for name in ("conv3x3", "augment"):
        info = _nvcc.builds.get(name)
        if info is None:  # a library of the same sources and flags was there
            print(f"[1 build] csrc/{name}.cu already built in "
                  f"{_nvcc.BUILD_DIR}")
            continue
        print(f"[1 build] nvcc built csrc/{name}.cu in "
              f"{info['seconds']:.1f} s; {info['nvcc']}")
        kernel = None
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(fwd_bf16|fwd_f32|dw_bf16|dw_f32|dw_reduce|"
                              r"augment_cluster)(?:I((?:L[ib]\d+E)+)E)?",
                              line)
                args = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m \
                    else []
                kernel = (m.group(1) + (f"<{', '.join(args)}>" if args
                                        else "") if m else line)
            elif kernel and ("registers" in line or "spill" in line):
                print(f"[1 build]   {kernel}: {line.strip()}")
                if kernel.startswith(("fwd_bf16", "dw_bf16",
                                      "augment_cluster")) and re.search(
                        r"[1-9]\d* bytes spill", line):
                    spills.append(kernel)
    for name, b, dtype in (("f32 B=512", B, torch.float32),
                           ("uint8 B=128", B_TRAIN, torch.uint8)):
        plain = augment.augment_geometry(b, H, W, 3, dtype)
        relit = augment.augment_geometry(b, H, W, 3, dtype, relight=True)
        clusters = augment.augment_occupancy(relit, dtype)[0]
        per_sm = augment.augment_occupancy(plain, dtype)[1]
        print(f"[1 build]   augment_cluster {name}: {plain.blocks} blocks "
              f"of {augment.THREADS} threads, {plain.smem} B of shared "
              f"memory a block ({per_sm} blocks a SM at once), with relight "
              f"{relit.smem} B in clusters of {relit.cluster} ({clusters} "
              "clusters at once)")
    if spills:
        fail(f"{sorted(set(spills))} spill registers")


def offset_copy(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of x that starts `offset` elements past an aligned
    address."""
    flat = torch.empty((x.numel() + offset,), dtype=x.dtype, device=x.device)
    return flat[offset:].view(x.shape).copy_(x)


def check_augment_odd(gen, dtype) -> float:
    """augment_batch against the plain version at odd shapes, each on an
    aligned input and on one that starts one element off, over the fills,
    relight on and off, no block and a block; returns the max abs diff."""
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference)

    worst = 0.0
    for (b, h, w, c), offset in itertools.product(AUGMENT_ODD, (0, 1)):
        img = torch.rand((b, h, w, c), generator=gen, device="cuda")
        if dtype == torch.uint8:
            img = (img * 256).to(torch.uint8)
        img = offset_copy(img, offset)
        noise = torch.randn(img.shape, generator=gen, device="cuda")
        draws = torch.rand((b, 6), generator=gen, device="cuda")
        for fill, relight, (lo, hi) in itertools.product(
                ("black", "white", "gauss"), (True, False),
                ((0, 1), (20, 51))):
            kw = dict(lo=lo, hi=hi, fill=fill, relight=relight,
                      use_norm=True)
            err = (augment_batch(img, draws, noise, **kw)
                   - augment_batch_reference(img, draws, noise, **kw)
                   ).abs().max().item()
            if not err <= KERNEL_TOL:
                fail(f"augment {dtype} {(b, h, w, c)} offset {offset}: max "
                     f"abs diff {err} at {kw}")
            worst = max(worst, err)
    return worst


def augment_bytes(img, draws, kw) -> int:
    """Bytes `augment_batch` must move: the image read once, the f32 NCHW
    output written once, the draws, and, for the gauss fill, the noise
    inside each image's square (the only noise it reads)."""
    _, h, w, c = img.shape
    moved = img.numel() * (img.element_size() + 4) + draws.numel() * 4
    if kw["fill"] == "gauss" and (kw["hi"] > 1 or kw["lo"] > 0):
        r0 = draws[:, 0].double().cpu()
        ratio = (kw["lo"] + torch.floor(r0 * (kw["hi"] - kw["lo"]))) * 0.01
        side = torch.floor(torch.sqrt(ratio) * w).clamp(max=min(h, w))
        moved += int((side * side).sum()) * c * 4
    return moved


def check_bit_equal(fn, what: str):
    if not torch.equal(fn(), fn()):
        fail(f"augment_batch {what}: two runs differ")


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
    odd_err = check_augment_odd(gen, torch.float32)
    print(f"[2 kernel] 72 option sets, C in (3, 1): max abs diff {max_err}; "
          f"odd shapes {AUGMENT_ODD}, aligned and one element off, 12 "
          f"option sets each: max abs diff {odd_err} (tolerance "
          f"{KERNEL_TOL})")
    max_err = max(max_err, odd_err)

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
          "images, relight off and on")

    imgs = [torch.rand((B, H, W, 3), generator=gen, device="cuda")
            for _ in range(3)]
    img = imgs[0]
    noise = torch.randn(img.shape, generator=gen, device="cuda")
    timed = {}
    for name, kw in (("main path", MAIN_PATH),
                     ("relight", dict(MAIN_PATH, relight=True)),
                     ("gauss", dict(MAIN_PATH, fill="gauss"))):
        check_bit_equal(lambda: augment_batch(img, draws, noise, **kw), name)
        moved = augment_bytes(img, draws, kw)
        ms = time_graph_ms([lambda x=x: augment_batch(x, draws, noise, **kw)
                            for x in imgs])
        plain_ms = time_ms(
            lambda: augment_batch_reference(img, draws, noise, **kw))
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        timed[name] = (ms, plain_ms, bound_ms)
        print(f"[2 kernel] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
              f"{moved / 1e6:.1f} MB moved, bound {bound_ms:.4f} ms = "
              f"{bound_ms / ms:.1%} of the memory rate; two runs bit-equal")
    ms, plain_ms, bound_ms = timed["main path"]
    return {"name": "augment_batch", "route": "cuda",
            "source": "msml_torch/csrc/augment.cu",
            "replaces": "msml_tpu/kernels/augment.py:131",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "relight": dict(zip(("ms", "plain_ms", "bound_ms"),
                                timed["relight"])),
            "gauss": dict(zip(("ms", "plain_ms", "bound_ms"),
                              timed["gauss"]))}


def phase_kernel_uint8(seed: int) -> dict:
    """The training input stage: uint8 images through `augment_batch`."""
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference)

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    img = torch.randint(0, 256, (B_TRAIN, H, W, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    draws = torch.rand((B_TRAIN, 6), generator=gen, device="cuda")
    noise = torch.randn(img.shape, generator=gen, device="cuda")
    max_err = 0.0
    for fill, relight, use_norm, (lo, hi) in itertools.product(
            ("black", "gauss"), (True, False), (True, False),
            ((0, 1), (20, 51))):
        kw = dict(lo=lo, hi=hi, fill=fill, relight=relight,
                  use_norm=use_norm)
        err = (augment_batch(img, draws, noise, **kw)
               - augment_batch_reference(img, draws, noise, **kw)
               ).abs().max().item()
        if not err <= KERNEL_TOL:
            fail(f"uint8 kernel vs plain max abs diff {err} at {kw}")
        max_err = max(max_err, err)
    torch.cuda.synchronize()
    odd_err = check_augment_odd(gen, torch.uint8)
    flat = torch.full((B_TRAIN, H, W, 3), 128, dtype=torch.uint8,
                      device="cuda")
    want = math.floor(math.sqrt(0.40) * W) ** 2
    for relight in (False, True):
        out = augment_batch(flat, draws, lo=40, hi=41, fill="black",
                            relight=relight, use_norm=False)
        area = (out == 0).all(dim=1).sum(dim=(1, 2))
        if not bool((area == want).all()):
            fail(f"uint8 block area {area.unique().tolist()} != {want} "
                 f"(relight={relight})")
    train = dict(lo=0, hi=1, fill="black", relight=True,
                 use_norm=True)  # device_input_stage
    check_bit_equal(lambda: augment_batch(img, draws, **train), "uint8")
    moved = augment_bytes(img, draws, train)
    imgs = [torch.randint(0, 256, img.shape, generator=gen, device="cuda",
                          dtype=torch.uint8) for _ in range(12)]
    ms = time_graph_ms([lambda x=x: augment_batch(x, draws, **train)
                        for x in imgs])
    norm_ms = time_graph_ms([lambda x=x: augment_batch(
        x, draws, **dict(train, relight=False)) for x in imgs])
    plain_ms = time_ms(lambda: augment_batch_reference(img, draws, **train))
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"[2b uint8] 16 option sets at B={B_TRAIN}: max abs diff "
          f"{max_err}; odd shapes {AUGMENT_ODD}, aligned and one element "
          f"off: {odd_err} (tolerance {KERNEL_TOL}); block area {want} px, "
          f"relight off and on; input stage (relight + normalize) "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms), {moved / 1e6:.1f} MB "
          f"moved, bound {bound_ms:.4f} ms = {bound_ms / ms:.1%} of the "
          f"memory rate; two runs bit-equal; without relight (no cluster) "
          f"{norm_ms:.4f} ms")
    return {"max_abs_err": max(max_err, odd_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "no_relight_ms": norm_ms}


def prelu_sites(seed: int):
    """(C, H, W) of every PReLU call in one arc18_msml forward."""
    from msml_torch.nn.common import PReLU

    model = build_model(seed)
    shapes = []
    for m in model.modules():
        if isinstance(m, PReLU):
            m.register_forward_pre_hook(
                lambda _, args: shapes.append(tuple(args[0].shape[1:])))
    with torch.inference_mode():
        model(torch.zeros((2, 3, H, W), device="cuda"))
    return shapes


def phase_kernel_prelu(seed: int):
    """prelu_fwd / prelu_bwd against the plain versions at every distinct
    site shape, then timed at the largest site."""
    import torch.nn.functional as F

    from msml_torch.kernels.prelu import (_geometry, prelu, prelu_bwd,
                                          prelu_bwd_reference, prelu_fwd,
                                          prelu_reference)

    sites = prelu_sites(seed)
    if len(sites) != PRELU_SITES:
        fail(f"{len(sites)} PReLU sites in arc18_msml, expected "
             f"{PRELU_SITES}")
    shapes = sorted(set(sites), key=lambda s: -s[0] * s[1] * s[2])
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    errs = {"fwd": 0.0, "bwd": 0.0}
    worst_da = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c, h, w in shapes:
            x = torch.randn((B_TRAIN, c, h, w), generator=gen,
                            device="cuda")
            x[torch.rand(x.shape, generator=gen, device="cuda") < 0.05] = 0
            x = x.to(dtype)
            g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            a = torch.rand((c,), generator=gen, device="cuda") * 0.5
            y, y_ref = prelu_fwd(x, a), prelu_reference(x, a)
            (dx, da), (dx_ref, da_ref) = (prelu_bwd(g, x, a),
                                         prelu_bwd_reference(g, x, a))
            torch.cuda.synchronize()
            if not (torch.equal(y, y_ref) and torch.equal(dx, dx_ref)):
                fail(f"prelu {dtype} {(c, h, w)}: y or dx not equal to the "
                     "plain version")
            rel = ((da - da_ref).norm() / da_ref.norm()).item()
            if not rel <= DALPHA_TOL[dtype]:
                fail(f"prelu {dtype} {(c, h, w)}: dalpha relative error "
                     f"{rel} > {DALPHA_TOL[dtype]}")
            worst_da[dtype] = max(worst_da.get(dtype, 0.0), rel)
            errs["fwd"] = max(errs["fwd"],
                              (y.float() - y_ref.float()).abs().max().item())
            errs["bwd"] = max(errs["bwd"], (da - da_ref).abs().max().item())
    print(f"[2c prelu] {len(sites)} sites, {len(shapes)} distinct (C, H, W) "
          f"at B={B_TRAIN}, bf16 and f32: y and dx exactly equal to the "
          "plain version; dalpha relative L2 error "
          + ", ".join(f"{str(k)[6:]} {v:.2e}" for k, v in worst_da.items()))

    timed = {}
    c, h, w = shapes[0]
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((B_TRAIN, c, h, w), generator=gen,
                        device="cuda").to(dtype)
        g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        a = torch.rand((c,), generator=gen, device="cuda") * 0.5
        xr, ar = x.clone().requires_grad_(), a.clone().requires_grad_()
        y_lib = F.prelu(xr, ar.to(dtype))

        def fwd_bwd(fn):
            xg, ag = x.clone().requires_grad_(), a.clone().requires_grad_()
            return torch.autograd.grad(fn(xg, ag), (xg, ag), g)

        lib = lambda xx, aa: F.prelu(xx, aa.to(xx.dtype))
        n_parts = math.prod(_geometry(x)[-1])  # dalpha partials
        nbytes = x.numel() * x.element_size()
        timed[dtype] = {
            "fwd": (time_ms(lambda: prelu_fwd(x, a)),
                    time_ms(lambda: prelu_reference(x, a)),
                    time_ms(lambda: lib(x, a)),
                    2 * nbytes / HBM_BYTES_PER_S * 1e3),
            "bwd": (time_ms(lambda: prelu_bwd(g, x, a)),
                    time_ms(lambda: prelu_bwd_reference(g, x, a)),
                    time_ms(lambda: torch.autograd.grad(
                        y_lib, (xr, ar), g, retain_graph=True)),
                    (3 * nbytes + 8 * n_parts) / HBM_BYTES_PER_S * 1e3),
            "fwd+bwd": (time_ms(lambda: fwd_bwd(prelu)),
                        time_ms(lambda: fwd_bwd(prelu_reference)),
                        time_ms(lambda: fwd_bwd(lib)), None)}
        for part, (ms, plain_ms, lib_ms, bound_ms) in timed[dtype].items():
            bound = ("" if bound_ms is None else
                     f", bound {bound_ms:.4f} ms = {bound_ms / ms:.1%} of "
                     "the memory rate")
            print(f"[2c prelu] {str(dtype)[6:]} {part} at "
                  f"{(B_TRAIN, c, h, w)}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.prelu {lib_ms:.4f} ms{bound}")
    entries = []
    for name, part, err in (("prelu_fwd", "fwd", errs["fwd"]),
                            ("prelu_bwd", "bwd", errs["bwd"])):
        ms, plain_ms, lib_ms, bound_ms = timed[torch.bfloat16][part]
        entries.append({
            "name": name, "route": "triton",
            "source": "msml_torch/kernels/prelu.py",
            "replaces": ("benchmarks/negative/prelu_pallas.py:46"
                         if part == "fwd" else
                         "benchmarks/negative/prelu_pallas.py:53"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "shape": [B_TRAIN, c, h, w], "dtype": "bfloat16"})
    return entries


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def offset_bf16(gen, shape, offset: int) -> torch.Tensor:
    """A contiguous bf16 tensor that starts `offset` elements past an
    aligned address."""
    numel = math.prod(shape)
    return (torch.randn((numel + offset,), generator=gen, device="cuda")
            .bfloat16()[offset:].view(shape))


def phase_kernel_conv(seed: int):
    """conv3x3_fwd (forward and dX) and conv3x3_dw against the plain
    versions at the three site shapes and at odd and wide shapes, then the
    bf16 times at every site beside the bound and cuDNN."""
    from torch.nn.grad import conv2d_input, conv2d_weight
    import torch.nn.functional as F

    from msml_torch.kernels.conv3x3 import (conv3x3_dw, conv3x3_dw_reference,
                                            conv3x3_fwd, conv3x3_reference,
                                            flip_weights)

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    errs = {"fwd": 0.0, "dw": 0.0}
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol_y, tol_dw = CONV_TOL[dtype]
        for c, h, w in CONV_SHAPES:
            x = torch.randn((B_TRAIN, c, h, w), generator=gen,
                            device="cuda").to(dtype)
            dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            wt = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
                  / 24).to(dtype)
            wf = flip_weights(wt).contiguous()
            outs = {"fwd": (conv3x3_fwd(x, wt),
                            conv3x3_reference(x.float(), wt.float())),
                    "dx": (conv3x3_fwd(dy, wf),
                           conv3x3_reference(dy.float(), wf.float())),
                    "dw": (conv3x3_dw(x, dy),
                           conv3x3_dw_reference(x.float(), dy.float()))}
            again = conv3x3_fwd(x, wt), conv3x3_dw(x, dy)
            torch.cuda.synchronize()
            if not (torch.equal(outs["fwd"][0], again[0])
                    and torch.equal(outs["dw"][0], again[1])):
                fail(f"conv3x3 {dtype} {(c, h, w)}: two runs differ")
            for part, (got, ref) in outs.items():
                rel = rel_l2(got, ref)
                tol = tol_dw if part == "dw" else tol_y
                if not rel <= tol:
                    fail(f"conv3x3 {part} {dtype} {(c, h, w)}: relative L2 "
                         f"error {rel} > {tol}")
                key = (str(dtype)[6:], part)
                worst[key] = max(worst.get(key, 0.0), rel)
                err = (got.float() - ref).abs().max().item()
                slot = "dw" if part == "dw" else "fwd"
                errs[slot] = max(errs[slot], err)
            del x, dy, outs, again
    print(f"[2d conv3x3] {len(CONV_SHAPES)} site shapes at B={B_TRAIN}, bf16 "
          "and f32, against the plain versions in f32: relative L2 error "
          + ", ".join(f"{d} {p} {v:.2e}" for (d, p), v in worst.items())
          + "; two forward and two dW runs bit-equal")
    odd = []
    for (n, h, w), offset in itertools.product(ODD_SHAPES, (0, 1)):
        x = offset_bf16(gen, (n, 64, h, w), offset)
        dy = offset_bf16(gen, (n, 64, h, w), offset)
        wt = (torch.randn((64, 64, 3, 3), generator=gen, device="cuda")
              / 24).bfloat16()
        wf = flip_weights(wt).contiguous()
        got = {"fwd": (conv3x3_fwd(x, wt),
                       conv3x3_reference(x.float(), wt.float())),
               "dx": (conv3x3_fwd(dy, wf),
                      conv3x3_reference(dy.float(), wf.float()))}
        agains = [(got["fwd"][0], conv3x3_fwd(x, wt))]
        if offset == 0:
            got["dw"] = (conv3x3_dw(x, dy),
                         conv3x3_dw_reference(x.float(), dy.float()))
            agains.append((got["dw"][0], conv3x3_dw(x, dy)))
        torch.cuda.synchronize()
        rels = {part: rel_l2(a, ref) for part, (a, ref) in got.items()}
        tols = {p: CONV_TOL[torch.bfloat16][p == "dw"] for p in rels}
        if not (all(rels[p] <= tols[p] for p in rels)
                and all(torch.equal(a, b) for a, b in agains)):
            fail(f"conv3x3 bf16 {(n, h, w)} offset {offset}: relative L2 "
                 f"errors {rels}, two runs equal "
                 f"{[torch.equal(a, b) for a, b in agains]}")
        for part, (a, ref) in got.items():
            slot = "dw" if part == "dw" else "fwd"
            errs[slot] = max(errs[slot], (a.float() - ref).abs().max().item())
        odd.append(f"{(n, h, w)}{'+1' if offset else ''} "
                   + "/".join(f"{v:.2e}" for v in rels.values()))
    print("[2d conv3x3] bf16 at odd and wide shapes (+1: tensors one element "
          "off), relative L2 error forward/dX[/dW]: " + ", ".join(odd)
          + "; two runs bit-equal at each")

    dtype = torch.bfloat16
    sites = {}
    for c, h, w in CONV_SHAPES:
        x = torch.randn((B_TRAIN, c, h, w), generator=gen,
                        device="cuda").to(dtype)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        wt = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
              / 24).to(dtype)
        wf = flip_weights(wt).contiguous()
        flops = 2 * x.numel() * 9 * c  # per pass: 118.4 GFLOP at 112^2
        nbytes = 2 * x.numel() * x.element_size()  # x and y, or x and dy
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS
                    else "operations")
        plain = (lambda fn: time_ms(fn, windows=3, per_window=3)) \
            if (h, w) == CONV_SHAPES[0][1:] else (lambda fn: None)
        t = {
            "fwd": (time_ms(lambda: conv3x3_fwd(x, wt), per_window=10),
                    plain(lambda: conv3x3_reference(x, wt)),
                    time_ms(lambda: F.conv2d(x, wt, padding=1),
                            per_window=10)),
            "dx": (time_ms(lambda: conv3x3_fwd(dy, wf), per_window=10),
                   plain(lambda: conv3x3_reference(dy, wf)),
                   time_ms(lambda: conv2d_input(x.shape, wt, dy, padding=1),
                           per_window=10)),
            "dw": (time_ms(lambda: conv3x3_dw(x, dy), per_window=10),
                   plain(lambda: conv3x3_dw_reference(x, dy)),
                   time_ms(lambda: conv2d_weight(x, wt.shape, dy, padding=1),
                           per_window=10))}
        for part, (ms, plain_ms, lib_ms) in t.items():
            print(f"[2d conv3x3] bf16 {part} at {(B_TRAIN, c, h, w)}: kernel "
                  f"{ms:.4f} ms"
                  + ("" if plain_ms is None else f", plain {plain_ms:.4f} ms")
                  + f", cuDNN {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {flops / 1e9:.1f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB) = {bound_ms / ms:.1%} of it")
        sites[f"{h}x{w}"] = (t, bound_ms, bound_by)
        del x, dy
    c, h, w = CONV_SHAPES[0]
    timed, bound_ms, bound_by = sites[f"{h}x{w}"]
    entries = []
    for name, part, err, line in (("conv3x3_fwd", "fwd", errs["fwd"], 109),
                                  ("conv3x3_dw", "dw", errs["dw"], 186)):
        ms, plain_ms, lib_ms = timed[part]
        entry = {"name": name, "route": "cuda",
                 "source": "msml_torch/csrc/conv3x3.cu",
                 "replaces": f"benchmarks/negative/conv_gemm.py:{line}",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": lib_ms, "shape": [B_TRAIN, c, h, w],
                 "dtype": "bfloat16"}
        parts = ("fwd", "dx") if part == "fwd" else ("dw",)
        if part == "fwd":
            entry["dx"] = dict(zip(("ms", "plain_ms", "library_ms"),
                                   timed["dx"]), bound_ms=bound_ms)
        entry["sites"] = {
            site: {p: {"ms": st[p][0], "library_ms": st[p][2]}
                   for p in parts} | {"bound_ms": sb}
            for site, (st, sb, _) in sites.items()}
        entries.append(entry)
    return entries


def arc18_config(**over):
    from msml_torch.core.config import Config, config_init

    cfg = Config.from_dict(dict(ARC18_MSML, **over))
    config_init(cfg, make_output_dir=False)
    return cfg


def build_model(seed: int, policy=None, device="cuda", head=False):
    from msml_torch.nn.msml import msml_from_config

    return msml_from_config(arc18_config(), policy=policy, device=device,
                            seed=seed, head=head)


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

    data_list, issame = synthetic_pairs(seed)

    @torch.inference_mode()
    def extract_fn(img):
        return model(img)[0]

    reset_launches()
    t0 = time.perf_counter()
    rows = occlusion_sweep_device(data_list, issame, extract_fn,
                                  fill_type="black", repeats=repeats,
                                  seed=seed, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    n = data_list[0].shape[0]
    passes = 1 + 9 * repeats
    batches = passes * 2 * math.ceil(n / 512)
    want = {"augment_batch": batches, "prelu_fwd": batches * PRELU_SITES,
            "prelu_bwd": 0, "conv3x3_fwd": batches * CONV_SITES,
            "conv3x3_dw": 0}
    if len(rows) != 10:
        fail(f"{len(rows)} sweep rows, expected 10")
    for row in rows:
        vals = [row["avg_acc"], row["roc_acc"], *row["tar_at_far"]]
        if not all(math.isfinite(v) for v in vals):
            fail(f"non-finite sweep row {row}")
    if launches != want:
        fail(f"sweep launches {launches}, expected {want}")
    print(f"[4 sweep] {len(issame)} pairs, 10 ratios, {repeats} repeats: "
          f"{seconds:.1f} s host clock for {passes * 2 * n} images "
          f"({passes * 2 * n / seconds:.1f} img/s incl. metrics), "
          f"kernel launches {launches}")
    print("[4 sweep] avg_acc by ratio: " + ", ".join(
        f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows))
    return launches


def counted():
    from msml_torch.kernels import augment, conv3x3, prelu

    return (augment.augment_batch, prelu.prelu_fwd, prelu.prelu_bwd,
            conv3x3.conv3x3_fwd, conv3x3.conv3x3_dw)


def reset_launches():
    for fn in counted():
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in counted()}


def per_step(steps: int) -> dict:
    """Launches of `steps` train steps: one input stage, the PReLU pair at
    every PReLU site, forward and dX at every conv site, dW at each."""
    return {"augment_batch": steps, "prelu_fwd": steps * PRELU_SITES,
            "prelu_bwd": steps * PRELU_SITES,
            "conv3x3_fwd": steps * 2 * CONV_SITES,
            "conv3x3_dw": steps * CONV_SITES}


def phase_train(seed: int, steps: int = 30):
    """The training path at B = 128 in bf16; -> (launches, img/s)."""
    from msml_torch.core.config import lr_step_factor
    from msml_torch.data.synthetic import synthetic_batch
    from msml_torch.train.train_step import init_train_state, make_train_step

    cfg = arc18_config()
    state = init_train_state(build_model(seed, head=True), cfg, "cuda", seed)
    step = make_train_step(cfg)
    host = synthetic_batch(B_TRAIN, num_classes=cfg.num_classes, seed=seed,
                           uint8=True)
    batch = {k: torch.as_tensor(host[k], device="cuda")
             for k in ("img", "label", "msk")}
    lr = lr_step_factor(cfg, 0)

    reset_launches()
    history = [step(state, batch, lr) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != per_step(steps):
        fail(f"train launches {launches}, expected {per_step(steps)}")
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not torch.isfinite(v).item()]
        if bad:
            fail(f"non-finite {bad} at step {i}")
    losses = [m["total_loss"].item() for m in history]
    if not losses[-1] < losses[0]:
        fail(f"total_loss did not fall over {steps} steps: {losses}")
    print(f"[5 train] arc18_msml bf16, {cfg.num_classes} classes, "
          f"B={B_TRAIN}, {steps} steps on one batch: total_loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; last metrics "
          + ", ".join(f"{k} {v.item():.4f}" for k, v in history[-1].items()))
    print(f"[5 train] launches per step: " + ", ".join(
        f"{k} {v // steps}" for k, v in launches.items())
        + f" ({PRELU_SITES} PReLU sites, {CONV_SITES} conv3x3 sites)")

    ms = time_ms(lambda: step(state, batch, lr), windows=5, per_window=4)
    img_s = B_TRAIN / ms * 1e3
    print(f"[5 train] step {ms:.2f} ms = {img_s:.1f} img/s (median of 5 "
          "windows of 4 steps, CUDA events)")
    profile_train(lambda: step(state, batch, lr), ms)
    return launches, img_s


def profile_train(run_step, step_ms: float, steps: int = 4):
    """Device time by kernel over `steps` train steps (torch.profiler), and
    the busy share against the CUDA-event step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        print("[5 train] profile: no device time in the trace (not "
              "measured)")
        return
    per_step = busy_us / steps / 1e3
    print(f"[5 train] profile, {steps} steps: device busy {per_step:.2f} ms "
          f"per step = {per_step / step_ms:.1%} of the {step_ms:.2f} ms "
          f"step, {len(kernels)} kernel names")
    groups = {"conv3x3 (CUDA)": ("fwd_bf16", "fwd_f32", "dw_bf16", "dw_f32",
                                 "dw_reduce"),
              "prelu (Triton)": ("_prelu_",), "augment (CUDA)": (
        "augment_cluster",), "conv / gemm": ("conv", "gemm", "xmma", "sm90",
                                             "cutlass", "implicit"),
              "batch norm": ("batch_norm", "bn_", "welford"),
              "optimizer": ("multi_tensor", "foreach")}
    shares = dict.fromkeys(groups, 0.0)
    for e in kernels:
        for g, keys in groups.items():
            if any(k in e.key.lower() for k in keys):
                shares[g] += e.self_device_time_total
                break
    shares["other"] = busy_us - sum(shares.values())
    print("[5 train] profile by group (ms per step, share of device "
          "time): " + "; ".join(f"{g} {v / steps / 1e3:.2f} "
                                f"({v / busy_us:.1%})"
                                for g, v in shares.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[5 train]   {e.self_device_time_total / steps / 1e3:8.3f} ms"
              f"  x{e.count // steps:<4d} {e.key[:100]}")


def phase_train_cpu_parity(seed: int, b: int = 4):
    """One float32 step (TF32 off) on the card against the CPU, from the
    same weights, batch and relight draws."""
    from msml_torch.core.precision import FULL_PRECISION
    from msml_torch.data.synthetic import synthetic_batch
    from msml_torch.train.train_step import init_train_state, make_train_step

    cfg = arc18_config(batch_size=b)
    batch = synthetic_batch(b, num_classes=cfg.num_classes, seed=seed + 4,
                            uint8=True)
    draws = torch.rand((b, 3), generator=torch.Generator().manual_seed(seed))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(seed, policy=FULL_PRECISION, device=dev,
                                head=True)
            state = init_train_state(model, cfg, dev, seed)
            names = {p: n for n, p in model.named_parameters()}
            m = make_train_step(cfg)(state, batch, 1.0,
                                     light_draws=draws.to(dev))
            upd = {names[p]: (state.optimizer.state[p]["momentum_buffer"]
                              * g["lr"]).double().cpu()
                   for g in state.optimizer.param_groups
                   for p in g["params"]}
            out[dev] = ({k: v.item() for k, v in m.items()}, upd)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    (mg, ug), (mc, uc) = out["cuda"], out["cpu"]
    for k in mc:
        if not math.isclose(mg[k], mc[k], rel_tol=1e-3, abs_tol=1e-9):
            fail(f"card vs CPU f32 step: {k} {mg[k]} vs {mc[k]}")
    err = math.sqrt(sum(((ug[k] - uc[k]) ** 2).sum().item() for k in uc)
                    / sum((uc[k] ** 2).sum().item() for k in uc))
    if not err <= 1e-2:
        fail(f"card vs CPU f32 step: update relative L2 error {err}")
    worst = max(uc, key=lambda k: ((ug[k] - uc[k]).norm()
                                   / uc[k].norm()).item())
    print(f"[5 train] card f32 (TF32 off) vs CPU f32, one step at B={b}: "
          "metrics " + ", ".join(f"{k} {mg[k]:.6f}/{mc[k]:.6f}" for k in mc)
          + f"; update relative L2 error {err:.2e} (worst tensor {worst} "
          f"{((ug[worst] - uc[worst]).norm() / uc[worst].norm()).item():.2e})")


def phase_cli(seed: int, steps: int = 20, resume_to: int = 24):
    """This slice's main path: the training CLI on the card; -> (launches,
    img/s from its last Speed line)."""
    from msml_torch.cli.train import main, parse_args
    from msml_torch.core.checkpoint import all_steps
    from msml_torch.core.config import Config

    def cfg(out):
        return Config.from_dict(dict(ARC18_MSML, dataset="synthetic",
                                     num_classes=10572, out_folder=out))

    with tempfile.TemporaryDirectory() as out:
        argv = ["--steps", str(steps), "--ckpt-every", "10", "--log-every",
                "5", "--seed", str(seed), "--device", "cuda"]
        reset_launches()
        t0 = time.perf_counter()
        state = main(parse_args(argv), cfg(out))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        output = os.path.join(out, "arc18_msml_1")
        with open(os.path.join(output, "training.log")) as f:
            log = f.read()
        losses = [float(v) for v in re.findall(r" Loss (\S+) ", log)]
        speeds = [float(v) for v in
                  re.findall(r"Speed (\S+) samples/sec", log)]
        if state.step != steps or launches != per_step(steps):
            fail(f"cli: step {state.step}, launches {launches}, expected "
                 f"{steps} and {per_step(steps)}")
        if not speeds or not all(math.isfinite(v) for v in losses):
            fail(f"cli: Speed lines {speeds}, logged losses {losses}")
        if all_steps(output) != [10, steps]:
            fail(f"cli: checkpoints {all_steps(output)}")
        print(f"[6 cli] {steps} steps at B={B_TRAIN}, bf16, 10572 classes in "
              f"{seconds:.1f} s host clock (model build and 2 checkpoints "
              f"included); Speed lines (samples/s) {speeds}; logged losses "
              f"{[round(v, 4) for v in losses]}; checkpoints "
              f"{all_steps(output)}; launches {launches}")
        state = main(parse_args(argv[2:] + ["--steps", str(resume_to),
                                            "--resume"]), cfg(out))
        with open(os.path.join(output, "training.log")) as f:
            resumed = f"backbone resume successfully! step={steps}" in f.read()
        if not resumed or state.step != resume_to:
            fail(f"cli --resume: resumed {resumed}, step {state.step}")
        print(f"[6 cli] --resume from step {steps} ran to step {state.step}; "
              f"checkpoints {all_steps(output)}")
        sweep_launches = cli_sweep(seed, state, output, out)
    return launches, speeds[-1], sweep_launches


def cli_sweep(seed: int, state, folder: str, scratch: str, pairs: int = 40):
    """The train-then-sweep round trip on the folder the training CLI
    wrote; -> the sweep's launch counts."""
    import pickle

    from msml_torch.cli import test as cli_test
    from msml_torch.core.weight_folder import load_weight_folder, weights_path
    from msml_torch.data.bin_loader import ppm_encode

    _, model = load_weight_folder(folder, device="cuda")
    x = torch.rand((16, 3, H, W), generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    state.model.eval()
    with torch.inference_mode():
        got, want = model(x)[0], state.model(x)[0]
    cos = cosines(got, want).min().item()
    if not cos >= CPU_MIN_COS:
        fail(f"cli sweep: loaded vs trained feature cosine {cos}")
    data, issame = synthetic_pairs(seed, pairs)
    bin_path = os.path.join(scratch, "pairs.bin")
    with open(bin_path, "wb") as f:
        pickle.dump(([ppm_encode(a.astype(np.uint8)) for a in data[0]],
                     issame), f)
    reset_launches()
    rows = cli_test.main(cli_test.parse_args(
        ["--device-sweep", "--weight_folder", folder, "--bin", bin_path,
         "--device", "cuda"]))
    torch.cuda.synchronize()
    launches = read_launches()
    batches = (1 + 9 * 10) * 2  # 10 repeats at 9 ratios, 2 flips
    want_launches = {"augment_batch": batches,
                     "prelu_fwd": batches * PRELU_SITES, "prelu_bwd": 0,
                     "conv3x3_fwd": batches * CONV_SITES, "conv3x3_dw": 0}
    if len(rows) != 10 or launches != want_launches or not all(
            math.isfinite(r["avg_acc"]) for r in rows):
        fail(f"cli sweep: {len(rows)} rows, launches {launches}")
    print(f"[6 cli] cli.test --device-sweep on the trained folder "
          f"({os.path.relpath(weights_path(folder), folder)}), {pairs} PPM "
          f"pairs: loaded vs trained features min cosine {cos:.8f} "
          f"(max abs diff {(got - want).abs().max().item():.3g}); avg_acc "
          + ", ".join(f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows)
          + f"; launches {launches}")
    return launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    smi = phase_device()
    phase_build()
    augment_entry = phase_kernel(args.seed)
    uint8 = phase_kernel_uint8(args.seed)
    prelu_entries = phase_kernel_prelu(args.seed)
    conv_entries = phase_kernel_conv(args.seed)
    model, eval_img_s = phase_model(args.seed)
    sweep_launches = phase_sweep(args.seed, model)
    del model
    train_launches, train_img_s = phase_train(args.seed)
    phase_train_cpu_parity(args.seed)
    cli_launches, cli_img_s, cli_sweep_launches = phase_cli(args.seed)

    # this slice's path is the training CLI: its launches; the uint8 input
    # stage's times at B = 128, and the eval and train-step paths' launches
    # kept beside them
    augment_entry["sweep"] = {k: augment_entry.pop(k) for k in (
        "ms", "plain_ms", "bound_ms")}
    augment_entry.update(uint8)
    augment_entry["max_abs_err"] = max(augment_entry["max_abs_err"],
                                       uint8["max_abs_err"])
    entries = [augment_entry] + prelu_entries + conv_entries
    for e in entries:
        e["launches"] = cli_launches[e["name"]]
        e["launches_sweep"] = sweep_launches[e["name"]]
        e["launches_train_step"] = train_launches[e["name"]]
        e["launches_cli_sweep"] = cli_sweep_launches[e["name"]]
    print(f"[7 summary] {smi}: CLI {cli_img_s:.1f} img/s (last Speed line); "
          f"train step {train_img_s:.1f} img/s bf16 at B={B_TRAIN}; eval "
          f"forward {eval_img_s:.1f} img/s at B={B}; "
          + "; ".join(f"{e['name']} {e['ms']:.4f} ms (bound "
                      f"{e['bound_ms']:.4f} ms)" for e in entries))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
