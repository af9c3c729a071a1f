"""Drive the PyTorch port (msml_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases:
  1. device: the card's name and power limit, torch / CUDA / Triton versions
     (the card must be an H100 80GB HBM3: the bounds assume it); then the
     build of the CUDA kernels (`nvcc` into msml_torch/_build/cuda, one
     process per source, side by side): each build's time, the `nvcc
     --version` line and ptxas's registers and spills (an augment, bf16
     forward or dW kernel that spills fails), the augment kernel's
     shared memory and the clusters the card holds at once, and
     `quant_act`'s largest cluster and, for its plans at the large bf16
     inputs, the fc's and the f32 112² input at B = 512, its shared
     memory a block and the clusters the card holds at once;
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
     then the same for 30 steps, one run with blocking saves
     (`--sync-ckpt`) and one with asynchronous ones: their Speed by
     window, each save's seconds on the loop, and the steps' seconds;
     then a `--resume` run that continues from step 20 to 24; then
     the sweep on the folder it wrote: `load_weight_folder` gives the
     trained model's eval features, and `msml_torch.cli.test
     --device-sweep` runs on it over a `.bin` of 40 synthetic PPM pairs;
  7. a summary line (with each phase's host seconds), the JSON line of
     the kernels (with their times, bounds and launch counts on each
     path: `launches` on the training CLI, for the int8 kernels on phase
     11's quantized forward;
     `launches_cli_host_sweep` from 10's BB sweep; `launches_quant`,
     `launches_serve_quant` and `launches_cli_quant_sweep` from 11), then
     the final JSON line;
  8. serve (run within phase 6, on the folder the training CLI wrote, so
     its lines come before 7's): `conv3x3_fwd` and `prelu_fwd` against
     their plain versions at the bucket batches 1, 2, 4, ..., 32 (bf16, the
     eval forward's shapes, phase 2c/2d's tolerances); then `cli.serve`'s
     weight-folder server (warmed up, max batch 32, a 5 ms window): its
     /healthz keys, an /embed_batch of 37 images and 64 concurrent /embed
     requests with PPM bodies, every answer against a direct B = 512
     forward (cosine >= 0.999), /metrics (65 requests, no error, a batch
     of more than one), each kernel launched as often as the forwards and
     sites say; then `tools.export_serving` on the folder and an
     `--artifact` server (answers against the weight-folder server's,
     cosine >= 0.9999; the same launches per forward), and `cli.embed`
     over 40 PPM files; the forward's ms per bucket, /embed latency at
     concurrency 1 and 64 and /embed_batch img/s, beside the card's name;
  9. data (after 6, its lines before 7's): the training CLI fed from a RecordIO
     rec, as users train. Pillow's and OpenCV's versions (it fails without
     them), `os.cpu_count()` and the workers used (min(32, cores) for the
     loader alone; webface's `nw` = 32 in the CLI). It writes, with the
     port's tools, a rec of 200 ids x 12 views (2000 train images, 112 x
     112 JPEG q80) and a `synth_val.bin` of 200 pairs, mask recs for every
     key (so the 3D-mask branch runs) and procedural occluders, with their
     seconds and bytes. Then the loader alone at B = 128 (uint8,
     device_light): img/s over 5 batches after the first with the spawn
     pool and with threads, the pool's start, the first two batches of
     every worker count byte-equal to one worker's, masks in {0, 1} with
     some 0s, labels in range. Then `cli.train` on the rec (`dataset:
     webface`, the flagship config, bf16, B = 128, 10572 classes) for 30
     steps with a checkpoint every 10, asynchronous saves and
     `--tensorboard`: every loss finite, each kernel launched as
     per_step(30) says (as on synthetic data), the checkpoints that the
     cadence and keep-3 leave, each loading, the last equal to the final
     state; the pool's start, its Speed by window (saves and the epoch
     boundary marked) beside phase 6's synthetic Speed, and each save's
     host time on the loop beside its background write. Then a `--resume`
     to step 34, and a 4-step `dataset: custom` run whose verification
     decodes the 200 JPEG pairs through cv2;
  10. weights and the host sweep (within phase 6, on the folder the
     training CLI wrote, after 8): `tools.export_torch` writes its
     backbone.pth and `tools.export_frb` its frb.npz; `cli.train` for 5
     steps from each as `pretrained_backbone`, beside a fresh start:
     before step 1 the overlaid tensors equal the folder's bit for bit on
     the card and every other tensor a fresh init's, the log counts the
     tensors, launches per_step(5), first-step losses printed. Then
     `cli.test` without `--device-sweep` (PIL occlusion on the host, the
     eval forward on the card at `--batch-size` 25) over 200 PPM pairs,
     fill black, 1 repeat, protocols BB and NB: launches exactly 8
     `conv3x3_fwd` and 42 `prelu_fwd` per forward, the wall seconds split
     into forward, host PIL + numpy and metrics; over 20 pairs, protocol
     BB without occlusion, the card's saved features and rows against the
     port's own sweep on the CPU in float32 (`--weight` of the checkpoint
     with the config at fp16: false): the folder's bf16 by feature cosine >= 0.99, the card in
     float32 with TF32 off by cosine >= 0.9999 and each row's avg_acc
     within one pair; and `--weight backbone.pth --no-occ` against the
     first row of the folder's own sweep;
  11. int8 post-training quantization (within phase 6, on the folder the
     training CLI wrote, after 10): `csrc/qconv_int8.cu` is built in phase
     1 beside the others (it fails if a kernel there spills). The
     folder's int8 copy (`core/quantize.quantize_eval_model`, bf16): at each
     distinct int8 geometry of its 90 sites (89 convs and the fc; 68 with
     the output channels in the key) at B = 8, at a 7 x 1 conv on an odd
     input one element off, at the conv kernel's odd paths (transposed
     convs with odd ho and wo, Co = 18 and 33, a pixel tail of 105, the fc
     at B = 1 and 513; one line each with its plan: tile, phases, split K)
     and at the fc at B = 512, `quant_act` and `qconv_int8` bit-equal to
     their plain versions; `quant_act` on each route of its plan (the
     fc's flat row, clusters of 1 to 16 blocks in bf16, 16 in float32,
     and the two-pass route for a float32 sample over 16 blocks' shared
     memory), aligned and one element off, bit-equal, and the nodes of a
     captured call counted (one kernel on the cluster route, a memset and
     two kernels on the two-pass route); the B = 512 quantized eval forward (this
     slice's path, its launches counted alone: 90 of each int8 kernel
     and the 42 PReLUs)
     against the float bf16 forward, feature cosine >= 0.998 on the mean
     and >= 0.995 for each image (JAX's bound, 0.998 for the min over
     images at random init, is held after phase 4 on phase 3's model and
     images: its int8 copy against its bf16 forward, B = 512); 8 rows
     among zero rows and among other images bit-equal; the int8 and
     bf16 forwards' img/s; each distinct geometry at B = 512 on random
     inputs: both kernels bit-equal to their plain versions, then timed
     beside their bounds and cuDNN's bf16 op of the same shape, with the
     plans `qconv_int8` and `quant_act` launched (the kernels line's
     `quant_act` entry carries the route, K and the clusters resident of
     its site, and the graph nodes of each route);
     then `tools.export_serving --quant int8` (its bytes beside phase 8's
     float artifact), `cli.serve --quant int8` on the folder and the
     int8 artifact's server over HTTP (answers against `runner.infer`
     and each other, launches per forward), and `cli.test --device-sweep
     --quant int8` on phase 6's 40 pairs, rows beside the float sweep's;
  12. the peer-KD recipe (configs/arc18_msml_peer_dec.yaml: the frozen
     iResNet teacher on `ori`, the FM towers with the KD term, the recover
     decoder; after phase 5, its CLI within phase 6 after 11): (a) its
     train step at full width, B = 256, 93,431 classes, bf16, 20 steps on
     the host-float input the yaml runs, 3 with `device_light` (the augment
     kernel on img and on ori) and one with `decoder_loss_weight` 0.5 (the
     decoder runs, its weighted loss > 0): every metric finite, kd > 0,
     each kernel launched as the module sites say (counted from the
     modules: the student's PReLU pair and conv3x3 forward / dX / dW, the
     teacher's PReLU and conv3x3 forward only), the teacher's parameters
     and BN buffers bit-unchanged with no momentum buffer; img/s; (b) its
     float32 train forward (final_cls, final_seg, kd) on the card (TF32
     off) against the CPU at B = 4, relative error <= 1e-3; (e) its bf16
     eval forward at B = 512 in img/s beside phase 3's, launches counted;
     (c) `cli.train` on it from a procedural rec it writes (host-float
     batches with ori from spawned workers, 93,431 classes, B = 256) with
     `peer_weights` = phase 10's frb.npz of phase 6's folder: 4 steps, the
     teacher bit-equal to the npz, then a `--resume` to step 6; (d) on the
     folder it wrote, `cli.test --device-sweep` on phase 6's 40 pairs and
     the host sweep (BB, 1 repeat), launches per forward as the eval sites
     say, an /embed_batch of 16 through `cli.serve` against the live
     model, and `--quant int8` with its feature cosine to bf16.
  13. the LightCNN-29v2 gray recipe (configs/lightcnn_msml.yaml: 128 x
     128 x 1 without input normalization, the 1-channel U-Net OSB, four
     FMCnn [3, 2, tanh, add], Softmax; last): (a) the kernels at its
     shapes against their plain versions with phase 2's tolerances and
     timed beside their bounds (and cuDNN / `F.prelu`): `augment_batch`
     on gray uint8 at B = 256 (the train stage) and f32 at B = 512 (the
     sweep) with `use_norm` off, conv3x3 forward, dX and dW at its routed
     sites' 64^2, 32^2 and 8^2 at B = 256, the PReLU pair at its 15
     distinct shapes; (b) its bf16 eval forward at B = 512 (feature
     (B, 256), final_seg (B, 2, 128, 128)) in img/s, launches counted,
     against float32 on the card (TF32 off) and on the CPU; (c) its train
     step at B = 256 with webface's 10,572 classes on gray uint8
     `device_light` batches: 30 steps on one batch lower total_loss, each
     kernel launched as its 33 PReLU and 5 conv3x3 sites say, img/s, a
     profile, one float32 step against the CPU; (d) `cli.train` on the
     yaml (host-float batches, 20 steps, checkpoints), then on its folder
     `cli.test --device-sweep` and the host sweep over 40 gray pairs,
     `cli.serve` (/embed and /embed_batch against a direct forward),
     `tools.export_serving`, `--quant int8` (93 sites: every distinct
     geometry bit-equal to the plain kernels, the B = 512 forward's cosine
     to bf16) and a `use_ori` run with `peer_weights` = the folder's
     backbone.pth (the PeerLightCNN teacher bit-equal to it).
  14. the baselines of `cli.test --network` and IJB-B/C (last; (d) within
     phase 6): `.pth` files drawn from the seed with the reference's torch
     names for cosface2018 (Sphere-20, 112 x 96), from2021 (FROM, 112 x
     96), iresnet50_v and iresnet100_v. (a) cosface2018's, from2021's and
     iresnet100_v's float32 eval forwards (TF32 off), as `cli.test` builds
     them, at B = 512: PReLU and conv3x3 sites counted from the modules,
     launches exactly sites x forwards, img/s, the card against the CPU
     on 8 images (cosine >= 0.9999); (b) the float32 kernels at their
     shapes against their plain versions and timed beside their bounds
     and the library call: `conv3x3_fwd` at (512, 64, 56, 48) and (512, 64,
     112, 96) (cuDNN f32, TF32 off and on), `prelu_fwd` at every distinct
     PReLU shape of Sphere-20 and FROM (`F.prelu`), `augment_batch` on f32
     (512, 112, 96, 3); (c) `cli.test --network` cosface2018, from2021
     and iresnet50_v (the host sweep over 40 PPM pairs, 1 repeat), then
     cosface2018 with `--device-sweep` and with `--quant int8` (its int8
     sites bit-equal to the plain kernels, its features' cosine to
     float32), launches exactly sites x forwards; (d) `cli.eval_ijb` on
     phase 6's folder over an IJB root from the port's
     `make_synthetic_eval_fixtures` (20 ids, 120 crops), without occlusion
     and with `--lo 40 --hi 41` (10 repeats): TPR@FPR, the csv, npy and
     (with matplotlib) pdf artifacts, 2 forwards a batch of 128.

Exits non-zero, without the final line, when CUDA is missing or any check
fails. Needs no network or PyYAML; phase 9 needs Pillow and OpenCV.
"""

from __future__ import annotations

import argparse
import contextlib
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
SERVE_MAX_BATCH = 32    # cli.serve's default: buckets 1, 2, 4, ..., 32
SERVE_WINDOW_MS = 5.0   # cli.serve's default batching window
SERVE_MIN_COS = 0.999   # served bf16 features vs a B = 512 forward (cuDNN
                        # picks other algorithms at other batch sizes)
ARTIFACT_MIN_COS = 0.9999  # the exported program vs the live model
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

    from msml_torch.kernels import _nvcc, augment, conv3x3, qconv

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda lib: lib(), (conv3x3._lib, augment._lib,
                                          qconv._lib)))
    print(f"[1 build] csrc/conv3x3.cu, csrc/augment.cu and "
          f"csrc/qconv_int8.cu loaded in {time.perf_counter() - t0:.1f} s "
          "(built side by side)")
    spills = []
    for name in ("conv3x3", "augment", "qconv_int8"):
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
                m = re.search(r"\d(fwd_bf16|fwd_f32|dw_bf16|dw_f32|"
                              r"dw_reduce|augment_cluster|qconv|act_amax|"
                              r"act_cluster|act_quant)"
                              r"(?:I((?:L[ib]\d+E)+)E)?", line)
                args = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m \
                    else []
                kernel = (m.group(1) + (f"<{', '.join(args)}>" if args
                                        else "") if m else line)
            elif kernel and ("registers" in line or "spill" in line):
                print(f"[1 build]   {kernel}: {line.strip()}")
                if kernel.startswith(("fwd_bf16", "dw_bf16", "augment_cluster",
                                      "qconv", "act_")) and re.search(
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
    for bf16 in (True, False):
        print(f"[1 build]   act_cluster<{'bf16' if bf16 else 'f32'}>: "
              f"clusters of up to {qconv.cluster_cap(0, bf16)} blocks "
              f"placed at {qconv.SMEM_BLOCK} B a block")
    for what, (c, hw, dtype) in ACT_PLANS.items():
        bf16 = dtype == torch.bfloat16
        plan = qconv.quant_act_plan(B, c, hw, 2 if bf16 else 4,
                                    qconv.cluster_cap(0, bf16))
        clusters, per_sm = qconv.act_occupancy(bf16, plan.k, plan.smem)
        print(f"[1 build]   quant_act {what} at B = {B}: "
              f"{qconv.describe_act_plan(plan)} of "
              f"{qconv.ACT_THREADS} threads; {clusters} clusters at once "
              f"({per_sm} blocks a SM)")
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


def prelu_shapes(model, x: torch.Tensor) -> list:
    """(C, H, W) of every PReLU call in one eval forward of `model` on x."""
    from msml_torch.nn.common import PReLU

    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args: shapes.append(tuple(args[0].shape[1:])))
        for m in model.modules() if isinstance(m, PReLU)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def prelu_sites(seed: int):
    """(C, H, W) of every PReLU call in one arc18_msml forward."""
    return prelu_shapes(build_model(seed),
                        torch.zeros((2, 3, H, W), device="cuda"))


def check_prelu_shapes(gen, shapes, batch: int):
    """prelu_fwd / prelu_bwd against the plain versions at each (C, H, W)
    of `shapes` at `batch`, bf16 and f32: y and dx exactly equal, dalpha
    within DALPHA_TOL; -> (max abs errors of fwd and bwd, the worst dalpha
    relative error by dtype)."""
    from msml_torch.kernels.prelu import (prelu_bwd, prelu_bwd_reference,
                                          prelu_fwd, prelu_reference)

    errs = {"fwd": 0.0, "bwd": 0.0}
    worst_da = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c, h, w in shapes:
            x = torch.randn((batch, c, h, w), generator=gen,
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
    return errs, worst_da


def time_prelu(gen, shape, tag: str) -> dict:
    """prelu_fwd, prelu_bwd and both through autograd at `shape` (N, C, H,
    W), bf16 and f32: kernel, plain and `F.prelu` times beside the bound;
    -> {dtype: {part: (ms, plain_ms, library_ms, bound_ms)}}."""
    import torch.nn.functional as F

    from msml_torch.kernels.prelu import (_geometry, prelu, prelu_bwd,
                                          prelu_bwd_reference, prelu_fwd,
                                          prelu_reference)

    timed = {}
    c = shape[1]
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
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
            print(f"{tag} {str(dtype)[6:]} {part} at "
                  f"{tuple(shape)}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.prelu {lib_ms:.4f} ms{bound}")
    return timed


def phase_kernel_prelu(seed: int):
    """prelu_fwd / prelu_bwd against the plain versions at every distinct
    site shape, then timed at the largest site."""
    sites = prelu_sites(seed)
    if len(sites) != PRELU_SITES:
        fail(f"{len(sites)} PReLU sites in arc18_msml, expected "
             f"{PRELU_SITES}")
    shapes = sorted(set(sites), key=lambda s: -s[0] * s[1] * s[2])
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    errs, worst_da = check_prelu_shapes(gen, shapes, B_TRAIN)
    print(f"[2c prelu] {len(sites)} sites, {len(shapes)} distinct (C, H, W) "
          f"at B={B_TRAIN}, bf16 and f32: y and dx exactly equal to the "
          "plain version; dalpha relative L2 error "
          + ", ".join(f"{str(k)[6:]} {v:.2e}" for k, v in worst_da.items()))

    c, h, w = shapes[0]
    timed = time_prelu(gen, (B_TRAIN, c, h, w), "[2c prelu]")
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


def check_conv_shapes(gen, shapes, batch: int, tag: str) -> dict:
    """conv3x3_fwd (forward, and dX on flipped weights) and conv3x3_dw
    against the plain versions in f32 at each (C, H, W) of `shapes` at
    `batch`, bf16 and f32, within CONV_TOL, two runs bit-equal; -> the max
    abs errors of the forward and of dW."""
    from msml_torch.kernels.conv3x3 import (conv3x3_dw, conv3x3_dw_reference,
                                            conv3x3_fwd, conv3x3_reference,
                                            flip_weights)

    errs = {"fwd": 0.0, "dw": 0.0}
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol_y, tol_dw = CONV_TOL[dtype]
        for c, h, w in shapes:
            x = torch.randn((batch, c, h, w), generator=gen,
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
    print(f"{tag} {len(shapes)} site shapes at B={batch}, bf16 "
          "and f32, against the plain versions in f32: relative L2 error "
          + ", ".join(f"{d} {p} {v:.2e}" for (d, p), v in worst.items())
          + "; two forward and two dW runs bit-equal")
    return errs


def time_conv_sites(gen, shapes, batch: int, tag: str, plain_at=None):
    """The bf16 forward, dX and dW at each (C, H, W) of `shapes` at
    `batch`: the kernels, cuDNN (`F.conv2d`, `conv2d_input`,
    `conv2d_weight`) and, at `plain_at`, the plain versions, beside the
    bound; -> {"HxW": ({part: (ms, plain_ms, library_ms)}, bound_ms,
    bound_by)}."""
    from torch.nn.grad import conv2d_input, conv2d_weight
    import torch.nn.functional as F

    from msml_torch.kernels.conv3x3 import (conv3x3_dw, conv3x3_dw_reference,
                                            conv3x3_fwd, conv3x3_reference,
                                            flip_weights)

    dtype = torch.bfloat16
    sites = {}
    for c, h, w in shapes:
        x = torch.randn((batch, c, h, w), generator=gen,
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
            if (c, h, w) == plain_at else (lambda fn: None)
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
            print(f"{tag} bf16 {part} at {(batch, c, h, w)}: kernel "
                  f"{ms:.4f} ms"
                  + ("" if plain_ms is None else f", plain {plain_ms:.4f} ms")
                  + f", cuDNN {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {flops / 1e9:.1f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB) = {bound_ms / ms:.1%} of it")
        sites[f"{h}x{w}"] = (t, bound_ms, bound_by)
        del x, dy
    return sites


def phase_kernel_conv(seed: int):
    """conv3x3_fwd (forward and dX) and conv3x3_dw against the plain
    versions at the three site shapes and at odd and wide shapes, then the
    bf16 times at every site beside the bound and cuDNN."""
    from msml_torch.kernels.conv3x3 import (conv3x3_dw, conv3x3_dw_reference,
                                            conv3x3_fwd, conv3x3_reference,
                                            flip_weights)

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    errs = check_conv_shapes(gen, CONV_SHAPES, B_TRAIN, "[2d conv3x3]")
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

    sites = time_conv_sites(gen, CONV_SHAPES, B_TRAIN, "[2d conv3x3]",
                            plain_at=CONV_SHAPES[0])
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
    from msml_torch.core.precision import FULL_PRECISION, no_tf32
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

    with no_tf32():
        model32 = build_model(seed, policy=FULL_PRECISION)
        with torch.inference_mode():
            feat32, seg32 = model32(x[:64])
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


def synthetic_pairs(seed: int, pairs: int = 1200, size: int = H):
    """Same pairs: an image and the image + 3; different pairs: two
    independent images. Integer-valued float32 NHWC RGB in [0, 255],
    size x size."""
    rs = np.random.RandomState(seed)
    first = rs.randint(0, 256, (pairs, size, size, 3)).astype(np.float32)
    other = rs.randint(0, 256, (pairs, size, size, 3)).astype(np.float32)
    issame = [p % 2 == 0 for p in range(pairs)]
    second = np.where(np.asarray(issame)[:, None, None, None],
                      np.clip(first + 3, 0, 255), other)
    data = np.stack([first, second], 1).reshape(2 * pairs, size, size, 3)
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
    want = expect(augment_batch=batches, prelu_fwd=batches * PRELU_SITES,
                  conv3x3_fwd=batches * CONV_SITES)
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
    from msml_torch.kernels import augment, conv3x3, prelu, qconv

    return (augment.augment_batch, prelu.prelu_fwd, prelu.prelu_bwd,
            conv3x3.conv3x3_fwd, conv3x3.conv3x3_dw, qconv.quant_act,
            qconv.qconv_int8)


def expect(**launches) -> dict:
    """Launch counts by kernel: the given ones, 0 for every other."""
    return {**{fn.__name__: 0 for fn in counted()}, **launches}


def reset_launches():
    for fn in counted():
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in counted()}


def per_step(steps: int, prelu: int = PRELU_SITES, conv: int = CONV_SITES,
             augment: int = 1) -> dict:
    """Launches of `steps` train steps: `augment` input stages, the PReLU
    pair at every PReLU site, forward and dX at every conv site, dW at
    each."""
    return expect(augment_batch=steps * augment, prelu_fwd=steps * prelu,
                  prelu_bwd=steps * prelu, conv3x3_fwd=steps * 2 * conv,
                  conv3x3_dw=steps * conv)


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


def profile_train(run_step, step_ms: float, steps: int = 4,
                  tag: str = "[5 train]"):
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
        print(f"{tag} profile: no device time in the trace (not "
              "measured)")
        return
    per_step = busy_us / steps / 1e3
    print(f"{tag} profile, {steps} steps: device busy {per_step:.2f} ms "
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
    print(f"{tag} profile by group (ms per step, share of device "
          "time): " + "; ".join(f"{g} {v / steps / 1e3:.2f} "
                                f"({v / busy_us:.1%})"
                                for g, v in shares.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"{tag}   {e.self_device_time_total / steps / 1e3:8.3f} ms"
              f"  x{e.count // steps:<4d} {e.key[:100]}")


def phase_train_cpu_parity(seed: int, b: int = 4):
    """One float32 step (TF32 off) on the card against the CPU, from the
    same weights, batch and relight draws."""
    train_cpu_parity(arc18_config(batch_size=b), seed, b, "[5 train]")


def train_cpu_parity(cfg, seed: int, b: int, tag: str):
    """One float32 step (TF32 off) of `cfg`'s model and step on the card
    against the CPU, from the same weights, batch and relight draws:
    metrics rtol 1e-3, the updates relative L2 error <= 1e-2."""
    from msml_torch.core.precision import FULL_PRECISION, no_tf32
    from msml_torch.data.synthetic import synthetic_batch
    from msml_torch.nn.msml import msml_from_config
    from msml_torch.train.train_step import init_train_state, make_train_step

    batch = synthetic_batch(b, size=cfg.out_size[0],
                            channels=1 if cfg.is_gray else 3,
                            num_classes=cfg.num_classes, seed=seed + 4,
                            uint8=True)
    draws = torch.rand((b, 3), generator=torch.Generator().manual_seed(seed))
    with no_tf32():
        out = {}
        for dev in ("cuda", "cpu"):
            model = msml_from_config(cfg, policy=FULL_PRECISION, device=dev,
                                     seed=seed, head=True)
            state = init_train_state(model, cfg, dev, seed)
            names = {p: n for n, p in model.named_parameters()}
            m = make_train_step(cfg)(state, batch, 1.0,
                                     light_draws=draws.to(dev))
            upd = {names[p]: (state.optimizer.state[p]["momentum_buffer"]
                              * g["lr"]).double().cpu()
                   for g in state.optimizer.param_groups
                   for p in g["params"]}
            out[dev] = ({k: v.item() for k, v in m.items()}, upd)
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
    print(f"{tag} card f32 (TF32 off) vs CPU f32, one step at B={b}: "
          "metrics " + ", ".join(f"{k} {mg[k]:.6f}/{mc[k]:.6f}" for k in mc)
          + f"; update relative L2 error {err:.2e} (worst tensor {worst} "
          f"{((ug[worst] - uc[worst]).norm() / uc[worst].norm()).item():.2e})")


def phase_cli(seed: int, smi: str, peer_sites: dict, steps: int = 20,
              resume_to: int = 24):
    """The training CLI on the card, then the sweep, the serving surface,
    the weights and the int8 quantization on the folder it wrote, then the
    peer-KD recipe's CLI with that folder's frb.npz as its teacher; ->
    (launches, img/s of its Speed lines, the sweep's launches, the server's
    launches and kernel errors, the host sweep's launches, phase 11's
    results, phase 12's CLI launches, phase 14 (d)'s launches)."""
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
        save_ab(seed, smi, cfg)
        state = main(parse_args(argv[2:] + ["--steps", str(resume_to),
                                            "--resume"]), cfg(out))
        with open(os.path.join(output, "training.log")) as f:
            resumed = f"backbone resume successfully! step={steps}" in f.read()
        if not resumed or state.step != resume_to:
            fail(f"cli --resume: resumed {resumed}, step {state.step}")
        print(f"[6 cli] --resume from step {steps} ran to step {state.step}; "
              f"checkpoints {all_steps(output)}")
        sweep_launches, sweep_rows = cli_sweep(seed, state, output, out)
        del state
        serve_launches, serve_errs = cli_serve(seed, output, out, smi)
        pth = cli_weights(seed, output, out, smi)
        host_launches = cli_host_sweep(seed, output, out, smi, pth)
        quant = cli_quant(seed, output, out, smi, sweep_rows)
        peer = peer_cli(seed, smi, peer_sites, os.path.join(out, "frb.npz"),
                        os.path.join(out, "pairs.bin"), out)
        ijb = cli_ijb(seed, output, out, smi)
    return (launches, speeds, sweep_launches, serve_launches, serve_errs,
            host_launches, quant, peer, ijb)


def save_ab(seed: int, smi: str, cfg, steps: int = 30):
    """Phase 6's synthetic CLI run with blocking (`--sync-ckpt`) and
    asynchronous saves, one run each (S A): each run's Speed by window
    end (the saves at 10 and 20 fall in the windows that end at 15 and 25),
    its saves' seconds on the loop, and its steps 6..30 in seconds (the sum
    of its windows)."""
    from msml_torch.cli.train import main, parse_args

    loop = {True: [], False: []}
    for sync in (True, False):
        with tempfile.TemporaryDirectory() as out:
            main(parse_args(["--steps", str(steps), "--ckpt-every", "10",
                             "--log-every", "5", "--seed", str(seed),
                             "--device", "cuda"]
                            + (["--sync-ckpt"] if sync else [])), cfg(out))
            with open(os.path.join(out, "arc18_msml_1",
                                   "training.log")) as f:
                log = f.read()
        speeds = speed_lines(log)
        if len(speeds) != steps // 5 - 1:
            fail(f"cli {'sync' if sync else 'async'}: Speed lines {speeds}")
        seconds = sum(5 * B_TRAIN / v for v in speeds.values())
        loop[sync].append(seconds)
        print(f"[6 cli] {smi}: {'blocking' if sync else 'async'} saves, "
              f"{steps} steps: Speed (samples/s) by window end "
              + ", ".join(f"{st}: {v:.2f}" for st, v in sorted(
                  speeds.items()))
              + "; save on the loop " + ", ".join(
                  f"{st}: {v:.3f} s" for st, v in sorted(
                      save_seconds(log).items()))
              + f"; steps 6..{steps} in {seconds:.3f} s")
    print(f"[6 cli] {smi}: steps 6..{steps} with blocking saves "
          f"{[round(v, 3) for v in loop[True]]} s, with async saves "
          f"{[round(v, 3) for v in loop[False]]} s")


def cli_sweep(seed: int, state, folder: str, scratch: str, pairs: int = 40):
    """The train-then-sweep round trip on the folder the training CLI
    wrote; -> (the sweep's launch counts, its rows)."""
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
    want_launches = expect(augment_batch=batches,
                           prelu_fwd=batches * PRELU_SITES,
                           conv3x3_fwd=batches * CONV_SITES)
    if len(rows) != 10 or launches != want_launches or not all(
            math.isfinite(r["avg_acc"]) for r in rows):
        fail(f"cli sweep: {len(rows)} rows, launches {launches}")
    print(f"[6 cli] cli.test --device-sweep on the trained folder "
          f"({os.path.relpath(weights_path(folder), folder)}), {pairs} PPM "
          f"pairs: loaded vs trained features min cosine {cos:.8f} "
          f"(max abs diff {(got - want).abs().max().item():.3g}); avg_acc "
          + ", ".join(f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows)
          + f"; launches {launches}")
    return launches, rows


HOST_PAIRS = 200        # the host sweep's .bin on the card
REF_PAIRS = 20          # the card-vs-CPU comparison (10 folds of 2 pairs)
HOST_BATCH = 25         # cli.test's --batch-size default


def record_first_step():
    """Patch the training CLI's step so that its first call records the
    model's weights before it runs, and its total_loss; -> (the record,
    a function that undoes the patch)."""
    from msml_torch.train import train_step

    seen = {}
    make = train_step.make_train_step

    def recording(cfg):
        step = make(cfg)

        def wrapped(state, *args, **kwargs):
            first = not seen
            if first:
                seen["weights"] = {k: v.clone() for k, v in
                                   state.model.state_dict().items()}
            metrics = step(state, *args, **kwargs)
            if first:
                seen["loss"] = metrics["total_loss"].item()
            return metrics
        return wrapped

    train_step.make_train_step = recording
    return seen, lambda: setattr(train_step, "make_train_step", make)


def cli_weights(seed: int, folder: str, scratch: str, smi: str,
                steps: int = 5) -> str:
    """Phase 10 (a, b): export the trained folder as backbone.pth and
    frb.npz, then `cli.train` from each as `pretrained_backbone`, beside a
    fresh start; -> the backbone.pth path."""
    from msml_torch.cli.train import main, parse_args
    from msml_torch.core.config import Config
    from msml_torch.core.weight_folder import read_state_dict, weights_path
    from msml_torch.tools import export_frb, export_torch
    from msml_torch.tools.load_weights import group

    t0 = time.perf_counter()
    pth = export_torch.main(export_torch.parse_args(
        ["--weight_folder", folder, "--out",
         os.path.join(scratch, "backbone.pth")]))
    t1 = time.perf_counter()
    npz = export_frb.main(export_frb.parse_args(
        ["--weight_folder", folder, "--out", os.path.join(scratch, "frb")]))
    t2 = time.perf_counter()
    print(f"[10 weights] tools.export_torch: {os.path.getsize(pth):,} B in "
          f"{t1 - t0:.2f} s; tools.export_frb: {os.path.getsize(npz):,} B "
          f"in {t2 - t1:.2f} s (from "
          f"{os.path.relpath(weights_path(folder), folder)})")
    donor = {k: v.to("cuda") for k, v in read_state_dict(
        weights_path(folder)).items()}

    def overlaid(key, trunk_only):
        g = group(key)
        return (g is not None and (g == "frb" or not trunk_only)
                and key != "frb.features.weight"
                and not key.endswith("num_batches_tracked"))

    runs = {}
    for name, path in (("fresh", ""), ("backbone.pth", pth),
                       ("frb.npz", npz)):
        seen, undo = record_first_step()
        out = os.path.join(scratch, "pretrained_" + name.replace(".", "_"))
        cfg = Config.from_dict(dict(ARC18_MSML, dataset="synthetic",
                                    num_classes=10572, out_folder=out,
                                    pretrained_backbone=path))
        reset_launches()
        try:
            state = main(parse_args(["--steps", str(steps), "--log-every",
                                     "5", "--seed", str(seed), "--device",
                                     "cuda"]), cfg)
        finally:
            undo()
        torch.cuda.synchronize()
        launches = read_launches()
        del state
        with open(os.path.join(out, "arc18_msml_1", "training.log")) as f:
            counts = re.findall(r"loaded (\d+) pretrained backbone tensors",
                                f.read())
        if launches != per_step(steps) or len(counts) != bool(path):
            fail(f"cli from {name}: launches {launches}, expected "
                 f"{per_step(steps)}; logged counts {counts}")
        runs[name] = (seen, counts)
    fresh = runs["fresh"][0]["weights"]
    for name in ("backbone.pth", "frb.npz"):
        got = runs[name][0]["weights"]
        keys = [k for k in got if overlaid(k, name == "frb.npz")]
        bad = [k for k in got if not torch.equal(
            got[k], donor[k] if k in keys else fresh[k])]
        if bad or not keys:
            fail(f"cli from {name}: {len(bad)} tensors differ before step "
                 f"1 (first: {bad[:3]}), {len(keys)} overlaid")
        print(f"[10 weights] cli.train from {name} (pretrained_backbone, "
              f"{steps} steps, bf16, B={B_TRAIN}): before step 1 "
              f"{len(keys)} of {len(got)} tensors equal the trained "
              f"folder's bit for bit on the card and the other "
              f"{len(got) - len(keys)} a fresh init's; log: loaded "
              f"{runs[name][1][0]} pretrained backbone tensors; launches "
              f"per_step({steps}); first-step total_loss "
              f"{runs[name][0]['loss']:.4f} (fresh start "
              f"{runs['fresh'][0]['loss']:.4f})")
    return pth


def pair_bin(path: str, seed: int, pairs: int, size: int = H) -> str:
    """`pairs` synthetic pairs as a .bin of binary PPM images."""
    import pickle

    from msml_torch.data.bin_loader import ppm_encode

    data, issame = synthetic_pairs(seed, pairs, size)
    with open(path, "wb") as f:
        pickle.dump(([ppm_encode(a.astype(np.uint8)) for a in data[0]],
                     issame), f)
    return path


def host_sweep(argv) -> tuple:
    """`cli.test` (the host sweep) quietly; -> (rows, launches, seconds:
    wall, forward, metrics)."""
    import io

    from msml_torch.cli import serve
    from msml_torch.cli import test as cli_test
    from msml_torch.eval import occ_sweep, verification

    spent = {"forward": 0.0, "metrics": 0.0}

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return call

    patched = [(serve, "numpy_forward"), (verification, "evaluate"),
               (occ_sweep, "roc_acc_and_tarfar")]
    saved = [getattr(m, n) for m, n in patched]
    serve.numpy_forward = lambda module, device: timed(
        saved[0](module, device), "forward")
    verification.evaluate = timed(saved[1], "metrics")
    occ_sweep.roc_acc_and_tarfar = timed(saved[2], "metrics")
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rows = cli_test.main(cli_test.parse_args(argv))
    finally:
        for (m, n), fn in zip(patched, saved):
            setattr(m, n, fn)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    spent["wall"] = time.perf_counter() - t0
    return rows, read_launches(), spent


def pairs_apart(acc_diff: float) -> float:
    """An avg_acc difference of the REF_PAIRS sweep in pairs (a mean over
    folds of 1/REF_PAIRS steps, rounded off its float error)."""
    return round(acc_diff * REF_PAIRS, 6)


def features_of(path: str) -> dict:
    return {n: np.load(os.path.join(path, n)) for n in sorted(
        os.listdir(path))}


def cli_host_sweep(seed: int, folder: str, scratch: str, smi: str,
                   pth: str) -> dict:
    """Phase 10 (c): `cli.test` without `--device-sweep`, protocols BB and
    NB, on the card; held against the port's sweep on the CPU in float32;
    `--weight backbone.pth` against the folder; -> the BB sweep's
    launches."""
    from msml_torch.core.precision import no_tf32
    from msml_torch.core.weight_folder import weights_path

    big = pair_bin(os.path.join(scratch, "host.bin"), seed, HOST_PAIRS)
    small = pair_bin(os.path.join(scratch, "ref.bin"), seed, REF_PAIRS)
    common = ["--fill_type", "black", "--repeats", "1"]
    forwards = 2 * 10 * math.ceil(2 * HOST_PAIRS / HOST_BATCH)
    want = expect(prelu_fwd=forwards * PRELU_SITES,
                  conv3x3_fwd=forwards * CONV_SITES)
    launches = {}
    for protocol in ("BB", "NB"):
        rows, launches[protocol], s = host_sweep(
            ["--weight_folder", folder, "--bin", big, "--protocol",
             protocol, "--device", "cuda"] + common)
        if launches[protocol] != want or len(rows) != 10 or not all(
                math.isfinite(v) for r in rows for v in (
                    r["avg_acc"], r["roc_acc"], *r["tar_at_far"])):
            fail(f"host sweep {protocol}: {len(rows)} rows, launches "
                 f"{launches[protocol]}, expected {want}")
        images = 2 * 10 * 2 * HOST_PAIRS
        host = s["wall"] - s["forward"] - s["metrics"]
        print(f"[10 host sweep] {smi}: cli.test protocol {protocol}, fill "
              f"black, 1 repeat, {HOST_PAIRS} PPM pairs, --batch-size "
              f"{HOST_BATCH}: {s['wall']:.2f} s wall for {images} images "
              f"({images / s['wall']:.1f} img/s; forward alone "
              f"{images / s['forward']:.1f} img/s): forward "
              f"{s['forward']:.2f} s ({forwards} calls, "
              f"{s['forward'] / forwards * 1e3:.2f} ms each), host PIL + "
              f"numpy {host:.2f} s, metrics {s['metrics']:.2f} s; avg_acc "
              + ", ".join(f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows)
              + f"; launches {launches[protocol]}")

    # the card against the port on the CPU in float32: the same sweep, seed
    # and pairs. The card runs the folder's bf16, held by feature cosine
    # (its rows are printed: a 10-fold threshold on folds of 2 pairs flips
    # whole pairs for a 1e-4 change of a distance), and float32 with TF32
    # off, held by rows within one pair. The float32 runs read the
    # checkpoint through --weight with the folder's config at fp16: false.
    f32 = os.path.join(scratch, "f32_config")
    os.makedirs(f32, exist_ok=True)
    with open(os.path.join(folder, "config.yaml")) as f:
        raw = json.load(f)
    with open(os.path.join(f32, "config.yaml"), "w") as f:
        json.dump(dict(raw, fp16=False), f)
    as_f32 = ["--weight_folder", f32, "--weight", weights_path(folder)]
    card_bb = None
    # protocol BB without occlusion: the CPU's float32 forward is what
    # takes the time
    for protocol in ("BB",):
        got = {}
        for where, argv in (
                ("bf16", ["--weight_folder", folder, "--device", "cuda"]),
                ("f32", as_f32 + ["--device", "cuda"]),
                ("cpu", as_f32 + ["--device", "cpu"])):
            feats = os.path.join(scratch, f"feats_{protocol}_{where}")
            with (no_tf32() if where == "f32"
                  else contextlib.nullcontext()):
                rows, _, s = host_sweep(argv + [
                    "--bin", small, "--protocol", protocol, "--no-occ",
                    "--save-features", feats] + common)
            got[where] = (rows, features_of(feats), s["wall"])
        ref_rows, ref_feats, cpu_s = got["cpu"]
        cos, apart = {}, {}
        for where in ("bf16", "f32"):
            rows, feats, _ = got[where]
            if feats.keys() != ref_feats.keys() or len(feats) != 1:
                fail(f"host sweep {protocol} {where}: feature files "
                     f"{sorted(feats)} vs {sorted(ref_feats)}")
            cos[where] = min(cosines(torch.from_numpy(feats[n]),
                                     torch.from_numpy(ref_feats[n])).min()
                             .item() for n in feats)
            apart[where] = max(pairs_apart(abs(a["avg_acc"] - b["avg_acc"]))
                               for a, b in zip(rows, ref_rows))
        if not (cos["bf16"] >= BF16_MIN_COS and cos["f32"] >= CPU_MIN_COS
                and apart["f32"] <= 1):
            fail(f"host sweep {protocol} vs the CPU in float32: min feature "
                 f"cosine {cos} (bf16 >= {BF16_MIN_COS}, f32 >= "
                 f"{CPU_MIN_COS}), rows apart by {apart} pairs (f32 <= 1)")
        if protocol == "BB":
            card_bb = got["bf16"][:2]
        print(f"[10 host sweep] protocol {protocol} without occlusion, "
              f"{REF_PAIRS} pairs, the "
              f"port on the CPU in float32 ({cpu_s:.1f} s) vs the card, same "
              f"seed: bf16 ({got['bf16'][2]:.1f} s) min feature cosine "
              f"{cos['bf16']:.6f} (>= {BF16_MIN_COS}), rows up to "
              f"{apart['bf16']:g} pairs apart; float32, TF32 off "
              f"({got['f32'][2]:.1f} s) min cosine {cos['f32']:.8f} (>= "
              f"{CPU_MIN_COS}), rows up to {apart['f32']:g} pairs apart (<= "
              f"1); avg_acc CPU "
              + ", ".join(f"{r['avg_acc']:.3f}" for r in ref_rows)
              + "; card bf16 "
              + ", ".join(f"{r['avg_acc']:.3f}" for r in got["bf16"][0])
              + "; card f32 "
              + ", ".join(f"{r['avg_acc']:.3f}" for r in got["f32"][0]))

    # --weight backbone.pth (config.yaml only from the folder) against the
    # folder's own checkpoint, on the card: without occlusion, the draws
    # and images of the BB sweep's first row
    weight_feats = os.path.join(scratch, "feats_weight")
    rows, _, _ = host_sweep(["--weight_folder", folder, "--weight", pth,
                             "--bin", small, "--device", "cuda", "--no-occ",
                             "--save-features", weight_feats] + common)
    got, want = features_of(weight_feats), card_bb[1]
    diff = max(np.abs(got[n] - want[n]).max() for n in got)
    acc = abs(rows[0]["avg_acc"] - card_bb[0][0]["avg_acc"])
    if list(got) != ["feat_lo0_rep0.npy"] or not pairs_apart(acc) <= 1:
        fail(f"host sweep --weight backbone.pth vs the folder: avg_acc diff "
             f"{acc}, feature files {sorted(got)}")
    same = "equal" if rows[0] == card_bb[0][0] else "differs"
    print(f"[10 host sweep] --weight backbone.pth (config.yaml from the "
          f"folder) vs the folder's checkpoint, no occlusion, {REF_PAIRS} "
          f"pairs, on the card: row {same} (avg_acc diff {acc:.4f}), max "
          f"abs feature diff {diff:.3g}")
    return launches["BB"]


REC_IDS, REC_VIEWS = 200, 12  # 200 x (12 - 2 held out) = 2000 train images
REC_PAIRS = 200


def write_mask_recs(root: str):
    """mask_out.rec / mask.rec for every key of {root}/train.rec: the face
    with its lower half painted over, and that mask (tests/
    test_face_dataset.py builds them so), so the 3D-mask branch runs."""
    from msml_torch.data.recordio import (IRHeader, IndexedRecordIO,
                                          imdecode, imencode, pack, unpack)

    src = IndexedRecordIO(os.path.join(root, "train.idx"),
                          os.path.join(root, "train.rec"))
    out = {n: IndexedRecordIO(os.path.join(root, f"{n}.idx"),
                              os.path.join(root, f"{n}.rec"), "w")
           for n in ("mask_out", "mask")}
    m = np.full((H, W, 3), 255, np.uint8)
    m[60:, :] = 0
    mask_bytes = imencode(m)
    for key in src.keys[1:]:  # key 0 is the header record
        header, img_bytes = unpack(src.read_idx(key))
        masked = imdecode(img_bytes).copy()
        masked[60:, :] = 30
        out["mask_out"].write_idx(key, pack(IRHeader(0, header.label, 0, 0),
                                            imencode(masked)))
        out["mask"].write_idx(key, pack(IRHeader(0, 0.0, 0, 0), mask_bytes))
    src.close()
    for w in out.values():
        w.close()


LOADER_BATCHES = 5      # phase 9: loader-alone img/s over these batches


def loader_batches(ds, use_processes: bool,
                   batches: int = LOADER_BATCHES):
    """-> (the first two batches of epoch 0, seconds to the first batch,
    img/s over `batches` batches after the first)."""
    t0 = time.perf_counter()
    it = ds.epoch(0, use_processes=use_processes)
    first = [next(it)]
    t1 = time.perf_counter()
    for i in range(batches):
        b = next(it)
        if i == 0:
            first.append(b)
    t2 = time.perf_counter()
    it.close()
    return first, t1 - t0, batches * ds.batch_size / (t2 - t1)


def same_batches(a, b) -> bool:
    return len(a) == len(b) and all(
        sorted(x) == sorted(y) and all(x[k].tobytes() == y[k].tobytes()
                                       for k in x) for x, y in zip(a, b))


def save_seconds(log: str) -> dict:
    """The training log's saves: {step: seconds on the loop's thread}."""
    return {int(st): float(v) for st, v in re.findall(
        r"checkpoint (?:at|saved at) step (\d+)(?: \(epoch \d+\))? "
        r"\((\S+) s on the loop\)", log)}


def speed_lines(log: str) -> dict:
    """The training log's Speed lines: {step: samples/s}."""
    return {int(st): float(v) for v, st in re.findall(
        r"Speed (\S+) samples/sec .* Global Step: (\d+) ", log)}


def phase_data(seed: int, smi: str, synthetic_speeds, steps: int = 30,
               resume_to: int = 34):
    """The training CLI fed from a RecordIO rec with online occlusion;
    -> the launches of its `steps` steps."""
    try:
        import cv2
        import PIL
    except ImportError as e:
        fail(f"the RecordIO data path needs Pillow and OpenCV: {e}")
    from msml_torch.cli.train import main, parse_args
    from msml_torch.core.checkpoint import all_steps, checkpoint_path
    from msml_torch.core.config import Config
    from msml_torch.data.face_dataset import FaceByRandOccMask
    from msml_torch.tools.make_occluders import main as make_occluders
    from msml_torch.tools.make_synthetic_rec import write_dataset

    cpus = os.cpu_count() or 1
    nw = min(32, cpus)
    print(f"[9 data] Pillow {PIL.__version__}, OpenCV {cv2.__version__}; "
          f"os.cpu_count() {cpus}; the loader alone runs nw = min(32, "
          f"{cpus}) = {nw} workers, the CLI webface's cfg.nw = 32")
    with tempfile.TemporaryDirectory() as tmp:
        root, occl = os.path.join(tmp, "rec"), os.path.join(tmp, "occ")
        t0 = time.perf_counter()
        write_dataset(root, ids=REC_IDS, per_id=REC_VIEWS, size=H,
                      val_pairs=REC_PAIRS, seed=seed, quality=80,
                      log_every=0)
        write_mask_recs(root)
        make_occluders(occl, num=8, seed=seed)
        sizes = {n: os.path.getsize(os.path.join(root, n))
                 for n in sorted(os.listdir(root)) if n.endswith(
                     (".rec", ".bin"))}
        print(f"[9 data] wrote {REC_IDS} ids x {REC_VIEWS} views "
              f"({REC_IDS * (REC_VIEWS - 2)} train images, 112x112 JPEG q80, "
              f"{REC_PAIRS} val pairs), mask recs and 5 x 8 occluder PNGs "
              f"in {time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{n} {v:,} B" for n, v in sizes.items()))

        def dataset(workers):
            return FaceByRandOccMask(
                root_dir=root, batch_size=B_TRAIN, use_norm=True,
                use_ori=False, occluder_root=occl, num_workers=workers,
                seed=seed, raw_uint8=True)

        t_loader = time.perf_counter()
        one, _, _ = loader_batches(dataset(1), False, batches=1)
        for label, procs in (("processes", True), ("threads", False)):
            ds = dataset(nw)
            try:
                first, start_s, rate = loader_batches(ds, procs)
            finally:
                ds.close()
            if not same_batches(first, one):
                fail(f"loader: the first two batches of {nw} {label} "
                     "differ from one worker's")
            print(f"[9 data] loader alone, {nw} {label}, B={B_TRAIN}: "
                  f"{rate:.1f} img/s over {LOADER_BATCHES} batches after the "
                  "first; first "
                  f"batch after {start_s:.2f} s"
                  + (f" (~{start_s - B_TRAIN / rate:.2f} s of it starting "
                     "the spawn pool)" if procs else "")
                  + "; first two batches byte-equal to one worker's")
        msk = np.concatenate([b["msk"] for b in one])
        labels = np.concatenate([b["label"] for b in one])
        if not (set(np.unique(msk)) <= {0, 1} and (msk == 0).any()
                and ((labels >= 0) & (labels < REC_IDS)).all()):
            fail(f"loader: masks {np.unique(msk)}, labels {labels.min()}.."
                 f"{labels.max()}")
        print(f"[9 data] masks in {{0, 1}}, {np.mean(msk == 0):.1%} of "
              f"pixels occluded; labels {labels.min()}..{labels.max()} of "
              f"{REC_IDS} ids; the loader runs "
              f"{time.perf_counter() - t_loader:.1f} s host clock")

        out = os.path.join(tmp, "out")

        def rec_cfg():
            return Config.from_dict(dict(ARC18_MSML, rec=root,
                                         occluder_root=occl, out_folder=out))

        argv = ["--steps", str(steps), "--ckpt-every", "10", "--log-every",
                "5", "--seed", str(seed), "--device", "cuda",
                "--tensorboard"]
        reset_launches()
        t0 = time.perf_counter()
        state = main(parse_args(argv), rec_cfg())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        output = os.path.join(out, "arc18_msml_1")
        with open(os.path.join(output, "training.log")) as f:
            log = f.read()
        losses = [float(v) for v in re.findall(r" Loss (\S+) ", log)]
        speeds = speed_lines(log)
        on_loop = save_seconds(log)
        pool_s = re.findall(r"worker processes \(started in (\S+) s\)", log)
        written = {int(st): float(v) for st, v in re.findall(
            r"checkpoint (\d+) written in the background in (\S+) s", log)}
        per_epoch = REC_IDS * (REC_VIEWS - 2) // B_TRAIN
        saved = sorted({s for s in range(10, steps + 1, 10)}
                       | set(range(per_epoch, steps + 1, per_epoch)))
        if state.step != steps or launches != per_step(steps):
            fail(f"cli rec: step {state.step}, launches {launches}, "
                 f"expected {steps} and {per_step(steps)}")
        if not (speeds and losses and pool_s
                and all(map(math.isfinite, losses))):
            fail(f"cli rec: Speed lines {speeds}, logged losses {losses}, "
                 f"pool start {pool_s}")
        if all_steps(output) != saved[-3:] or sorted(written) != saved:
            fail(f"cli rec: checkpoints {all_steps(output)}, written in the "
                 f"background {sorted(written)}, expected {saved}")
        for st in all_steps(output):
            ck = torch.load(checkpoint_path(output, st), map_location="cpu",
                            weights_only=True)
            if ck["step"] != st or sorted(ck) != [
                    "generator", "model", "optimizer", "step"]:
                fail(f"cli rec: checkpoint {st} holds step {ck['step']}")
        final = {k: v.cpu() for k, v in state.model.state_dict().items()}
        if any(not torch.equal(ck["model"][k], v) for k, v in final.items()):
            fail(f"cli rec: checkpoint {steps} differs from the final state")
        tb = os.path.join(output, "tb")
        events = [n for n in (os.listdir(tb) if os.path.isdir(tb) else [])
                  if n.startswith("events.out.tfevents")]
        print(f"[9 data] {smi}: cli.train on the rec (dataset webface, "
              f"arc18_msml bf16, B={B_TRAIN}, 10572 classes, cfg.nw 32 "
              f"spawned workers, started in {pool_s[0]} s), {steps} steps "
              f"({per_epoch} an epoch) in "
              f"{seconds:.1f} s host clock (model build, pool start and "
              f"checkpoints included); logged losses "
              f"{[round(v, 4) for v in losses]}; launches {launches} = "
              f"per_step({steps}), as on synthetic data")
        print(f"[9 data] {smi}: Speed (samples/s) on the rec by window end "
              + ", ".join(
                  f"{st}: {v:.2f}" + "".join(
                      f" (save at {c})" for c in saved if st - 5 <= c < st)
                  + "".join(" (epoch boundary)" for m in range(
                      per_epoch, steps, per_epoch) if st - 5 <= m < st)
                  for st, v in sorted(speeds.items()))
              + f"; phase 6's synthetic Speed {synthetic_speeds}")
        print(f"[9 data] checkpoints {saved} (kept {all_steps(output)}, "
              "each loads; the last equals the final state): save on the "
              "loop's thread " + ", ".join(
                  f"{st}: {v:.3f} s" for st, v in sorted(on_loop.items()))
              + "; the background write " + ", ".join(
                  f"{st}: {v:.3f} s" for st, v in sorted(written.items()))
              + "; tensorboard: " + (
                  f"{len(events)} events file in {tb}" if events
                  else "no events file (torch.utils.tensorboard "
                  "unavailable, the writer warned)"))
        del state
        t0 = time.perf_counter()
        state = main(parse_args(argv[2:-1] + ["--steps", str(resume_to),
                                              "--resume"]), rec_cfg())
        with open(os.path.join(output, "training.log")) as f:
            resumed = f"backbone resume successfully! step={steps}" in f.read()
        if not resumed or state.step != resume_to:
            fail(f"cli rec --resume: resumed {resumed}, step {state.step}")
        print(f"[9 data] --resume from the async checkpoint {steps} ran to "
              f"step {state.step}; checkpoints {all_steps(output)}; "
              f"{time.perf_counter() - t0:.1f} s host clock")
        del state
        t0 = time.perf_counter()

        # the rec as `dataset: custom`, whose verification decodes the
        # synth_val pairs through cv2
        state = main(parse_args(["--steps", "4", "--ver-every", "4",
                                 "--seed", str(seed), "--device", "cuda"]),
                     Config.from_dict(dict(
                         ARC18_MSML, dataset="custom", num_classes=10572,
                         nw=nw, rec=root, occluder_root=occl,
                         val_targets=["synth_val"],
                         out_folder=os.path.join(tmp, "custom"))))
        if state.step != 4:
            fail(f"cli custom: step {state.step}, not 4")
        del state
        with open(os.path.join(tmp, "custom", "arc18_msml_1",
                               "training.log")) as f:
            acc = re.findall(r"\[synth_val\]\[4\]Accuracy-Flip: "
                             r"(\S+)\+-(\S+)", f.read())
        if len(acc) != 1 or not 0 <= float(acc[0][0]) <= 1:
            fail(f"cli custom: accuracy {acc}")
        print(f"[9 data] dataset custom ({nw} workers), 4 steps, "
              f"verification on synth_val.bin ({REC_PAIRS} JPEG pairs "
              f"decoded by cv2): Accuracy-Flip {acc[0][0]}+-{acc[0][1]}; "
              f"{time.perf_counter() - t0:.1f} s host clock")
    torch.cuda.empty_cache()
    return launches


def post(url: str, body: bytes, timeout: float = 300.0):
    """POST `body`; -> (seconds on the host clock, the JSON answer)."""
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.loads(r.read())
    return time.perf_counter() - t0, out


def get(url: str, timeout: float = 60.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def npy_bytes(x: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def percentile_ms(seconds, q: float) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def start_server(runner, max_batch: int = SERVE_MAX_BATCH):
    """`cli.serve`'s server on port 0 (the runner warmed up first, as
    `main` does); -> (base URL, httpd, batcher, the sizes of the batches
    it runs, before padding)."""
    import threading

    from msml_torch.cli import serve

    serve.warmup(runner, max_batch)
    torch.cuda.synchronize()
    httpd, batcher = serve.build_server(runner, port=0, max_batch=max_batch,
                                        window_ms=SERVE_WINDOW_MS)
    sizes = []
    observe = batcher.metrics.observe_batch

    def recorded(n):
        sizes.append(int(n))
        observe(n)

    batcher.metrics.observe_batch = recorded
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return (f"http://127.0.0.1:{httpd.server_address[1]}", httpd, batcher,
            sizes)


def stop_server(httpd, batcher):
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


def decoder_survey() -> str:
    """What this machine offers an image decoder: Pillow and OpenCV (each
    imported in a child process, so that this one stays free of them),
    libjpeg headers, nvJPEG."""
    import glob

    found = []
    for name in ("PIL", "cv2"):
        code = f"import {name}; print({name}.__version__)"
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=120)
        found.append(f"{name} " + (proc.stdout.strip() if proc.returncode == 0
                                   else "absent"))
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for what, pattern in (("jpeglib.h", "/usr/include/**/jpeglib.h"),
                          ("turbojpeg.h", "/usr/include/**/turbojpeg.h"),
                          ("nvjpeg.h", f"{home}/include/nvjpeg.h"),
                          ("libnvjpeg", f"{home}/lib64/libnvjpeg.so*")):
        hits = sorted(glob.glob(pattern, recursive=True))
        found.append(f"{what} " + (", ".join(hits) if hits else "absent"))
    return "; ".join(found)


def serve_breakdown(runner, x: np.ndarray) -> dict:
    """Host-clock ms (median) of the parts of an /embed_batch request:
    `runner.infer` (two forwards, copies, l2) in this thread and as the
    first call of a new thread, as the server's handler threads make it,
    and the JSON answer encoded and decoded."""
    import threading

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    infer = statistics.median(timed(lambda: runner.infer(x))
                              for _ in range(5))
    fresh = []
    for _ in range(3):
        t = threading.Thread(target=lambda: fresh.append(
            timed(lambda: runner.infer(x))))
        t.start()
        t.join()
    y = runner.infer(x)
    answer = statistics.median(timed(lambda: json.loads(json.dumps(
        {"embeddings": y.tolist()}))) for _ in range(5))
    return {"infer": infer, "fresh": statistics.median(fresh),
            "json": answer}


def count_forwards(runner) -> list:
    """Count the runner's raw forwards (two per batch: flip-sum)."""
    calls = []
    raw = runner._raw

    def counted_raw(x):
        calls.append(len(x))
        return raw(x)

    runner._raw = counted_raw
    return calls


def serve_kernels_at_buckets(seed: int, errs: dict):
    """conv3x3_fwd and prelu_fwd against their plain versions at every
    bucket batch, at the eval forward's shapes in bf16."""
    from msml_torch.kernels.conv3x3 import conv3x3_fwd, conv3x3_reference
    from msml_torch.kernels.prelu import prelu_fwd, prelu_reference
    from msml_torch.cli.serve import _buckets

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    prelu_shapes = sorted(set(prelu_sites(seed)))
    worst = 0.0
    for b in _buckets(SERVE_MAX_BATCH):
        for c, h, w in CONV_SHAPES:
            x = torch.randn((b, c, h, w), generator=gen,
                            device="cuda").bfloat16()
            wt = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
                  / 24).bfloat16()
            got, ref = conv3x3_fwd(x, wt), conv3x3_reference(x.float(),
                                                             wt.float())
            rel = rel_l2(got, ref)
            if not rel <= CONV_TOL[torch.bfloat16][0]:
                fail(f"serve: conv3x3_fwd bf16 {(b, c, h, w)}: relative L2 "
                     f"error {rel} > {CONV_TOL[torch.bfloat16][0]}")
            worst = max(worst, rel)
            errs["conv3x3_fwd"] = max(errs["conv3x3_fwd"], (
                got.float() - ref).abs().max().item())
        for c, h, w in prelu_shapes:
            x = torch.randn((b, c, h, w), generator=gen,
                            device="cuda").bfloat16()
            a = torch.rand((c,), generator=gen, device="cuda") * 0.5
            if not torch.equal(prelu_fwd(x, a), prelu_reference(x, a)):
                fail(f"serve: prelu_fwd bf16 {(b, c, h, w)} not equal to "
                     "the plain version")
    torch.cuda.synchronize()
    print(f"[8 serve] kernels at the bucket batches "
          f"{_buckets(SERVE_MAX_BATCH)}, bf16: conv3x3_fwd at "
          f"{len(CONV_SHAPES)} site shapes, relative L2 error <= {worst:.2e} "
          f"(tolerance {CONV_TOL[torch.bfloat16][0]}); prelu_fwd at "
          f"{len(prelu_shapes)} site shapes exactly equal to the plain "
          "version")


def dispatch_us(seed: int) -> dict:
    """Host microseconds per call (2,000 calls, the last one synchronised;
    median of 3) of `prelu_fwd` and `conv3x3_fwd` through their custom ops
    and of their CUDA implementations called directly, at B = 1, 28 x 28
    bf16, where the host's time is all there is."""
    from msml_torch.kernels import conv3x3, prelu

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    x = torch.randn((1, 64, 28, 28), generator=gen, device="cuda").bfloat16()
    a = torch.rand((64,), generator=gen, device="cuda")
    w = (torch.randn((64, 64, 3, 3), generator=gen, device="cuda")
         / 24).bfloat16()

    def per_call(fn, n: int = 2000) -> float:
        runs = []
        for _ in range(3):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / n * 1e6)
        return statistics.median(runs)

    return {"prelu_fwd": (per_call(lambda: prelu.prelu_fwd(x, a)),
                          per_call(lambda: prelu._prelu_fwd_cuda(x, a))),
            "conv3x3_fwd": (per_call(lambda: conv3x3.conv3x3_fwd(x, w)),
                            per_call(lambda: conv3x3._conv3x3_fwd_cuda(x, w)))}


def cli_serve(seed: int, folder: str, scratch: str, smi: str):
    """[8 serve] `cli.serve` on the folder the training CLI wrote: a
    weight-folder server, an exported-artifact server, and `cli.embed`;
    -> (the weight-folder server's launch counts, max abs errors of the
    kernels at the bucket batches)."""
    from concurrent.futures import ThreadPoolExecutor

    from msml_torch.cli import embed as cli_embed
    from msml_torch.cli import serve
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.data.bin_loader import ppm_encode
    from msml_torch.eval.folder_eval import tensorize_folder_img
    from msml_torch.eval.verification import l2_normalize_np
    from msml_torch.tools import export_serving

    print(f"[8 serve] image decoders on this machine: {decoder_survey()}")
    errs = {"conv3x3_fwd": 0.0}
    serve_kernels_at_buckets(seed, errs)
    print(f"[8 serve] {smi}: host time per call at B = 1, 28 x 28 bf16, "
          "through the custom op / the CUDA implementation called directly: "
          + "; ".join(f"{k} {op:.1f} / {direct:.1f} us" for k, (op, direct)
                      in dispatch_us(seed).items()))
    t_phase = time.perf_counter()

    # the images: 37 for /embed_batch, 64 for /embed, the first 40 of
    # those for cli.embed, in one reference batch of 512 with others
    rs = np.random.RandomState(seed + 8)
    raw = rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    x = np.stack([tensorize_folder_img(a) for a in raw])
    batch_idx, single_idx = np.arange(37), np.arange(37, 37 + 64)
    _, model = load_weight_folder(folder, device="cuda")
    fwd = export_serving.EvalForward(model)
    with torch.inference_mode():
        xt = torch.as_tensor(x, device="cuda")
        ref = (fwd(xt) + fwd(xt.flip(2))).float().cpu().numpy()
        bucket_ms = {b: time_ms(lambda: fwd(xt[:b]), windows=3, per_window=5)
                     for b in serve._buckets(SERVE_MAX_BATCH)}
    ref = l2_normalize_np(ref)
    del model, fwd, xt

    def min_cos(got, idx) -> float:
        return float(np.min(np.sum(l2_normalize_np(np.asarray(
            got, np.float64)) * ref[idx], axis=1)))

    # the weight-folder server: warm-up, then the counted requests
    runner = serve.runner_from_weight_folder(folder, "cuda")
    forwards = count_forwards(runner)
    base, httpd, batcher, sizes = start_server(runner)
    try:
        health = json.loads(get(base + "/healthz"))
        want_keys = {"status", "input_hwc", "flip_sum", "l2_norm", "source",
                     "network", "dim"}
        if set(health) != want_keys or health["input_hwc"] != [H, W, 3]:
            fail(f"serve: /healthz {health}")
        forwards.clear()
        sizes.clear()
        reset_launches()
        _, out = post(base + "/embed_batch", npy_bytes(x[batch_idx]))
        batch_answer = np.asarray(out["embeddings"])
        bodies = [ppm_encode(raw[i]) for i in single_idx]
        with ThreadPoolExecutor(64) as pool:
            replies = list(pool.map(lambda body: post(base + "/embed", body),
                                    bodies))
        torch.cuda.synchronize()
        launches = read_launches()
        served = len(forwards)
        single_answer = np.asarray([r[1]["embedding"] for r in replies])
        lat_64 = [r[0] for r in replies]
        m = dict(line.rsplit(" ", 1) for line in get(
            base + "/metrics").decode().splitlines()
            if line and not line.startswith("#"))
        single_sizes = sizes[2:]
        want = expect(prelu_fwd=served * PRELU_SITES,
                      conv3x3_fwd=served * CONV_SITES)
        if launches != want or sizes[:2] != [32, 5]:
            fail(f"serve: launches {launches} over {served} forwards, "
                 f"expected {want}; batch sizes {sizes}")
        if (float(m["msml_requests_total"]) != 65
                or float(m["msml_request_errors_total"]) != 0
                or float(m["msml_images_total"]) != 37 + 64
                or not max(single_sizes) > 1):
            fail(f"serve: /metrics {m}, /embed batch sizes {single_sizes}")
        cos_batch = min_cos(batch_answer, batch_idx)
        cos_single = min_cos(single_answer, single_idx)
        if not min(cos_batch, cos_single) >= SERVE_MIN_COS:
            fail(f"serve: min cosine to the B = {B} forward: /embed_batch "
                 f"{cos_batch}, /embed {cos_single} (< {SERVE_MIN_COS})")

        # numbers: one client at a time, then a batch of 32 at a time
        lat_1 = [post(base + "/embed", bodies[i % 64])[0] for i in range(32)]
        body32 = npy_bytes(x[:32])
        t0 = time.perf_counter()
        for _ in range(8):
            post(base + "/embed_batch", body32)
        batch_img_s = 8 * 32 / (time.perf_counter() - t0)
        parts = serve_breakdown(runner, x[:32])
    finally:
        stop_server(httpd, batcher)
    print(f"[8 serve] {smi}: weight-folder server, max batch "
          f"{SERVE_MAX_BATCH}, window {SERVE_WINDOW_MS} ms: /healthz keys "
          f"{sorted(health)}; /embed_batch of 37 (batches {sizes[:2]}, "
          f"buckets 32 + 8) and 64 concurrent /embed (PPM): min cosine to a "
          f"direct B = {B} forward {cos_batch:.6f} / {cos_single:.6f} (>= "
          f"{SERVE_MIN_COS}); /metrics requests {m['msml_requests_total']}, "
          f"errors {m['msml_request_errors_total']}, batches "
          f"{m['msml_device_batches_total']}, images "
          f"{m['msml_images_total']}; /embed batch sizes "
          f"{sorted(single_sizes, reverse=True)}; {served} forwards, "
          f"launches {launches}")
    print(f"[8 serve] {smi}: the eval forward (EvalForward, bf16) in ms per "
          "bucket by CUDA events: " + ", ".join(f"B={b} {ms:.3f}" for b, ms in
                                         bucket_ms.items()))
    print(f"[8 serve] {smi}: /embed latency (host clock, HTTP included) "
          f"concurrency 1: p50 {percentile_ms(lat_1, 50):.2f} ms, p99 "
          f"{percentile_ms(lat_1, 99):.2f} ms over 32; concurrency 64: p50 "
          f"{percentile_ms(lat_64, 50):.2f} ms, p99 "
          f"{percentile_ms(lat_64, 99):.2f} ms over 64; /embed_batch of 32: "
          f"{batch_img_s:.1f} img/s (8 requests in turn); of a request of "
          f"32, host clock: runner.infer {parts['infer']:.2f} ms in the "
          f"main thread, {parts['fresh']:.2f} ms as the first call of a new "
          f"thread (a handler's), the JSON answer {parts['json']:.2f} ms "
          "(encoded and decoded)")

    # the exported artifact, served on the same images
    artifact = os.path.join(scratch, "model.pt2")
    t0 = time.perf_counter()
    export_serving.main(export_serving.parse_args(
        ["--weight_folder", folder, "--out", artifact, "--device", "cuda"]))
    export_s = time.perf_counter() - t0
    arunner = serve.runner_from_artifact(artifact, "cuda")
    aforwards = count_forwards(arunner)
    base, httpd, batcher, _ = start_server(arunner)
    try:
        aforwards.clear()
        reset_launches()
        _, out = post(base + "/embed_batch", npy_bytes(x[batch_idx]))
        torch.cuda.synchronize()
        alaunches = read_launches()
    finally:
        stop_server(httpd, batcher)
    artifact_answer = np.asarray(out["embeddings"])
    cos_art = float(np.min(np.sum(artifact_answer * batch_answer, axis=1)))
    want = expect(prelu_fwd=len(aforwards) * PRELU_SITES,
                  conv3x3_fwd=len(aforwards) * CONV_SITES)
    if alaunches != want or not cos_art >= ARTIFACT_MIN_COS:
        fail(f"serve --artifact: launches {alaunches} over {len(aforwards)} "
             f"forwards, expected {want}; min cosine to the weight-folder "
             f"server {cos_art} (< {ARTIFACT_MIN_COS})")
    print(f"[8 serve] {smi}: tools.export_serving wrote "
          f"{os.path.getsize(artifact)} "
          f"bytes in {export_s:.1f} s; the artifact server's /embed_batch "
          f"of 37: min cosine to the weight-folder server's {cos_art:.8f} "
          f"(>= {ARTIFACT_MIN_COS}); {len(aforwards)} forwards, launches "
          f"{alaunches}")

    # cli.embed over 40 PPM files of the /embed images
    src = os.path.join(scratch, "faces")
    os.makedirs(src)
    for k, i in enumerate(single_idx[:40]):
        with open(os.path.join(src, f"{k:03d}.ppm"), "wb") as f:
            f.write(ppm_encode(raw[i]))
    out_npy = os.path.join(scratch, "feats.npy")
    feats, names = cli_embed.main(cli_embed.parse_args(
        ["--weight_folder", folder, "--src", src, "--out", out_npy,
         "--device", "cuda"]))
    with open(out_npy + ".names.txt") as f:
        listed = f.read().split()
    saved = np.load(out_npy)
    cos_embed = float(np.min(np.sum(saved * single_answer[:40], axis=1)))
    if (listed != [f"{k:03d}.ppm" for k in range(40)] or names != listed
            or saved.shape != (40, 512)
            or not cos_embed >= SERVE_MIN_COS):
        fail(f"cli.embed: names {listed[:3]}..., shape {saved.shape}, min "
             f"cosine to the server's /embed answers {cos_embed}")
    print(f"[8 serve] {smi}: cli.embed over 40 PPM images: feats.npy "
          f"{saved.shape} + names file; min cosine to the server's /embed "
          f"answers {cos_embed:.6f} (>= {SERVE_MIN_COS}); phase "
          f"{time.perf_counter() - t_phase:.1f} s host clock after the "
          "kernel checks")
    return launches, errs


QUANT_MIN_COS = 0.998   # int8 vs float bf16 features: JAX's bound, the min
                        # over its images at random init
                        # (tests/test_quantize.py), held as the min over
                        # phase 3's 512 random-init images
QUANT_MEAN_COS = 0.998  # the trained folder's int8 copy: the mean over 512
QUANT_FLOOR_COS = 0.995  # ... and each image's: under the min that the
                         # trained folder gave on the H100 (0.997483, the
                         # same in three runs), which is below JAX's bound
QUANT_CHECK_B = 8       # kernels vs plain at every distinct int8 geometry
QUANT_SITES = 90        # arc18_msml's int8 sites: 89 convs and the fc
# (N, C_in, H, W, C_out, geometry (kh, kw, sh, sw, ph, pw, dh, dw, ho, wo))
# of the int8 conv kernel's odd paths, beside the model's own geometries
QCONV_ODD = {
    "4x4 transposed, odd ho and wo": (2, 36, 5, 6, 18,
                                      (4, 4, 1, 1, 2, 2, 2, 2, 9, 11)),
    "3x3 transposed, odd ho and wo": (3, 8, 4, 3, 18,
                                      (3, 3, 1, 1, 1, 1, 2, 2, 7, 5)),
    "Co 18 on the 32-row tile": (2, 40, 9, 11, 18,
                                 (3, 3, 1, 1, 1, 1, 1, 1, 9, 11)),
    "Co 33 on the 64-row tile": (2, 40, 9, 11, 33,
                                 (3, 3, 1, 1, 1, 1, 1, 1, 9, 11)),
    "a pixel tail of 105": (3, 64, 5, 7, 64, (3, 3, 1, 1, 1, 1, 1, 1, 5, 7)),
    "the fc at B = 1": (1, 25088, 1, 1, 512, (1, 1, 1, 1, 0, 0, 1, 1, 1, 1)),
    "the fc at B = 513": (513, 25088, 1, 1, 512,
                          (1, 1, 1, 1, 0, 0, 1, 1, 1, 1)),
}
INT8_OPS = 1979e12      # dense int8 tensor-core peak (operations / s)
# quant_act's plans that phase 1 shows: (C, H W, dtype) of a sample
ACT_PLANS = {
    "64x112² bf16": (64, 112 * 112, torch.bfloat16),
    "64x56² bf16": (64, 56 * 56, torch.bfloat16),
    "128x28² bf16": (128, 28 * 28, torch.bfloat16),
    "512x7² bf16": (512, 7 * 7, torch.bfloat16),
    "the fc's 25088 bf16": (25088, 1, torch.bfloat16),
    "64x112² f32": (64, 112 * 112, torch.float32)}
# (N, C, H, W, dtype, the route's K) of each of quant_act's routes: the fc
# flat in one block, rows in clusters of 1 to 16, and a sample over 16
# blocks' shared memory on the two-pass route (K = 0)
ACT_ROUTES = {
    "flat, the fc": (8, 25088, 1, 1, torch.bfloat16, 1),
    "rows, one block": (8, 64, 28, 28, torch.bfloat16, 1),
    "rows, cluster of 2": (8, 128, 28, 28, torch.bfloat16, 2),
    "rows, cluster of 4": (8, 64, 56, 56, torch.bfloat16, 4),
    "rows, cluster of 8": (8, 82, 56, 56, torch.bfloat16, 8),
    "rows, cluster of 16": (8, 64, 112, 112, torch.bfloat16, 16),
    "rows, cluster of 16, f32": (4, 64, 112, 112, torch.float32, 16),
    "two-pass, f32 over the cap": (2, 64, 128, 128, torch.float32, 0)}


def check_quant_site(m, xin) -> float:
    """`quant_act` and `qconv_int8` against their plain versions on one
    site's input, bit for bit; -> the max abs difference (0)."""
    from msml_torch.kernels import qconv

    x = xin.to(m.dtype)
    xq, sx = qconv.quant_act(x, m.cp)
    rq, rs = qconv.quant_act_reference(x, m.cp)
    hw = (1, 1) if x.dim() == 2 else x.shape[2:]
    geo = m.geometry(*hw)
    y = qconv.qconv_int8(xq, m.wp, sx, m.sw, m.bias, geo, m.dtype)
    ref = qconv.qconv_reference(rq, m.wp, rs, m.sw, m.bias, geo, m.dtype)
    if not (torch.equal(xq, rq) and torch.equal(sx, rs)
            and torch.equal(y, ref)):
        fail(f"quant: {m} at input {tuple(x.shape)} {x.dtype}: codes equal "
             f"{torch.equal(xq, rq)}, scales equal {torch.equal(sx, rs)}, "
             f"outputs max abs diff "
             f"{(y.float() - ref.float()).abs().max().item()}")
    return (y.float() - ref.float()).abs().max().item()


def check_qconv_odd(gen) -> float:
    """`quant_act` and `qconv_int8` bit-equal to their plain versions at
    QCONV_ODD, bf16 with a bias and float32 without, inputs one element
    off; prints each case's plan. -> the max abs difference (0)."""
    from msml_torch.kernels import qconv

    for what, (n, ci, h, w, co, geo) in QCONV_ODD.items():
        for dtype, with_bias in ((torch.bfloat16, True),
                                 (torch.float32, False)):
            x = offset_copy(torch.randn((n, ci, h, w), generator=gen,
                                        device="cuda", dtype=dtype), 1)
            if h == w == 1:
                x = x.view(n, ci)
            cp = qconv.padded_channels(ci)
            xq, sx = qconv.quant_act(x, cp)
            rq, rs = qconv.quant_act_reference(x, cp)
            wq = torch.randint(-127, 128, (co, ci) + geo[:2], generator=gen,
                               device="cuda").to(torch.int8)
            wp = qconv.pack_weight(wq, cp)
            sw = torch.rand((co,), generator=gen, device="cuda") * 0.01
            bias = (torch.randn((co,), generator=gen, device="cuda")
                    if with_bias else None)
            y = qconv.qconv_int8(xq, wp, sx, sw, bias, geo, dtype)
            ref = qconv.qconv_reference(xq, wp, sx, sw, bias, geo, dtype)
            if not (torch.equal(xq, rq) and torch.equal(sx, rs)
                    and torch.equal(y, ref)):
                fail(f"quant: {what} {dtype}: codes equal "
                     f"{torch.equal(xq, rq)}, scales equal "
                     f"{torch.equal(sx, rs)}, outputs max abs diff "
                     f"{(y.float() - ref.float()).abs().max().item()}")
        plan = qconv.qconv_plan(n, cp, co, geo)
        print(f"[11 quant]   {what}: (N, C, H, W) {(n, ci, h, w)} -> {co} "
              f"{list(geo)}, bit-equal in bf16 and f32; plan "
              f"{qconv.describe_plan(plan)}")
    return 0.0


def graph_nodes(fn) -> int:
    """Nodes of a CUDA graph that captured one call of fn (warmed up)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcudart.so").cudaGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        fail(f"cudaGraphGetNodes: error {err}")
    del graph
    return count.value


def check_quant_routes(gen) -> dict:
    """`quant_act` on each route of its plan (ACT_ROUTES) bit-equal to its
    plain version, on inputs aligned and one element off; the nodes of a
    captured call: one on the cluster route, three on the two-pass route
    (a memset and two kernels). -> {route: nodes}."""
    from msml_torch.kernels import qconv

    nodes = {}
    for what, (n, c, h, w, dtype, k) in ACT_ROUTES.items():
        bf16 = dtype == torch.bfloat16
        plan = qconv.quant_act_plan(n, c, h * w, 2 if bf16 else 4,
                                    qconv.cluster_cap(0, bf16))
        if plan.k != k:
            fail(f"quant_act {what}: plan {plan}, expected K = {k}")
        cp = qconv.padded_channels(c)
        for offset in (0, 1):
            x = torch.randn((n, c, h, w), generator=gen, device="cuda")
            x[0] *= 5.0
            x[1] = 0.0
            x = offset_copy(x.to(dtype), offset)
            if h == w == 1:
                x = x.view(n, c)
            xq, sx = qconv.quant_act(x, cp)
            rq, rs = qconv.quant_act_reference(x, cp)
            if not (torch.equal(xq, rq) and torch.equal(sx, rs)):
                fail(f"quant_act {what}, offset {offset}: codes equal "
                     f"{torch.equal(xq, rq)}, scales equal "
                     f"{torch.equal(sx, rs)}")
        nodes[what] = graph_nodes(lambda: qconv.quant_act(x, cp))
        if nodes[what] != (1 if k else 3):
            fail(f"quant_act {what}: {nodes[what]} graph nodes a call")
        print(f"[11 quant]   quant_act {what}: {(n, c, h, w)} "
              f"{str(dtype)[6:]}, {qconv.describe_act_plan(plan)}: "
              f"bit-equal aligned and one element off; {nodes[what]} "
              "graph node(s) a call")
        del x, xq, sx, rq, rs
    torch.cuda.empty_cache()
    return nodes


def quant_bounds(n: int, shape, geo, co: int, out_bytes: int):
    """(qconv bound ms, bound_by, quant_act bound ms, operations) of one
    int8 site at batch n (`kernels/qconv.py::site_work`): the operations
    that its data needs at the int8 peak, against each input read once and
    each output written once at the memory rate."""
    from msml_torch.kernels import qconv

    ops, conv_bytes, act_bytes = qconv.site_work(n, shape, geo, co,
                                                 out_bytes)
    t_bytes, t_ops = conv_bytes / HBM_BYTES_PER_S, ops / INT8_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            act_bytes / HBM_BYTES_PER_S * 1e3, ops)


def time_quant_sites(sites: dict, smi: str, seed: int) -> list:
    """Each distinct int8 geometry at B = 512 on random inputs of its
    shape: `quant_act` and `qconv_int8` bit-equal to their plain versions,
    then timed beside their bounds and the bf16 cuDNN op of the same shape;
    -> one dict a geometry."""
    from msml_torch.kernels import qconv
    from msml_torch.tools.qconv_ab import cudnn_call

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    rows = []
    spent = {"check": 0.0, "time": 0.0}
    for key, found in sites.items():
        kind, shape, geo, dtype, _, _ = key
        name, m, _ = found[0]
        plan = qconv.qconv_plan(B, m.cp, m.sw.shape[0], geo)
        act = qconv.quant_act_plan(
            B, shape[0], int(np.prod(shape[1:])), dtype.itemsize,
            qconv.cluster_cap(0, dtype == torch.bfloat16))
        xs = [torch.randn((B,) + shape, generator=gen, device="cuda",
                          dtype=dtype) for _ in range(2)]
        t0 = time.perf_counter()
        err = check_quant_site(m, xs[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        qs = [qconv.quant_act(x, m.cp) for x in xs]
        co = m.sw.shape[0]
        act_ms = time_graph_ms([lambda x=x: qconv.quant_act(x, m.cp)
                                for x in xs], windows=1)
        conv_ms = time_graph_ms([lambda q=q: qconv.qconv_int8(
            q[0], m.wp, q[1], m.sw, m.bias, list(geo), dtype) for q in qs],
            windows=1)
        cudnn_ms = time_graph_ms([cudnn_call(m, x.to(torch.bfloat16), gen)
                                  for x in xs], windows=1)
        spent["check"] += t1 - t0
        spent["time"] += time.perf_counter() - t1
        x = xs[0]
        bound, by, act_bound, ops = quant_bounds(B, shape, geo, co,
                                                 x.element_size())
        rows.append({"site": name, "sites": len(found), "kind": kind,
                     "input": list(shape), "out_channels": co,
                     "geometry": list(geo), "dtype": str(dtype)[6:],
                     "plan": qconv.describe_plan(plan),
                     "act_plan": qconv.describe_act_plan(act),
                     "act_k": act.k,
                     "int8_ops": ops, "max_abs_err": err,
                     "qconv_ms": conv_ms, "qconv_bound_ms": bound,
                     "bound_by": by, "quant_act_ms": act_ms,
                     "quant_act_bound_ms": act_bound, "cudnn_bf16_ms": cudnn_ms})
        del x, xs, qs
    torch.cuda.empty_cache()
    print(f"[11 quant] {smi}: each distinct int8 geometry at B = {B}: "
          "quant_act and qconv_int8 bit-equal to their plain versions on "
          f"random inputs ({spent['check']:.1f} s host clock); device time "
          f"from CUDA graphs of the calls ({spent['time']:.1f} s; kernel "
          "ms / bound ms / cuDNN bf16 ms of the same shape):")
    for r in rows:
        print(f"[11 quant]   {r['site']} (x{r['sites']}) {r['kind']} "
              f"{r['input']} -> {r['out_channels']} {r['geometry'][:8]}: "
              f"qconv_int8 {r['qconv_ms']:.4f} / {r['qconv_bound_ms']:.4f} "
              f"({r['bound_by']}); quant_act {r['quant_act_ms']:.4f} / "
              f"{r['quant_act_bound_ms']:.4f}; cuDNN bf16 "
              f"{r['cudnn_bf16_ms']:.4f}; plan {r['plan']}; quant_act "
              f"{r['act_plan']}")
    total = {k: sum(r[k] * r["sites"] for r in rows) for k in (
        "qconv_ms", "qconv_bound_ms", "quant_act_ms", "quant_act_bound_ms",
        "cudnn_bf16_ms")}
    print(f"[11 quant]   summed over the {sum(r['sites'] for r in rows)} "
          f"sites: qconv_int8 {total['qconv_ms']:.4f} / "
          f"{total['qconv_bound_ms']:.4f}; quant_act "
          f"{total['quant_act_ms']:.4f} / {total['quant_act_bound_ms']:.4f}; "
          f"cuDNN bf16 {total['cudnn_bf16_ms']:.4f}")
    return rows


def once_ms(fn) -> float:
    """One call's time by CUDA events, after one warm-up call (for the
    plain versions, whose calls take seconds at B = 512)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def quant_entries(sites: dict, rows: list, errs: dict, seed: int,
                  nodes: dict) -> list:
    """The kernels line's qconv_int8 and quant_act entries, at the site of
    the most int8 operations at B = 512: kernel, plain version (float64
    F.conv2d without cuDNN; float32 torch ops), bound; no PyTorch call
    computes either (cuDNN's bf16 op of the same shape is beside them)."""
    from msml_torch.kernels import qconv

    top = max(rows, key=lambda r: r["int8_ops"])
    key = next(k for k, f in sites.items() if f[0][0] == top["site"])
    _, m, _ = sites[key][0]
    geo, dtype = list(key[2]), key[3]
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    x = torch.randn((B,) + key[1], generator=gen, device="cuda", dtype=dtype)
    xq, sx = qconv.quant_act(x, m.cp)
    plain_act = once_ms(lambda: qconv.quant_act_reference(x, m.cp))
    act = qconv.quant_act_plan(B, key[1][0], int(np.prod(key[1][1:])),
                               dtype.itemsize,
                               qconv.cluster_cap(0, dtype == torch.bfloat16))
    plain_conv = once_ms(lambda: qconv.qconv_reference(
        xq, m.wp, sx, m.sw, m.bias, geo, dtype))
    at = f"{top['site']}, {list(key[1])} -> {m.sw.shape[0]}, B = {B}"
    common = {"route": "cuda", "source": "msml_torch/csrc/qconv_int8.cu",
              "replaces": "msml_tpu/core/quantize.py:141 (int8 "
                          "conv_general_dilated / dot_general, lowered by "
                          "XLA: no Pallas kernel)",
              "library_ms": None, "at": at}
    del x, xq, sx
    torch.cuda.empty_cache()
    return [
        {"name": "qconv_int8", **common, "max_abs_err": errs["qconv_int8"],
         "ms": top["qconv_ms"], "plain_ms": plain_conv,
         "bound_ms": top["qconv_bound_ms"], "bound_by": top["bound_by"],
         "cudnn_bf16_ms": top["cudnn_bf16_ms"], "geometries": rows},
        {"name": "quant_act", **common, "max_abs_err": errs["quant_act"],
         "ms": top["quant_act_ms"], "plain_ms": plain_act,
         "bound_ms": top["quant_act_bound_ms"], "bound_by": "bytes",
         "act_route": act.route, "act_k": act.k,
         "act_plan": qconv.describe_act_plan(act),
         "act_clusters_resident": qconv.act_occupancy(
             dtype == torch.bfloat16, act.k, act.smem)[0],
         "act_graph_nodes": nodes}]


def quant_random_init(seed: int, smi: str, model):
    """JAX's setting for its cosine bound (tests/test_quantize.py: random
    init, the min over the images): phase 3's model and images at B = 512,
    its int8 copy against its bf16 forward."""
    from msml_torch.core.quantize import quantize_eval_model
    from msml_torch.kernels.augment import augment_batch

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)  # phase 3's
    raw = torch.rand((B, H, W, 3), generator=gen, device="cuda")
    x = augment_batch(raw, torch.rand((B, 6), generator=gen, device="cuda"))
    t0 = time.perf_counter()
    qmodel = quantize_eval_model(model, (H, W, 3))
    quantize_s = time.perf_counter() - t0
    with torch.inference_mode():
        per_image = cosines(qmodel(x)[0], model(x)[0])
    cos_min = per_image.min().item()
    if not cos_min >= QUANT_MIN_COS:
        fail(f"quant at random init: min feature cosine {cos_min} to the "
             f"bf16 forward (>= {QUANT_MIN_COS})")
    print(f"[11 quant] {smi}: phase 3's random-init model, its int8 copy "
          f"(made in {quantize_s:.1f} s) against its bf16 forward, B = {B}: "
          f"feature cosine min {cos_min:.6f} (>= {QUANT_MIN_COS}, JAX's "
          f"bound), mean {per_image.mean().item():.6f}")
    del qmodel, x, raw
    torch.cuda.empty_cache()


def cli_quant(seed: int, folder: str, scratch: str, smi: str,
              float_rows: list):
    """Phase 11: int8 post-training quantization on the folder the
    training CLI wrote; -> (kernels line entries, the quantized forward's
    launches (this slice's path), the quantized device sweep's launches,
    the served folder's launches)."""
    from msml_torch.cli import serve
    from msml_torch.cli import test as cli_test
    from msml_torch.core.quantize import quantize_eval_model
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.eval.folder_eval import tensorize_folder_img
    from msml_torch.kernels import qconv
    from msml_torch.kernels.augment import augment_batch
    from msml_torch.tools import export_serving
    from msml_torch.tools.qconv_ab import int8_sites_of

    t_phase = time.perf_counter()
    _, model = load_weight_folder(folder, device="cuda")  # bf16 policy
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    x = augment_batch(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                      torch.rand((B, 6), generator=gen, device="cuda"))
    qmodel = quantize_eval_model(model, (H, W, 3))

    # (b) every distinct int8 geometry at B = 8, one odd shape one element
    # off, and the fc at B = 512: the kernels bit-equal to the plain ones
    sites = int8_sites_of(qmodel, x[:QUANT_CHECK_B])
    if sum(len(f) for f in sites.values()) != QUANT_SITES:
        fail(f"quant: {sum(len(f) for f in sites.values())} int8 sites, "
             f"expected {QUANT_SITES}")
    err = max(check_quant_site(f[0][1], f[0][2]) for f in sites.values())
    odd = next(f[0][1] for k, f in sites.items() if k[0] == "conv"
               and k[2][:2] == (7, 1) and k[1][0] == 18)
    xo = offset_copy(torch.randn((3, 18, 13, 11), generator=gen,
                                 device="cuda", dtype=odd.dtype), 1)
    err = max(err, check_quant_site(odd, xo), check_qconv_odd(gen))
    nodes = check_quant_routes(gen)
    fc_in = {}
    fc = next(f[0][1] for k, f in sites.items() if k[0] == "linear")
    hook = fc.register_forward_pre_hook(
        lambda mod, args: fc_in.setdefault("x", args[0]))

    # (c) the quantized eval forward at B = 512 against the float one: this
    # slice's path, its launches counted alone
    with torch.inference_mode():
        want = model(x)[0]
        torch.cuda.synchronize()
        reset_launches()
        got = qmodel(x)[0]
        torch.cuda.synchronize()
        launches = read_launches()
    hook.remove()
    err = max(err, check_quant_site(fc, fc_in.pop("x")))
    errs = {"qconv_int8": err, "quant_act": err}
    want_launches = expect(prelu_fwd=PRELU_SITES, quant_act=QUANT_SITES,
                           qconv_int8=QUANT_SITES)
    per_image = cosines(got, want)
    cos, cos_min = per_image.mean().item(), per_image.min().item()
    if (launches != want_launches or got.shape != (B, 512)
            or not torch.isfinite(got).all() or not cos >= QUANT_MEAN_COS
            or not cos_min >= QUANT_FLOOR_COS):
        fail(f"quant forward: launches {launches} (expected "
             f"{want_launches}), shape {tuple(got.shape)}, feature cosine "
             f"to the float bf16 forward mean {cos} (>= {QUANT_MEAN_COS}), "
             f"min {cos_min} (>= {QUANT_FLOOR_COS})")
    print(f"[11 quant] {smi}: the trained folder's int8 copy, "
          f"{QUANT_SITES} int8 sites in {len(sites)} distinct geometries: "
          f"quant_act and qconv_int8 bit-equal to their plain versions at "
          f"each (B = {QUANT_CHECK_B}), at a 7 x 1 conv on (3, 18, 13, 11) "
          f"one element off, at the {len(QCONV_ODD)} odd cases above and "
          f"at the fc at B = {B}; B = {B} forward: "
          f"feature cosine to the float bf16 forward mean {cos:.6f} (>= "
          f"{QUANT_MEAN_COS}), median {per_image.median().item():.6f}, 1st "
          f"percentile {per_image.quantile(0.01).item():.6f}, min "
          f"{cos_min:.6f} (>= {QUANT_FLOOR_COS}); launches {launches}")

    # (d) a row's features do not depend on its batch-mates
    with torch.inference_mode():
        padded = qmodel(torch.cat([x[:8], torch.zeros_like(x[8:])]))[0]
    if not torch.equal(padded[:8], got[:8]):
        fail("quant: rows in a zero-padded batch differ from the same rows "
             "among other images: max abs diff "
             f"{(padded[:8] - got[:8]).abs().max().item()}")
    print(f"[11 quant] 8 rows among {B - 8} zero rows and among {B - 8} "
          "other images: bit-equal features")

    # (g) the forward's img/s, and each geometry's time
    with torch.inference_mode():
        ms_q = time_ms(lambda: qmodel(x), windows=3, per_window=5)
        ms_f = time_ms(lambda: model(x), windows=3, per_window=5)
    print(f"[11 quant] {smi}: B = {B} eval forward int8 {ms_q:.2f} ms = "
          f"{B / ms_q * 1e3:.1f} img/s; bf16 {ms_f:.2f} ms = "
          f"{B / ms_f * 1e3:.1f} img/s (the trained folder, same call)")
    rows = time_quant_sites(sites, smi, seed)
    errs = dict.fromkeys(errs, max([err] + [r["max_abs_err"] for r in rows]))
    entries = quant_entries(sites, rows, errs, seed, nodes)
    entries[0]["img_s"] = {"int8": B / ms_q * 1e3, "bf16": B / ms_f * 1e3}
    del qmodel, model, got, want, padded, sites
    torch.cuda.empty_cache()

    # (e) export --quant int8, serve the artifact and the folder
    imgs = np.stack([tensorize_folder_img(a) for a in np.random.RandomState(
        seed + 13).randint(0, 256, (32, H, W, 3)).astype(np.uint8)])
    artifact = os.path.join(scratch, "int8.pt2")
    t0 = time.perf_counter()
    export_serving.main(export_serving.parse_args(
        ["--weight_folder", folder, "--out", artifact, "--device", "cuda",
         "--quant", "int8"]))
    export_s = time.perf_counter() - t0
    with open(artifact + ".json") as f:
        sidecar = json.load(f)
    float_bytes = os.path.getsize(os.path.join(scratch, "model.pt2"))
    answers, served = {}, {}
    for what, runner in (
            ("folder", serve.runner_from_weight_folder(folder, "cuda",
                                                       quant="int8")),
            ("artifact", serve.runner_from_artifact(artifact, "cuda"))):
        forwards = count_forwards(runner)
        base, httpd, batcher, _ = start_server(runner)
        try:
            health = json.loads(get(base + "/healthz"))
            forwards.clear()
            reset_launches()
            _, out = post(base + "/embed_batch", npy_bytes(imgs))
            torch.cuda.synchronize()
            served[what] = (read_launches(), len(forwards))
        finally:
            stop_server(httpd, batcher)
        answers[what] = np.asarray(out["embeddings"])
        if health.get("quant") != "int8":
            fail(f"quant serve {what}: /healthz {health}")
        if what == "folder":
            direct = runner.infer(imgs)
    for what, (got_l, n_fwd) in served.items():
        if got_l != expect(prelu_fwd=n_fwd * PRELU_SITES,
                           quant_act=n_fwd * QUANT_SITES,
                           qconv_int8=n_fwd * QUANT_SITES):
            fail(f"quant serve {what}: launches {got_l} over {n_fwd} "
                 "forwards")
    cos_http = float(np.min(np.sum(answers["folder"] * direct, axis=1)))
    cos_art = float(np.min(np.sum(answers["artifact"] * answers["folder"],
                                  axis=1)))
    if (sidecar.get("quant") != "int8" or not cos_http >= ARTIFACT_MIN_COS
            or not cos_art >= ARTIFACT_MIN_COS):
        fail(f"quant serve: sidecar {sidecar}, HTTP vs in-process min cosine "
             f"{cos_http}, artifact vs folder {cos_art}")
    print(f"[11 quant] {smi}: export_serving --quant int8 wrote "
          f"{os.path.getsize(artifact)} bytes in {export_s:.1f} s (the float "
          f"artifact {float_bytes} bytes); cli.serve --quant int8 on the "
          f"folder, /embed_batch of 32 over HTTP against runner.infer in the "
          f"process: min cosine {cos_http:.8f}, max abs diff "
          f"{np.abs(answers['folder'] - direct).max():.3g}; the artifact "
          f"server against it: min cosine {cos_art:.8f}; launches "
          f"{served['folder'][0]} / {served['artifact'][0]} over "
          f"{served['folder'][1]} / {served['artifact'][1]} forwards")

    # (f) cli.test --quant int8 --device-sweep on phase 6's 40 pairs
    bin_path = os.path.join(scratch, "pairs.bin")
    reset_launches()
    t0 = time.perf_counter()
    qrows = cli_test.main(cli_test.parse_args(
        ["--device-sweep", "--quant", "int8", "--weight_folder", folder,
         "--bin", bin_path, "--device", "cuda"]))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = read_launches()
    batches = (1 + 9 * 10) * 2  # and one float forward: the quantizer's trace
    want_sweep = expect(augment_batch=batches,
                        prelu_fwd=(batches + 1) * PRELU_SITES,
                        conv3x3_fwd=CONV_SITES,
                        quant_act=batches * QUANT_SITES,
                        qconv_int8=batches * QUANT_SITES)
    if (len(qrows) != 10 or sweep_launches != want_sweep
            or not all(math.isfinite(r["avg_acc"]) for r in qrows)):
        fail(f"quant sweep: {len(qrows)} rows, launches {sweep_launches}")
    print(f"[11 quant] cli.test --device-sweep --quant int8 on the trained "
          f"folder, 40 PPM pairs, {sweep_s:.1f} s: avg_acc int8 / bf16 "
          + ", ".join(f"{q['lo']}%: {q['avg_acc']:.4f} / {r['avg_acc']:.4f}"
                      for q, r in zip(qrows, float_rows))
          + f"; launches {sweep_launches}; phase {time.perf_counter() - t_phase:.1f} s host clock")
    return entries, launches, sweep_launches, served["folder"][0]


# configs/arc18_msml_peer_dec.yaml, the reference's shipped config.yaml (a
# CPU test pins the equality)
PEER_DEC = {
    "dataset": "ms1m-retinaface-t2",
    "fp16": True,
    "batch_size": 256,
    "frb_type": "iresnet18",
    "osb_type": "unet",
    "use_osb": True,
    "fm_layers": [1, 1, 1, 1],
    "fm_params": [3, 2, "sigmoid", "mul"],
    "peer_params": {"use_ori": True, "use_conv": True,
                    "mask_trans": "conv", "use_decoder": True},
    "header_type": "AMArcFace",
    "header_params": [64.0, 0.48, 0.0, 0.0],
    "exp_id": 1,
    "output_prefix": "arc18_msml_peer_dec",
}
PEER_B = 256            # the recipe's batch_size
PEER_STEPS = 20         # host-float steps of the recipe's train step
PEER_LIGHT_STEPS = 3    # ... and with device_light
PEER_CLI_STEPS, PEER_RESUME_TO = 4, 6
PEER_NW = 8             # the recipe's CLI loader: spawned worker processes
PEER_REC_IDS, PEER_REC_VIEWS = 200, 10  # 200 x 8 = 1600 train images
PEER_DECODER_WEIGHT = 0.5  # the step that runs the recover decoder


def peer_config(**over):
    from msml_torch.core.config import Config, config_init

    cfg = Config.from_dict(dict(PEER_DEC, **over))
    config_init(cfg, make_output_dir=False)
    return cfg


def peer_sites(model) -> dict:
    """The recipe's kernel sites, counted from its modules: PReLU and
    routed conv3x3 sites of the student (all but the teacher `frb.peer`)
    and of the teacher, and the student's PReLU sites in the KD towers
    (`conv2`), which run only in training."""
    from msml_torch.nn.common import PReLU, routed_conv_sites

    prelu = [n for n, m in model.named_modules() if isinstance(m, PReLU)]
    conv = routed_conv_sites(model)

    def teacher(names):
        return [n for n in names if n.startswith("frb.peer.")]

    return {"prelu": len(prelu) - len(teacher(prelu)),
            "prelu_teacher": len(teacher(prelu)),
            "prelu_kd": len([n for n in prelu if n.startswith("frb.fm_ops.")
                             and ".conv2." in n]),
            "conv": len(conv) - len(teacher(conv)),
            "conv_teacher": len(teacher(conv))}


def peer_step_launches(s: dict, steps: int, light: bool) -> dict:
    """Launches of `steps` recipe train steps: the PReLU pair at every
    student site and the forward at the teacher's; conv3x3 forward and dX
    at the student's sites, forward only at the teacher's, dW at the
    student's; with device_light the input stage on img and on ori."""
    return expect(augment_batch=2 * steps if light else 0,
                  prelu_fwd=steps * (s["prelu"] + s["prelu_teacher"]),
                  prelu_bwd=steps * s["prelu"],
                  conv3x3_fwd=steps * (2 * s["conv"] + s["conv_teacher"]),
                  conv3x3_dw=steps * s["conv"])


def peer_eval_launches(s: dict, forwards: int) -> dict:
    """Launches of `forwards` eval forwards of the recipe: the student's
    sites without the KD towers; no teacher."""
    return expect(prelu_fwd=forwards * (s["prelu"] - s["prelu_kd"]),
                  conv3x3_fwd=forwards * s["conv"])


def teacher_snapshot(model) -> dict:
    return {k: v.clone() for k, v in model.frb.peer.state_dict().items()}


def check_teacher(state, before: dict, what: str):
    """The teacher's parameters and BN buffers bit-equal to `before`, none
    of them in the optimizer or with a momentum buffer."""
    teacher = state.model.frb.peer
    changed = [k for k, v in teacher.state_dict().items()
               if not torch.equal(v, before[k])]
    held = {id(p) for p in state.optimizer.state} | {
        id(p) for g in state.optimizer.param_groups for p in g["params"]}
    in_opt = [n for n, p in teacher.named_parameters() if id(p) in held
              or p.requires_grad]
    if changed or in_opt or teacher.training:
        fail(f"{what}: teacher changed {changed[:4]}, in the optimizer "
             f"{in_opt[:4]}, training {teacher.training}")


def phase_peer_train(seed: int, smi: str):
    """Phase 12 (a): the recipe's train step at full width (B = 256,
    93,431 classes, bf16): host-float steps as the yaml runs them, then
    device_light steps, then one step with the recover decoder on;
    -> (sites, launches per path, img/s)."""
    from msml_torch.core.config import lr_step_factor
    from msml_torch.data.synthetic import synthetic_batch
    from msml_torch.nn.msml import msml_from_config
    from msml_torch.train.train_step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = peer_config()
    model = msml_from_config(cfg, device="cuda", seed=seed, head=True)
    sites = peer_sites(model)
    state = init_train_state(model, cfg, "cuda", seed)
    before = teacher_snapshot(model)
    lr = lr_step_factor(cfg, 0)
    out = {}

    def run(step, batch, steps, light, what):
        reset_launches()
        history = [step(state, batch, lr) for _ in range(steps)]
        torch.cuda.synchronize()
        launches = read_launches()
        want = peer_step_launches(sites, steps, light)
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want}")
        for i, m in enumerate(history):
            bad = [k for k, v in m.items() if not torch.isfinite(v).item()]
            if bad or not m["kd"].item() > 0:
                fail(f"{what}: non-finite {bad} or kd {m['kd'].item()} at "
                     f"step {i}")
        out[what] = launches
        return history

    host = synthetic_batch(PEER_B, num_classes=cfg.num_classes, seed=seed)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    step = make_train_step(cfg)
    history = run(step, batch, PEER_STEPS, False, "peer_train_step")
    ms = time_ms(lambda: step(state, batch, lr), windows=3, per_window=3)
    img_s = PEER_B / ms * 1e3
    last = history[-1]
    print(f"[12 peer] {smi}: configs/arc18_msml_peer_dec.yaml's train step "
          f"(frozen teacher, FM towers with KD, decoder), B={PEER_B}, "
          f"{cfg.num_classes} classes, bf16, host-float input: "
          f"{PEER_STEPS} steps, then {ms:.2f} ms = {img_s:.1f} img/s "
          "(median of 3 windows of 3 steps, CUDA events); last step "
          + ", ".join(f"{k} {last[k].item():.4f}" for k in (
              "total_loss", "cls_loss", "seg_loss", "kd", "grad_norm")))
    print(f"[12 peer] sites from the modules: student {sites['prelu']} "
          f"PReLU ({sites['prelu_kd']} in the KD towers) and "
          f"{sites['conv']} conv3x3, teacher {sites['prelu_teacher']} PReLU "
          f"and {sites['conv_teacher']} conv3x3; launches per step "
          + ", ".join(f"{k} {v // PEER_STEPS}" for k, v in
                      out["peer_train_step"].items()))

    host8 = synthetic_batch(PEER_B, num_classes=cfg.num_classes, seed=seed,
                            uint8=True)
    batch8 = {k: torch.as_tensor(v, device="cuda") for k, v in host8.items()}
    light = run(make_train_step(peer_config(device_light=True)), batch8,
                PEER_LIGHT_STEPS, True, "peer_train_step_light")
    print(f"[12 peer] device_light: {PEER_LIGHT_STEPS} steps on uint8 img "
          f"and ori, launches " + ", ".join(
              f"{k} {v // PEER_LIGHT_STEPS}" for k, v in
              out["peer_train_step_light"].items())
          + f" per step; kd {light[-1]['kd'].item():.4f}")

    state.model.frb.decoder_loss_weight = PEER_DECODER_WEIGHT
    dec = state.model.frb.decoder.deconv_out.weight
    dec_before = dec.detach().clone()
    try:
        m = run(step, batch, 1, False, "peer_train_step_decoder")[0]
    finally:
        state.model.frb.decoder_loss_weight = 0.0
    rec = (m["total_loss"] - m["cls_loss"] - cfg.lambda1 * m["seg_loss"]
           - float(cfg.get("kd_loss_weight", 0.0)) * m["kd"]).item()
    moved = (dec.detach() - dec_before).abs().max().item()
    if not (math.isfinite(rec) and rec > 0 and moved > 0):
        fail(f"decoder step: recover loss {rec}, decoder moved {moved}")
    print(f"[12 peer] one step with decoder_loss_weight "
          f"{PEER_DECODER_WEIGHT}: weighted recover loss {rec:.6f} "
          f"(total - cls - lambda1 seg), deconv_out moved by up to "
          f"{moved:.3g}; launches as a host-float step")
    check_teacher(state, before, "peer train step")
    print(f"[12 peer] the teacher after {state.step} steps: parameters "
          "and BN buffers bit-equal to their start, no momentum buffer, "
          "eval mode; phase 12 (a) "
          f"{time.perf_counter() - t_phase:.1f} s host clock")
    return sites, out, img_s


def phase_peer_cpu(seed: int, b: int = 4):
    """Phase 12 (b): the recipe's float32 train forward (teacher and KD on
    `ori`) on the card (TF32 off) against the CPU, same weights and
    inputs; phase 5's tolerance: relative 1e-3."""
    from msml_torch.core.precision import FULL_PRECISION, no_tf32
    from msml_torch.nn.msml import msml_from_config

    cfg = peer_config()
    gen = torch.Generator().manual_seed(seed + 12)
    x = torch.randn((b, 3, H, W), generator=gen)
    ori = torch.randn((b, 3, H, W), generator=gen)
    label = torch.randint(0, cfg.num_classes, (b,), generator=gen)
    out = {}
    with no_tf32():
        for dev in ("cuda", "cpu"):
            model = msml_from_config(cfg, policy=FULL_PRECISION, device=dev,
                                     seed=seed, head=True).train()
            with torch.no_grad():
                out[dev] = model(x.to(dev), label.to(dev), ori=ori.to(dev),
                                 train=True)
            del model
    errs = {name: rel_l2(g.cpu(), c) for name, g, c in zip(
        ("final_cls", "final_seg", "kd"), out["cuda"], out["cpu"])}
    if not all(e <= 1e-3 for e in errs.values()):
        fail(f"recipe card f32 vs CPU f32: relative errors {errs}")
    print(f"[12 peer] card f32 (TF32 off) vs CPU f32, the recipe's train "
          f"forward at B={b} with ori: relative errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (<= 1e-3); kd {out['cpu'][2].item():.6f}")


def peer_cli(seed: int, smi: str, sites: dict, npz: str, pairs_bin: str,
             scratch: str) -> dict:
    """Phase 12 (c, d): `cli.train` on the recipe from a procedural rec
    with `peer_weights` = phase 10's frb.npz of phase 6's folder, a save
    and a --resume; then the recipe's folder through `cli.test` (both
    sweeps), `cli.serve` and `--quant int8`; -> launches by path."""
    from msml_torch.cli import serve
    from msml_torch.cli import test as cli_test
    from msml_torch.cli.train import main, parse_args
    from msml_torch.core.checkpoint import all_steps
    from msml_torch.core.config import Config
    from msml_torch.core.quantize import quant_sites, quantize_eval_model
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.eval.verification import l2_normalize_np
    from msml_torch.tools.export_serving import EvalForward
    from msml_torch.tools.load_weights import is_leaf, load_source
    from msml_torch.tools.make_occluders import main as make_occluders
    from msml_torch.tools.make_synthetic_rec import write_dataset

    t_phase = time.perf_counter()
    root, occl = (os.path.join(scratch, "peer_rec"),
                  os.path.join(scratch, "peer_occ"))
    write_dataset(root, ids=PEER_REC_IDS, per_id=PEER_REC_VIEWS, size=H,
                  val_pairs=0, seed=seed, quality=80, log_every=0)
    make_occluders(occl, num=8, seed=seed)
    out = os.path.join(scratch, "peer_out")
    cfg = Config.from_dict(dict(PEER_DEC, dataset="custom",
                                num_classes=93431, rec=root,
                                occluder_root=occl, nw=PEER_NW,
                                peer_weights=npz, out_folder=out))
    argv = ["--log-every", "1", "--seed", str(seed), "--device", "cuda"]
    reset_launches()
    t0 = time.perf_counter()
    state = main(parse_args(argv + ["--steps", str(PEER_CLI_STEPS)]),
                 Config.from_dict(dict(cfg)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"peer_cli": read_launches()}
    folder = os.path.join(out, "arc18_msml_peer_dec_1")
    with open(os.path.join(folder, "training.log")) as f:
        log = f.read()
    src = load_source(npz)
    n_leaves = sum(1 for k in src if is_leaf(k))
    loaded = f"loaded {n_leaves} peer tensors from {npz}" in log
    want = peer_step_launches(sites, PEER_CLI_STEPS, False)
    losses = [float(v) for v in re.findall(r" Loss (\S+) ", log)]
    if (state.step != PEER_CLI_STEPS or launches["peer_cli"] != want
            or not loaded or not losses
            or not all(math.isfinite(v) for v in losses)):
        fail(f"peer cli: step {state.step}, launches {launches['peer_cli']} "
             f"(expected {want}), peer load logged {loaded}, losses {losses}")
    teacher = state.model.frb.peer.state_dict()
    differ = [k for k, v in src.items() if k[4:] in teacher
              and not k.endswith(("num_batches_tracked", ".features.weight"))
              and not torch.equal(teacher[k[4:]].cpu(), v.float())]
    if differ:
        fail(f"peer cli: teacher differs from frb.npz at {differ[:4]}")
    speeds = [float(v) for v in re.findall(r"Speed (\S+) samples/sec", log)]
    print(f"[12 peer] {smi}: cli.train on the recipe (dataset custom, a "
          f"procedural rec of {PEER_REC_IDS} ids x {PEER_REC_VIEWS - 2} "
          f"train views, host-float batches with ori from {PEER_NW} worker "
          f"processes, 93431 classes, B={PEER_B}, bf16), peer_weights = "
          f"phase 10's frb.npz ({n_leaves} tensors logged, the teacher "
          f"bit-equal to it after {PEER_CLI_STEPS} steps): {seconds:.1f} s "
          f"host clock (model build, pool start and a save included); Speed "
          f"(samples/s) {speeds}; losses {[round(v, 4) for v in losses]}; "
          f"launches {launches['peer_cli']}")
    del state
    state = main(parse_args(argv + ["--steps", str(PEER_RESUME_TO),
                                    "--resume"]),
                 Config.from_dict(dict(cfg)))
    with open(os.path.join(folder, "training.log")) as f:
        resumed = (f"backbone resume successfully! step={PEER_CLI_STEPS}"
                   in f.read())
    if not resumed or state.step != PEER_RESUME_TO:
        fail(f"peer cli --resume: resumed {resumed}, step {state.step}")
    print(f"[12 peer] --resume from step {PEER_CLI_STEPS} ran to step "
          f"{state.step}; checkpoints {all_steps(folder)}")

    # (d) the recipe's folder: both sweeps, the server, int8
    reset_launches()
    t0 = time.perf_counter()
    rows = cli_test.main(cli_test.parse_args(
        ["--device-sweep", "--weight_folder", folder, "--bin", pairs_bin,
         "--device", "cuda"]))
    torch.cuda.synchronize()
    launches["peer_cli_sweep"] = read_launches()
    batches = (1 + 9 * 10) * 2
    want = dict(peer_eval_launches(sites, batches), augment_batch=batches)
    if (len(rows) != 10 or launches["peer_cli_sweep"] != want
            or not all(math.isfinite(r["avg_acc"]) for r in rows)):
        fail(f"peer sweep: {len(rows)} rows, launches "
             f"{launches['peer_cli_sweep']} (expected {want})")
    print(f"[12 peer] cli.test --device-sweep on the recipe's folder, 40 "
          f"pairs: {time.perf_counter() - t0:.1f} s; avg_acc "
          + ", ".join(f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows)
          + f"; launches {launches['peer_cli_sweep']}")
    rows, host, spent = host_sweep(
        ["--weight_folder", folder, "--bin", pairs_bin, "--device", "cuda",
         "--repeats", "1"])
    forwards = host["conv3x3_fwd"] // sites["conv"]
    if (not forwards or host != peer_eval_launches(sites, forwards)
            or not all(math.isfinite(r["avg_acc"]) for r in rows)):
        fail(f"peer host sweep: launches {host}, rows {rows}")
    print(f"[12 peer] cli.test (host sweep, BB, 1 repeat) on the recipe's "
          f"folder: {spent['wall']:.1f} s ({spent['forward']:.1f} s "
          f"forward), {forwards} forwards of "
          f"{sites['prelu'] - sites['prelu_kd']} prelu_fwd and "
          f"{sites['conv']} conv3x3_fwd each; avg_acc at 0% "
          f"{rows[0]['avg_acc']:.4f}")

    state.model.eval()
    rs = np.random.RandomState(seed + 12)
    x = rs.uniform(-1, 1, (16, H, W, 3)).astype(np.float32)
    with torch.inference_mode():
        fwd = EvalForward(state.model)
        xt = torch.as_tensor(x, device="cuda")
        live = l2_normalize_np((fwd(xt) + fwd(xt.flip(2))).float().cpu()
                               .numpy())
    del fwd, state
    runner = serve.runner_from_weight_folder(folder, "cuda")
    base, httpd, batcher, _ = start_server(runner)
    try:
        _, answer = post(base + "/embed_batch", npy_bytes(x))
    finally:
        stop_server(httpd, batcher)
    served = np.asarray(answer["embeddings"], np.float64)
    cos = float(np.min(np.sum(l2_normalize_np(served) * live, axis=1)))
    if served.shape != (16, 512) or not cos >= SERVE_MIN_COS:
        fail(f"peer serve: {served.shape}, min cosine to the live model "
             f"{cos}")
    qrunner = serve.runner_from_weight_folder(folder, "cuda", quant="int8")
    reset_launches()
    q = qrunner.infer(x)
    torch.cuda.synchronize()
    launches["peer_serve_quant"] = read_launches()
    qcos = np.sum(l2_normalize_np(np.asarray(q, np.float64)) * live, axis=1)
    n_int8 = len(quant_sites(quantize_eval_model(
        load_weight_folder(folder, "cuda")[1], (H, W, 3))))
    if (not np.isfinite(q).all() or not qcos.mean() >= QUANT_MEAN_COS
            or not qcos.min() >= QUANT_FLOOR_COS
            or launches["peer_serve_quant"]["qconv_int8"] != 2 * n_int8):
        fail(f"peer int8: cosine mean {qcos.mean()} min {qcos.min()}, "
             f"launches {launches['peer_serve_quant']} ({n_int8} sites)")
    print(f"[12 peer] cli.serve on the recipe's folder: /embed_batch of 16, "
          f"min cosine to the live model {cos:.6f} (>= {SERVE_MIN_COS}); "
          f"--quant int8 ({n_int8} int8 sites: the towers' and conv_m's "
          f"convs join the flagship's), feature cosine to bf16 mean "
          f"{qcos.mean():.6f} min {qcos.min():.6f}; phase 12 (c, d) "
          f"{time.perf_counter() - t_phase:.1f} s host clock")
    return launches


def phase_peer_eval(seed: int, smi: str, sites: dict, flagship_img_s: float):
    """Phase 12 (e): the recipe's eval forward at B = 512 (the towers and
    conv_m run; the teacher, the KD towers and the decoder do not); ->
    its launches."""
    from msml_torch.kernels.augment import augment_batch
    from msml_torch.nn.msml import msml_from_config

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = augment_batch(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                      torch.rand((B, 6), generator=gen, device="cuda"))
    model = msml_from_config(peer_config(), device="cuda", seed=seed)
    with torch.inference_mode():
        reset_launches()
        feat, seg = model(x)
        torch.cuda.synchronize()
        launches = read_launches()
        if (launches != peer_eval_launches(sites, 1)
                or feat.shape != (B, 512) or not torch.isfinite(feat).all()
                or not torch.isfinite(seg).all()):
            fail(f"peer eval: launches {launches}, feature "
                 f"{tuple(feat.shape)}")
        ms = time_ms(lambda: model(x), windows=3, per_window=5)
    print(f"[12 peer] {smi}: the recipe's bf16 eval forward, B={B}: "
          f"{ms:.2f} ms = {B / ms * 1e3:.1f} img/s (the flagship's "
          f"{flagship_img_s:.1f} img/s in phase 3); launches {launches}")
    return launches


# configs/lightcnn_msml.yaml, the LightCNN-29v2 gray recipe (a CPU test pins
# the equality)
LIGHTCNN_MSML = {
    "dataset": "webface",
    "fp16": True,
    "batch_size": 256,
    "frb_type": "lightcnn",
    "osb_type": "unet",
    "use_osb": True,
    "fm_layers": [1, 1, 1, 1],
    "fm_params": [3, 2, "tanh", "add"],
    "peer_params": {"use_ori": False, "use_conv": False,
                    "mask_trans": "conv", "use_decoder": False},
    "header_type": "Softmax",
    "header_params": [64.0, 0.5, 0.0, 0.0],
    "exp_id": 1,
    "output_prefix": "light_msml",
}
LIGHT_HW = 128          # gray 128 x 128 x 1 input
LIGHT_B = 256           # the recipe's batch_size
LIGHT_STEPS = 30        # train steps on one batch
LIGHT_CLI_STEPS = 20    # cli.train on the yaml, a checkpoint every 10
LIGHT_PEER_STEPS = 2    # ... and with the frozen teacher
LIGHT_PRELU_SITES = 33  # 9 U-Net encoder + 24 FMCnn; LightCNN has none
LIGHT_CONV_SITES = 5    # osb.layer1's three, fm_ops.3's two bottleneck convs
LIGHT_CONV_SHAPES = ((64, 64, 64), (64, 32, 32), (64, 8, 8))  # (C, H, W)
LIGHT_INT8_SITES = 93   # 92 convs and the fc
LIGHT_PAIRS = 40        # the gray .bin of the sweeps
LIGHT_EMBED = 8         # /embed requests (and 16 images in one /embed_batch)


def light_config(**over):
    from msml_torch.core.config import Config, config_init

    cfg = Config.from_dict(dict(LIGHTCNN_MSML, **over))
    config_init(cfg, make_output_dir=False)
    return cfg


def light_eval_launches(forwards: int) -> dict:
    return expect(prelu_fwd=forwards * LIGHT_PRELU_SITES,
                  conv3x3_fwd=forwards * LIGHT_CONV_SITES)


def phase_light_kernels(seed: int, smi: str, model) -> dict:
    """Phase 13 (a): the kernels at the recipe's shapes against their plain
    versions, with phase 2's tolerances, and their times: `augment_batch`
    on gray images (uint8 at B = 256, the train stage; f32 at B = 512, the
    sweep) with `use_norm` off; conv3x3 forward, dX and dW at the recipe's
    routed sites (64^2, 32^2, 8^2) at B = 256; the PReLU pair at each
    distinct PReLU shape of the recipe at B = 256."""
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference)

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    shape8 = (LIGHT_B, LIGHT_HW, LIGHT_HW, 1)
    imgs8 = [torch.randint(0, 256, shape8, generator=gen, device="cuda",
                           dtype=torch.uint8) for _ in range(12)]
    imgsf = [torch.rand((B, LIGHT_HW, LIGHT_HW, 1), generator=gen,
                        device="cuda") for _ in range(3)]
    max_err = 0.0
    for img in (imgs8[0], imgsf[0]):
        n = img.shape[0]
        draws = torch.rand((n, 6), generator=gen, device="cuda")
        noise = torch.randn(img.shape, generator=gen, device="cuda")
        for fill, relight, (lo, hi) in itertools.product(
                ("black", "gauss"), (True, False), ((0, 1), (20, 51))):
            kw = dict(lo=lo, hi=hi, fill=fill, relight=relight,
                      use_norm=False)
            err = (augment_batch(img, draws, noise, **kw)
                   - augment_batch_reference(img, draws, noise, **kw)
                   ).abs().max().item()
            if not err <= KERNEL_TOL:
                fail(f"light augment {img.dtype} {tuple(img.shape)}: max abs "
                     f"diff {err} at {kw}")
            max_err = max(max_err, err)
    timed = {}
    for name, batch_imgs, kw in (
            ("train stage", imgs8, dict(lo=0, hi=1, fill="black",
                                        relight=True, use_norm=False)),
            ("sweep", imgsf, dict(MAIN_PATH, use_norm=False))):
        img = batch_imgs[0]
        draws = torch.rand((img.shape[0], 6), generator=gen, device="cuda")
        check_bit_equal(lambda: augment_batch(img, draws, **kw), name)
        moved = augment_bytes(img, draws, kw)
        ms = time_graph_ms([lambda x=x: augment_batch(x, draws, **kw)
                            for x in batch_imgs])
        plain_ms = time_ms(lambda: augment_batch_reference(img, draws, **kw))
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "shape": list(img.shape), "dtype": str(img.dtype)[6:]}
        print(f"[13a light] {smi}: augment_batch {name} at "
              f"{tuple(img.shape)} {str(img.dtype)[6:]}, use_norm off: "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms), {moved / 1e6:.1f} MB "
              f"moved, bound {bound_ms:.4f} ms = {bound_ms / ms:.1%} of the "
              "memory rate; two runs bit-equal")
    print(f"[13a light] augment_batch on gray uint8 {shape8} and f32 "
          f"{(B, LIGHT_HW, LIGHT_HW, 1)}, 8 option sets each: max abs diff "
          f"{max_err} (tolerance {KERNEL_TOL})")
    del imgs8, imgsf

    conv_errs = check_conv_shapes(gen, LIGHT_CONV_SHAPES, LIGHT_B,
                                  "[13a light conv3x3]")
    conv = time_conv_sites(gen, LIGHT_CONV_SHAPES, LIGHT_B,
                           f"[13a light conv3x3] {smi}:",
                           plain_at=LIGHT_CONV_SHAPES[0])

    sites = prelu_shapes(model, torch.zeros((2, 1, LIGHT_HW, LIGHT_HW),
                                            device="cuda"))
    if len(sites) != LIGHT_PRELU_SITES:
        fail(f"{len(sites)} PReLU sites in the LightCNN recipe, expected "
             f"{LIGHT_PRELU_SITES}")
    shapes = sorted(set(sites), key=lambda s: -s[0] * s[1] * s[2])
    prelu_errs, worst_da = check_prelu_shapes(gen, shapes, LIGHT_B)
    print(f"[13a light prelu] {len(sites)} sites, {len(shapes)} distinct "
          f"(C, H, W) {shapes} at B={LIGHT_B}, bf16 and f32: y and dx "
          "exactly equal to the plain version; dalpha relative L2 error "
          + ", ".join(f"{str(k)[6:]} {v:.2e}" for k, v in worst_da.items()))
    c, h, w = shapes[0]
    prelu = time_prelu(gen, (LIGHT_B, c, h, w), f"[13a light prelu] {smi}:")
    torch.cuda.empty_cache()
    print(f"[13a light] phase 13 (a) {time.perf_counter() - t_phase:.1f} s "
          "host clock")
    return {"augment": timed, "augment_err": max_err, "conv": conv,
            "conv_errs": conv_errs, "prelu": prelu[torch.bfloat16],
            "prelu_shape": [LIGHT_B, c, h, w], "prelu_errs": prelu_errs}


def phase_light_eval(seed: int, smi: str, model, flagship_img_s: float):
    """Phase 13 (b): the recipe's bf16 eval forward at B = 512 on gray
    128 x 128 images: (feature (B, 256), final_seg (B, 2, 128, 128)), its
    launches, img/s; against the float32 model on the card (TF32 off) and
    on the CPU; -> (launches of one forward, img/s)."""
    from msml_torch.core.precision import FULL_PRECISION, no_tf32
    from msml_torch.kernels.augment import augment_batch
    from msml_torch.nn.msml import msml_from_config

    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    x = augment_batch(torch.rand((B, LIGHT_HW, LIGHT_HW, 1), generator=gen,
                                 device="cuda"),
                      torch.rand((B, 6), generator=gen, device="cuda"),
                      use_norm=False)
    with torch.inference_mode():
        reset_launches()
        feat, seg = model(x)
        torch.cuda.synchronize()
        launches = read_launches()
        if (launches != light_eval_launches(1) or feat.shape != (B, 256)
                or seg.shape != (B, 2, LIGHT_HW, LIGHT_HW)
                or not torch.isfinite(feat).all()
                or not torch.isfinite(seg).all()):
            fail(f"light eval: launches {launches}, feature "
                 f"{tuple(feat.shape)}, seg {tuple(seg.shape)}")
        ms = time_ms(lambda: model(x), windows=3, per_window=5)
    img_s = B / ms * 1e3
    with no_tf32():
        model32 = msml_from_config(light_config(), policy=FULL_PRECISION,
                                   device="cuda", seed=seed)
        with torch.inference_mode():
            feat32, seg32 = model32(x[:64])
        del model32
    cos16 = cosines(feat[:64], feat32).min().item()
    model_cpu = msml_from_config(light_config(), policy=FULL_PRECISION,
                                 device="cpu", seed=seed)
    with torch.inference_mode():
        feat_cpu, seg_cpu = model_cpu(x[:4].cpu())
    cos_cpu = cosines(feat32[:4], feat_cpu).min().item()
    seg_err = ((seg32[:4].cpu() - seg_cpu).abs().max()
               / seg_cpu.abs().max()).item()
    if not (cos16 >= BF16_MIN_COS and cos_cpu >= CPU_MIN_COS
            and seg_err <= 1e-3):
        fail(f"light eval: bf16 vs f32 cosine {cos16}, card f32 vs CPU "
             f"cosine {cos_cpu}, relative seg err {seg_err}")
    print(f"[13b light] {smi}: configs/lightcnn_msml.yaml's bf16 eval "
          f"forward, B={B}, gray {LIGHT_HW}^2: {ms:.2f} ms = {img_s:.1f} "
          f"img/s (arc18_msml's {flagship_img_s:.1f} img/s in phase 3); "
          f"launches {launches}; bf16 vs f32 (TF32 off), 64 images: min "
          f"feature cosine {cos16:.6f} (>= {BF16_MIN_COS}); card f32 vs CPU "
          f"f32, 4 images: min cosine {cos_cpu:.8f} (>= {CPU_MIN_COS}), "
          f"relative seg err {seg_err:.2e} (<= 1e-3)")
    return launches, img_s


def phase_light_train(seed: int, smi: str):
    """Phase 13 (c): the recipe's train step, B = 256, webface's 10,572
    classes, bf16, synthetic gray uint8 batches with `device_light` (the
    augment kernel at C = 1, `use_norm` off): 30 steps on one batch lower
    total_loss, every metric finite, each kernel launched as the module
    sites say; img/s and a profile; one float32 step on the card against
    the CPU; -> (launches of the 30 steps, img/s)."""
    from msml_torch.core.config import lr_step_factor
    from msml_torch.data.synthetic import synthetic_batch
    from msml_torch.nn.common import routed_conv_sites
    from msml_torch.nn.msml import msml_from_config
    from msml_torch.train.train_step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = light_config(device_light=True)
    model = msml_from_config(cfg, device="cuda", seed=seed, head=True)
    if len(routed_conv_sites(model)) != LIGHT_CONV_SITES:
        fail(f"light: routed conv3x3 sites {routed_conv_sites(model)}")
    state = init_train_state(model, cfg, "cuda", seed)
    step = make_train_step(cfg)
    host = synthetic_batch(LIGHT_B, size=LIGHT_HW, channels=1,
                           num_classes=cfg.num_classes, seed=seed,
                           uint8=True)
    batch = {k: torch.as_tensor(host[k], device="cuda")
             for k in ("img", "label", "msk")}
    lr = lr_step_factor(cfg, 0)
    reset_launches()
    history = [step(state, batch, lr) for _ in range(LIGHT_STEPS)]
    torch.cuda.synchronize()
    launches = read_launches()
    want = per_step(LIGHT_STEPS, LIGHT_PRELU_SITES, LIGHT_CONV_SITES)
    if launches != want:
        fail(f"light train launches {launches}, expected {want}")
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not torch.isfinite(v).item()]
        if bad:
            fail(f"light train: non-finite {bad} at step {i}")
    losses = [m["total_loss"].item() for m in history]
    if not losses[-1] < losses[0]:
        fail(f"light train: total_loss did not fall: {losses}")
    ms = time_ms(lambda: step(state, batch, lr), windows=3, per_window=3)
    img_s = LIGHT_B / ms * 1e3
    print(f"[13c light] {smi}: the recipe's train step (device_light, gray "
          f"uint8), {cfg.num_classes} classes, B={LIGHT_B}, bf16, "
          f"{LIGHT_STEPS} steps on one batch: total_loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; then {ms:.2f} ms = {img_s:.1f} img/s (median "
          "of 3 windows of 3 steps, CUDA events); launches per step "
          + ", ".join(f"{k} {v // LIGHT_STEPS}" for k, v in launches.items())
          + f" ({LIGHT_PRELU_SITES} PReLU sites, {LIGHT_CONV_SITES} conv3x3 "
          "sites)")
    profile_train(lambda: step(state, batch, lr), ms, tag="[13c light]")
    del state, model, step, batch
    torch.cuda.empty_cache()
    train_cpu_parity(light_config(device_light=True, batch_size=4), seed, 4,
                     "[13c light]")
    print(f"[13c light] phase 13 (c) {time.perf_counter() - t_phase:.1f} s "
          "host clock")
    return launches, img_s


def light_cli(seed: int, smi: str) -> dict:
    """Phase 13 (d): the recipe through the entry points: `cli.train` on
    the yaml with `dataset: synthetic` (10,572 classes, host-float batches
    as the yaml runs them) for 20 steps with checkpoints; on the folder it
    wrote `cli.test --device-sweep` and the host sweep (BB) over a gray
    .bin, `cli.serve` (/embed and /embed_batch against a direct forward),
    `tools.export_serving`, `--quant int8` (every distinct int8 geometry
    bit-equal to the plain kernels, the B = 512 forward against bf16);
    then `use_ori` with `peer_weights` = the folder's backbone.pth; ->
    launches by path."""
    from concurrent.futures import ThreadPoolExecutor

    from msml_torch.cli import serve
    from msml_torch.cli import test as cli_test
    from msml_torch.cli.train import main, parse_args
    from msml_torch.core.checkpoint import all_steps
    from msml_torch.core.config import Config
    from msml_torch.core.quantize import quantize_eval_model
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.data.bin_loader import ppm_encode
    from msml_torch.eval.folder_eval import tensorize_folder_img
    from msml_torch.eval.verification import l2_normalize_np
    from msml_torch.kernels.augment import augment_batch
    from msml_torch.tools import export_serving, export_torch
    from msml_torch.tools.load_weights import is_leaf, load_source
    from msml_torch.tools.qconv_ab import int8_sites_of

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as out:
        def cfg(**over):
            return Config.from_dict(dict(LIGHTCNN_MSML, dataset="synthetic",
                                         num_classes=10572, out_folder=out,
                                         **over))

        argv = ["--ckpt-every", "10", "--log-every", "5", "--seed",
                str(seed), "--device", "cuda"]
        reset_launches()
        t0 = time.perf_counter()
        state = main(parse_args(argv + ["--steps", str(LIGHT_CLI_STEPS)]),
                     cfg())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches["light_cli"] = read_launches()
        folder = os.path.join(out, "light_msml_1")
        with open(os.path.join(folder, "training.log")) as f:
            log = f.read()
        losses = [float(v) for v in re.findall(r" Loss (\S+) ", log)]
        speeds = [float(v) for v in
                  re.findall(r"Speed (\S+) samples/sec", log)]
        want = per_step(LIGHT_CLI_STEPS, LIGHT_PRELU_SITES, LIGHT_CONV_SITES,
                        augment=0)
        if (state.step != LIGHT_CLI_STEPS or launches["light_cli"] != want
                or not speeds or not losses
                or not all(math.isfinite(v) for v in losses)
                or all_steps(folder) != [10, LIGHT_CLI_STEPS]):
            fail(f"light cli: step {state.step}, launches "
                 f"{launches['light_cli']} (expected {want}), Speed "
                 f"{speeds}, losses {losses}, checkpoints "
                 f"{all_steps(folder)}")
        print(f"[13d light] {smi}: cli.train on configs/lightcnn_msml.yaml "
              f"(dataset synthetic, 10572 classes, host-float gray batches "
              f"as the yaml runs them, B={LIGHT_B}, bf16), "
              f"{LIGHT_CLI_STEPS} steps in {seconds:.1f} s host clock (model "
              f"build and 2 checkpoints included); Speed (samples/s) "
              f"{speeds}; losses {[round(v, 4) for v in losses]}; "
              f"checkpoints {all_steps(folder)}; launches "
              f"{launches['light_cli']}")
        del state
        torch.cuda.empty_cache()

        # the sweeps on a gray .bin
        pairs_bin = pair_bin(os.path.join(out, "pairs.bin"), seed,
                             LIGHT_PAIRS, LIGHT_HW)
        reset_launches()
        t0 = time.perf_counter()
        rows = cli_test.main(cli_test.parse_args(
            ["--device-sweep", "--weight_folder", folder, "--bin",
             pairs_bin, "--device", "cuda"]))
        torch.cuda.synchronize()
        launches["light_cli_sweep"] = read_launches()
        batches = (1 + 9 * 10) * 2
        want = dict(light_eval_launches(batches), augment_batch=batches)
        if (len(rows) != 10 or launches["light_cli_sweep"] != want
                or not all(math.isfinite(r["avg_acc"]) for r in rows)):
            fail(f"light sweep: {len(rows)} rows, launches "
                 f"{launches['light_cli_sweep']} (expected {want})")
        print(f"[13d light] cli.test --device-sweep on the folder, "
              f"{LIGHT_PAIRS} gray pairs: {time.perf_counter() - t0:.1f} s; "
              "avg_acc " + ", ".join(f"{r['lo']}%: {r['avg_acc']:.4f}"
                                     for r in rows)
              + f"; launches {launches['light_cli_sweep']}")
        rows, host, spent = host_sweep(
            ["--weight_folder", folder, "--bin", pairs_bin, "--device",
             "cuda", "--repeats", "1"])
        launches["light_cli_host_sweep"] = host
        forwards = host["conv3x3_fwd"] // LIGHT_CONV_SITES
        if (not forwards or host != light_eval_launches(forwards)
                or len(rows) != 10
                or not all(math.isfinite(r["avg_acc"]) for r in rows)):
            fail(f"light host sweep: launches {host}, rows {rows}")
        print(f"[13d light] cli.test (host sweep, BB, 1 repeat, PIL 'L') on "
              f"the folder: {spent['wall']:.1f} s ({spent['forward']:.1f} s "
              f"forward), {forwards} forwards; avg_acc at 0% "
              f"{rows[0]['avg_acc']:.4f}; launches {host}")

        # cli.serve: /embed and /embed_batch against a direct forward
        rs = np.random.RandomState(seed + 13)
        raw = rs.randint(0, 256, (16 + LIGHT_EMBED, LIGHT_HW, LIGHT_HW, 3)
                         ).astype(np.uint8)
        x = np.stack([tensorize_folder_img(a, (LIGHT_HW, LIGHT_HW), False,
                                           True) for a in raw])
        _, model = load_weight_folder(folder, device="cuda")
        fwd = export_serving.EvalForward(model)
        with torch.inference_mode():
            xt = torch.as_tensor(x, device="cuda")
            ref = l2_normalize_np((fwd(xt) + fwd(xt.flip(2))).float().cpu()
                                  .numpy())
        del fwd
        runner = serve.runner_from_weight_folder(folder, "cuda")
        forwards = count_forwards(runner)
        base, httpd, batcher, _ = start_server(runner)
        try:
            forwards.clear()
            reset_launches()
            _, answer = post(base + "/embed_batch", npy_bytes(x[:16]))
            with ThreadPoolExecutor(LIGHT_EMBED) as pool:
                replies = list(pool.map(
                    lambda a: post(base + "/embed", ppm_encode(a)),
                    raw[16:]))
            torch.cuda.synchronize()
            launches["light_serve"] = read_launches()
        finally:
            stop_server(httpd, batcher)
        got = np.concatenate([np.asarray(answer["embeddings"]),
                              np.asarray([r[1]["embedding"]
                                          for r in replies])])
        cos = float(np.min(np.sum(l2_normalize_np(got) * ref, axis=1)))
        if (got.shape != (16 + LIGHT_EMBED, 256) or not cos >= SERVE_MIN_COS
                or launches["light_serve"]
                != light_eval_launches(len(forwards))):
            fail(f"light serve: {got.shape}, min cosine {cos}, launches "
                 f"{launches['light_serve']} over {len(forwards)} forwards")
        print(f"[13d light] cli.serve on the folder: /embed_batch of 16 and "
              f"{LIGHT_EMBED} concurrent /embed (PPM, gray transform): min "
              f"cosine to a direct forward {cos:.6f} (>= {SERVE_MIN_COS}); "
              f"{len(forwards)} forwards, launches {launches['light_serve']}")

        artifact = os.path.join(out, "light.pt2")
        t0 = time.perf_counter()
        export_serving.main(export_serving.parse_args(
            ["--weight_folder", folder, "--out", artifact, "--device",
             "cuda"]))
        export_s = time.perf_counter() - t0
        arunner = serve.runner_from_artifact(artifact, "cuda")
        aforwards = count_forwards(arunner)
        reset_launches()
        art = arunner.infer(x[:16])
        torch.cuda.synchronize()
        alaunches = read_launches()
        cos_art = float(np.min(np.sum(art * ref[:16], axis=1)))
        if (alaunches != light_eval_launches(len(aforwards))
                or not cos_art >= SERVE_MIN_COS):
            fail(f"light export_serving: launches {alaunches}, min cosine "
                 f"{cos_art}")
        print(f"[13d light] tools.export_serving wrote "
              f"{os.path.getsize(artifact)} bytes in {export_s:.1f} s; the "
              f"artifact's features of 16 images: min cosine to the direct "
              f"forward {cos_art:.6f}; launches {alaunches}")
        del arunner

        # --quant int8
        gen = torch.Generator(device="cuda").manual_seed(seed + 15)
        xq = augment_batch(torch.rand((B, LIGHT_HW, LIGHT_HW, 1),
                                      generator=gen, device="cuda"),
                           torch.rand((B, 6), generator=gen, device="cuda"),
                           use_norm=False)
        qmodel = quantize_eval_model(model, (LIGHT_HW, LIGHT_HW, 1))
        sites = int8_sites_of(qmodel, xq[:QUANT_CHECK_B])
        n_sites = sum(len(f) for f in sites.values())
        if n_sites != LIGHT_INT8_SITES:
            fail(f"light quant: {n_sites} int8 sites, expected "
                 f"{LIGHT_INT8_SITES}")
        err = max(check_quant_site(f[0][1], f[0][2]) for f in sites.values())
        fc = next(f[0][1] for k, f in sites.items() if k[0] == "linear")
        fc_in = {}
        hook = fc.register_forward_pre_hook(
            lambda mod, args: fc_in.setdefault("x", args[0]))
        with torch.inference_mode():
            want_f = model(xq)[0]
            torch.cuda.synchronize()
            reset_launches()
            got_q = qmodel(xq)[0]
            torch.cuda.synchronize()
            launches["light_quant"] = read_launches()
        hook.remove()
        err = max(err, check_quant_site(fc, fc_in.pop("x")))
        per_image = cosines(got_q, want_f)
        qcos, qmin = per_image.mean().item(), per_image.min().item()
        want = expect(prelu_fwd=LIGHT_PRELU_SITES,
                      quant_act=LIGHT_INT8_SITES,
                      qconv_int8=LIGHT_INT8_SITES)
        if (launches["light_quant"] != want or got_q.shape != (B, 256)
                or not torch.isfinite(got_q).all()
                or not qcos >= QUANT_MEAN_COS or not qmin >= QUANT_FLOOR_COS):
            fail(f"light quant: launches {launches['light_quant']} "
                 f"(expected {want}), feature cosine to bf16 mean {qcos} (>= "
                 f"{QUANT_MEAN_COS}), min {qmin} (>= {QUANT_FLOOR_COS})")
        with torch.inference_mode():
            ms_q = time_ms(lambda: qmodel(xq), windows=3, per_window=5)
            ms_f = time_ms(lambda: model(xq), windows=3, per_window=5)
        print(f"[13d light] {smi}: --quant int8 on the folder: "
              f"{n_sites} int8 sites in {len(sites)} distinct "
              f"geometries, quant_act and qconv_int8 bit-equal to their "
              f"plain versions at each (B = {QUANT_CHECK_B}) and at the fc "
              f"at B = {B} (max abs diff {err}); B = {B} forward: feature "
              f"cosine to bf16 mean {qcos:.6f} (>= {QUANT_MEAN_COS}), min "
              f"{qmin:.6f} (>= {QUANT_FLOOR_COS}); int8 {ms_q:.2f} ms = "
              f"{B / ms_q * 1e3:.1f} img/s, bf16 {ms_f:.2f} ms = "
              f"{B / ms_f * 1e3:.1f} img/s (same call); launches "
              f"{launches['light_quant']}")
        del qmodel, model, sites, got_q, want_f, xq
        torch.cuda.empty_cache()

        # use_ori with peer_weights = the folder's backbone.pth
        pth = os.path.join(out, "backbone.pth")
        export_torch.main(export_torch.parse_args(
            ["--weight_folder", folder, "--out", pth]))
        peer_out = os.path.join(out, "peer")
        reset_launches()
        state = main(parse_args(argv + ["--steps", str(LIGHT_PEER_STEPS)]),
                     Config.from_dict(dict(
                         LIGHTCNN_MSML, dataset="synthetic",
                         num_classes=10572, out_folder=peer_out,
                         peer_weights=pth,
                         peer_params=dict(LIGHTCNN_MSML["peer_params"],
                                          use_ori=True))))
        torch.cuda.synchronize()
        launches["light_peer_cli"] = read_launches()
        src = load_source(pth)
        n_leaves = sum(1 for k in src if k.startswith("frb.")
                       and not k.startswith(("frb.fm_ops.", "frb.peer."))
                       and is_leaf(k))
        with open(os.path.join(peer_out, "light_msml_1",
                               "training.log")) as f:
            plog = f.read()
        teacher = state.model.frb.peer.state_dict()
        differ = [k for k in teacher if not torch.equal(
            teacher[k].cpu(), src["frb." + k].float())]
        want = per_step(LIGHT_PEER_STEPS, LIGHT_PRELU_SITES,
                        LIGHT_CONV_SITES, augment=0)
        if (state.step != LIGHT_PEER_STEPS or differ
                or launches["light_peer_cli"] != want
                or f"loaded {n_leaves} peer tensors from {pth}" not in plog
                or state.model.frb.peer.training):
            fail(f"light peer cli: step {state.step}, teacher differs at "
                 f"{differ[:4]}, launches {launches['light_peer_cli']} "
                 f"(expected {want})")
        print(f"[13d light] cli.train with use_ori and peer_weights = the "
              f"folder's backbone.pth ({n_leaves} tensors logged): "
              f"{LIGHT_PEER_STEPS} steps, the PeerLightCNN teacher "
              f"bit-equal to the file after them, eval mode; launches "
              f"{launches['light_peer_cli']}; phase 13 (d) "
              f"{time.perf_counter() - t_phase:.1f} s host clock")
        del state
    torch.cuda.empty_cache()
    return launches


def phase_light(seed: int, smi: str, flagship_img_s: float):
    """Phase 13: the LightCNN-29v2 gray recipe; -> (launches by path,
    kernel results at its shapes, eval img/s, train img/s)."""
    from msml_torch.nn.msml import msml_from_config

    t_phase = time.perf_counter()
    model = msml_from_config(light_config(), device="cuda", seed=seed)
    kernels = phase_light_kernels(seed, smi, model)
    eval_launches, eval_img_s = phase_light_eval(seed, smi, model,
                                                 flagship_img_s)
    del model
    torch.cuda.empty_cache()
    train_launches, train_img_s = phase_light_train(seed, smi)
    launches = light_cli(seed, smi)
    launches.update(light_train_step=train_launches,
                    light_eval=eval_launches)
    print(f"[13 light] {smi}: phase 13 {time.perf_counter() - t_phase:.1f} "
          "s host clock")
    return launches, kernels, eval_img_s, train_img_s


def light_at_recipe_shapes(entries: list, light: dict):
    """Phase 13 (a)'s results on the kernels line: each kernel's times at
    the LightCNN recipe's shapes under "light", its error folded into
    max_abs_err."""
    for e in entries:
        name = e["name"]
        if name == "augment_batch":
            e["light"] = light["augment"]
            err = light["augment_err"]
        elif name.startswith("prelu"):
            part = "fwd" if name == "prelu_fwd" else "bwd"
            ms, plain_ms, lib_ms, bound_ms = light["prelu"][part]
            e["light"] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "shape": light["prelu_shape"]}
            err = light["prelu_errs"][part]
        elif name.startswith("conv3x3"):
            parts = ("fwd", "dx") if name == "conv3x3_fwd" else ("dw",)
            e["light"] = {"sites": {
                site: {p: {"ms": t[p][0], "plain_ms": t[p][1],
                           "library_ms": t[p][2]} for p in parts}
                | {"bound_ms": bound, "bound_by": by}
                for site, (t, bound, by) in light["conv"].items()},
                "batch": LIGHT_B}
            err = light["conv_errs"]["dw" if name == "conv3x3_dw" else "fwd"]
        else:
            continue
        e["max_abs_err"] = max(e["max_abs_err"], err)


# ------------------------------------------------------------------ phase 14

BASELINE_HW = {"cosface2018": (112, 96), "from2021": (112, 96),
               "iresnet50_v": (112, 112), "iresnet100_v": (112, 112)}
# kernel launches per eval forward, counted from each network's modules:
# (prelu_fwd, conv3x3_fwd at their (H, W))
BASELINE_SITES = {
    "cosface2018": (20, [(56, 48)] * 2),
    "from2021": (25, [(56, 48)] * 4 + [(112, 96)]),
    "iresnet50_v": (25, [(56, 56)] * 4 + [(112, 112)]),
    "iresnet100_v": (50, [(56, 56)] * 4 + [(112, 112)]),
}
BASELINE_FORWARDS = ("cosface2018", "from2021", "iresnet100_v")  # (a)
BASELINE_CLI = ("cosface2018", "from2021", "iresnet50_v")        # (c)
BASELINE_CONV_SHAPES = ((64, 56, 48), (64, 112, 96))  # (C, H, W)
BASELINE_PAIRS = 40     # the host sweeps' .bin
BASELINE_CPU_B = 8      # card f32 vs CPU f32
IJB_IDS = 20            # identities of the IJB fixture (2 templates of 3)
F32_FLOPS = 67e12       # float32 FFMA peak, outside the tensor cores


def draw_baseline_pth(network: str, seed: int, path: str) -> str:
    """A `.pth` of `network` with the reference's torch names (the port's
    modules carry them), every tensor drawn from `seed`: conv and linear
    weights N(0, 1 / fan_in), biases N(0, 0.05), BN scales U(0.5, 1.5),
    running means N(0, 0.1) and variances U(0.5, 1.5), PReLU slopes
    U(0.1, 0.4), the frozen `features` scale 1; FROM's under "state_dict",
    as its release keeps it."""
    from msml_torch.nn.baselines import cosface2018
    from msml_torch.nn.common import PReLU
    from msml_torch.nn.from2021 import From2021
    from msml_torch.nn.iresnet import IRESNET_LAYERS, PeerIResNet

    if network == "cosface2018":
        model = cosface2018()
    elif network == "from2021":
        model = From2021()
    else:
        model = PeerIResNet(IRESNET_LAYERS[network[:-2]])
    gen = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        return torch.rand(t.shape, generator=gen) * (hi - lo) + lo

    def normal(t, std):
        return torch.randn(t.shape, generator=gen) * std

    sd = model.state_dict()
    for name, m in model.named_modules():
        p = name + "." if name else ""
        if isinstance(m, PReLU):
            sd[p + "weight"] = uniform(m.weight, 0.1, 0.4)
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            sd[p + "weight"] = uniform(m.weight, 0.5, 1.5)
            sd[p + "bias"] = normal(m.bias, 0.05)
            sd[p + "running_mean"] = normal(m.running_mean, 0.1)
            sd[p + "running_var"] = uniform(m.running_var, 0.5, 1.5)
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            sd[p + "weight"] = normal(m.weight, m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                sd[p + "bias"] = normal(m.bias, 0.05)
    if "features.weight" in sd:
        sd["features.weight"] = torch.ones_like(sd["features.weight"])
    torch.save({"state_dict": sd} if network == "from2021" else sd, path)
    return path


def build_baseline(network: str, pth: str, device: str):
    """A baseline as `cli.test` makes it (`_build_baseline`): -> (cfg,
    model)."""
    from msml_torch.cli import test as cli_test

    return cli_test._build_baseline(argparse.Namespace(
        network=network, weight=pth, quant=""), torch.device(device))


def baseline_calls(model, hw) -> tuple:
    """(PReLU calls, routed conv3x3 calls' (H, W), sorted) in one eval
    forward of `model` on a zero batch of 2 at `hw`."""
    from msml_torch.nn.common import routed_conv_sites

    routed = set(routed_conv_sites(model))
    convs = []
    hooks = [m.register_forward_pre_hook(
        lambda _, a: convs.append(tuple(a[0].shape[2:])))
        for n, m in model.named_modules() if n in routed]
    try:
        prelus = prelu_shapes(model, torch.zeros((2, 3) + hw, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    return len(prelus), sorted(convs)


def baseline_launches(network: str, forwards: int, **extra) -> dict:
    prelu, convs = BASELINE_SITES[network]
    return expect(prelu_fwd=forwards * prelu,
                  conv3x3_fwd=forwards * len(convs), **extra)


def phase_baseline_forwards(seed: int, smi: str, pths: dict) -> dict:
    """Phase 14 (a): each baseline's eval forward as `cli.test` builds it
    (float32, TF32 off) at B = 512: sites counted from its modules, launches
    exactly sites x forwards, img/s, and the card against the CPU on
    BASELINE_CPU_B images; -> {network: results}."""
    from msml_torch.core.precision import no_tf32

    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    out = {}
    for network in BASELINE_FORWARDS:
        hw = BASELINE_HW[network]
        _, model = build_baseline(network, pths[network], "cuda")
        sites = baseline_calls(model, hw)
        if sites != BASELINE_SITES[network]:
            fail(f"baseline {network}: sites (PReLU, conv3x3) {sites}, "
                 f"expected {BASELINE_SITES[network]}")
        x = torch.rand((B, 3) + hw, generator=gen, device="cuda") * 2 - 1
        with no_tf32(), torch.inference_mode():
            reset_launches()
            feat = model(x)[0]
            torch.cuda.synchronize()
            once = read_launches()
            reset_launches()
            ms = time_ms(lambda: model(x), windows=3, per_window=2)
            timed = read_launches()
        if (once != baseline_launches(network, 1)
                or timed != baseline_launches(network, 3 + 3 * 2)
                or feat.shape != (B, 512) or not torch.isfinite(feat).all()):
            fail(f"baseline {network}: launches {once} / {timed} over 9 "
                 f"forwards, feature {tuple(feat.shape)}")
        _, model_cpu = build_baseline(network, pths[network], "cpu")
        with torch.inference_mode():
            feat_cpu = model_cpu(x[:BASELINE_CPU_B].cpu())[0]
        cos = cosines(feat[:BASELINE_CPU_B], feat_cpu).min().item()
        if not cos >= CPU_MIN_COS:
            fail(f"baseline {network}: card f32 vs CPU f32 feature cosine "
                 f"{cos} < {CPU_MIN_COS}")
        out[network] = {"img_s": B / ms * 1e3, "ms": ms, "launches": once,
                        "cpu_cos_min": cos}
        print(f"[14a baselines] {smi}: {network} ({hw[0]} x {hw[1]}) f32 "
              f"eval forward, TF32 off, B={B}: {ms:.2f} ms = "
              f"{B / ms * 1e3:.1f} img/s; sites counted from the modules "
              f"{sites[0]} PReLU, {len(sites[1])} conv3x3 at {sites[1]}; "
              f"launches {once} per forward, exactly sites x 9 over the "
              f"timed forwards; card vs CPU f32, {BASELINE_CPU_B} images: "
              f"min cosine {cos:.8f} (>= {CPU_MIN_COS})")
        del model, model_cpu, x, feat
        torch.cuda.empty_cache()
    return out


def phase_baseline_kernels(seed: int, smi: str, pths: dict) -> dict:
    """Phase 14 (b): the float32 kernels at the shapes the baselines give
    them at B = 512, against their plain versions, timed beside their
    bounds and the library call: `conv3x3_fwd` at (B, 64, 56, 48) and
    (B, 64, 112, 96) beside cuDNN f32 (TF32 off; on, too, for reference);
    `prelu_fwd` at every distinct PReLU shape of Sphere-20 and FROM beside
    `F.prelu`; `augment_batch` on f32 (B, 112, 96, 3)."""
    import torch.nn.functional as F

    from msml_torch.core.precision import no_tf32
    from msml_torch.kernels.augment import (augment_batch,
                                            augment_batch_reference)
    from msml_torch.kernels.conv3x3 import conv3x3_fwd, conv3x3_reference
    from msml_torch.kernels.prelu import prelu_fwd, prelu_reference

    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    res = {"conv": {}, "prelu": {}, "errs": {}}
    tol = CONV_TOL[torch.float32][0]
    err = 0.0
    for c, h, w in BASELINE_CONV_SHAPES:
        x = torch.randn((B, c, h, w), generator=gen, device="cuda")
        wt = torch.randn((c, c, 3, 3), generator=gen, device="cuda") / 24
        y = conv3x3_fwd(x, wt)
        with no_tf32():
            ref = conv3x3_reference(x, wt)
        rel = rel_l2(y, ref)
        if not (rel <= tol and torch.equal(y, conv3x3_fwd(x, wt))):
            fail(f"conv3x3 f32 {(B, c, h, w)}: relative L2 error {rel} > "
                 f"{tol}, or two runs differ")
        err = max(err, (y - ref).abs().max().item())
        del y, ref
        flops = 2 * x.numel() * 9 * c
        nbytes = 2 * x.numel() * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
              else "operations")
        with no_tf32():
            ms = time_ms(lambda: conv3x3_fwd(x, wt), windows=3, per_window=3)
            plain_ms = time_ms(lambda: conv3x3_reference(x, wt), windows=1,
                               per_window=2)
            lib_ms = time_ms(lambda: F.conv2d(x, wt, padding=1), windows=3,
                             per_window=3)
        tf32_ms = time_ms(lambda: F.conv2d(x, wt, padding=1), windows=3,
                          per_window=3)
        res["conv"][f"{h}x{w}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_tf32_ms": tf32_ms, "bound_ms": bound_ms, "bound_by": by,
            "shape": [B, c, h, w], "rel_l2": rel}
        print(f"[14b baselines conv3x3] {smi}: f32 forward at "
              f"{(B, c, h, w)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuDNN f32 (TF32 off) {lib_ms:.4f} ms, cuDNN TF32 "
              f"{tf32_ms:.4f} ms; bound {bound_ms:.4f} ms ({by}; "
              f"{flops / 1e9:.1f} GFLOP at {F32_FLOPS / 1e12:.0f} TFLOP/s, "
              f"{nbytes / 1e6:.1f} MB) = {bound_ms / ms:.1%} of it; relative "
              f"L2 error to the plain version {rel:.2e} (<= {tol}), two runs "
              "bit-equal")
        del x
        torch.cuda.empty_cache()
    res["errs"]["conv3x3_fwd"] = err

    shapes = set()
    for network in ("cosface2018", "from2021"):
        _, model = build_baseline(network, pths[network], "cuda")
        shapes |= set(prelu_shapes(model, torch.zeros(
            (2, 3) + BASELINE_HW[network], device="cuda")))
        del model
    shapes = sorted(shapes, key=lambda s: -s[0] * s[1] * s[2])
    err = 0.0
    for c, h, w in shapes:
        x = torch.randn((B, c, h, w), generator=gen, device="cuda")
        x[torch.rand(x.shape, generator=gen, device="cuda") < 0.05] = 0
        a = torch.rand((c,), generator=gen, device="cuda") * 0.5
        if not torch.equal(prelu_fwd(x, a), prelu_reference(x, a)):
            fail(f"prelu_fwd f32 {(B, c, h, w)}: not equal to the plain "
                 "version")
        del x
    for c, h, w in (s for s in shapes if s[0] == 64):
        x = torch.randn((B, c, h, w), generator=gen, device="cuda")
        a = torch.rand((c,), generator=gen, device="cuda") * 0.5
        bound_ms = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        ms = time_ms(lambda: prelu_fwd(x, a), windows=3, per_window=10)
        plain_ms = time_ms(lambda: prelu_reference(x, a), windows=3,
                           per_window=3)
        lib_ms = time_ms(lambda: F.prelu(x, a), windows=3, per_window=10)
        res["prelu"][f"{h}x{w}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "shape": [B, c, h, w]}
        print(f"[14b baselines prelu] {smi}: f32 prelu_fwd at "
              f"{(B, c, h, w)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.prelu {lib_ms:.4f} ms, bound {bound_ms:.4f} ms = "
              f"{bound_ms / ms:.1%} of the memory rate")
        del x
    print(f"[14b baselines prelu] {len(shapes)} distinct (C, H, W) of "
          f"Sphere-20 and FROM {shapes} at B={B}, f32: y exactly equal to "
          "the plain version")
    res["errs"]["prelu_fwd"] = 0.0

    h, w = BASELINE_HW["cosface2018"]
    imgs = [torch.rand((B, h, w, 3), generator=gen, device="cuda")
            for _ in range(3)]
    draws = torch.rand((B, 6), generator=gen, device="cuda")
    noise = torch.randn(imgs[0].shape, generator=gen, device="cuda")
    err = 0.0
    for fill, relight, (lo, hi) in itertools.product(
            ("black", "gauss"), (True, False), ((0, 1), (40, 41))):
        kw = dict(lo=lo, hi=hi, fill=fill, relight=relight)
        e = (augment_batch(imgs[0], draws, noise, **kw)
             - augment_batch_reference(imgs[0], draws, noise, **kw)
             ).abs().max().item()
        if not e <= KERNEL_TOL:
            fail(f"augment f32 {(B, h, w, 3)}: max abs diff {e} at {kw}")
        err = max(err, e)
    kw = dict(MAIN_PATH)
    check_bit_equal(lambda: augment_batch(imgs[0], draws, **kw),
                    f"f32 {(B, h, w, 3)}")
    moved = augment_bytes(imgs[0], draws, kw)
    ms = time_graph_ms([lambda x=x: augment_batch(x, draws, **kw)
                        for x in imgs])
    plain_ms = time_ms(lambda: augment_batch_reference(imgs[0], draws, **kw))
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    res["augment"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "bytes", "shape": [B, h, w, 3]}
    res["errs"]["augment_batch"] = err
    print(f"[14b baselines augment] {smi}: augment_batch f32 {(B, h, w, 3)} "
          f"(the baselines' device sweep), 8 option sets: max abs diff "
          f"{err} (<= {KERNEL_TOL}), two runs bit-equal; the sweep's path "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms), {moved / 1e6:.1f} MB "
          f"moved, bound {bound_ms:.4f} ms = {bound_ms / ms:.1%} of the "
          "memory rate")
    del imgs, noise
    torch.cuda.empty_cache()
    return res


def baseline_cli(seed: int, smi: str, pths: dict, scratch: str) -> dict:
    """Phase 14 (c): `cli.test --network` on the card: the host sweep (fill
    black, 1 repeat, BASELINE_PAIRS pairs) of each of BASELINE_CLI, then
    on cosface2018 `--device-sweep` and `--quant int8` (its int8 sites
    bit-equal to the plain kernels, its features' cosine to float32);
    -> launches by path."""
    from msml_torch.cli import test as cli_test
    from msml_torch.core.precision import no_tf32
    from msml_torch.core.quantize import quant_sites, quantize_eval_model
    from msml_torch.tools.qconv_ab import int8_sites_of

    bin_path = pair_bin(os.path.join(scratch, "baselines.bin"), seed,
                        BASELINE_PAIRS)
    common = ["--bin", bin_path, "--device", "cuda", "--fill_type", "black",
              "--repeats", "1"]
    forwards = 2 * 10 * math.ceil(2 * BASELINE_PAIRS / HOST_BATCH)
    launches = {}
    for network in BASELINE_CLI:
        rows, got, s = host_sweep(["--network", network, "--weight",
                                   pths[network]] + common)
        want = baseline_launches(network, forwards)
        if got != want or len(rows) != 10 or not all(
                math.isfinite(r["avg_acc"]) for r in rows):
            fail(f"cli.test --network {network}: {len(rows)} rows, "
                 f"launches {got}, expected {want}")
        launches[f"cli_{network}"] = got
        print(f"[14c baselines] {smi}: cli.test --network {network} (host "
              f"sweep, {BASELINE_PAIRS} pairs, 1 repeat): {s['wall']:.2f} s "
              f"wall, forward {s['forward']:.2f} s ({forwards} calls); "
              f"avg_acc " + ", ".join(f"{r['lo']}%: {r['avg_acc']:.4f}"
                                      for r in rows)
              + f"; launches {got}")

    net = ["--network", "cosface2018", "--weight", pths["cosface2018"]]
    rows, got, s = host_sweep(net + ["--device-sweep"] + common)
    batches = (1 + 9 * 10) * 2  # 10 repeats at 9 ratios, 2 flips
    want = baseline_launches("cosface2018", batches, augment_batch=batches)
    if got != want or len(rows) != 10:
        fail(f"cli.test --network cosface2018 --device-sweep: {len(rows)} "
             f"rows, launches {got}, expected {want}")
    launches["cli_cosface2018_device_sweep"] = got
    print(f"[14c baselines] {smi}: cli.test --network cosface2018 "
          f"--device-sweep (augment at (80, 112, 96, 3) f32): "
          f"{s['wall']:.2f} s wall; avg_acc " + ", ".join(
              f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows)
          + f"; launches {got}")

    _, model = build_baseline("cosface2018", pths["cosface2018"], "cuda")
    qmodel = quantize_eval_model(model, (112, 96, 3))
    n_sites = len(quant_sites(qmodel))
    gen = torch.Generator(device="cuda").manual_seed(seed + 42)
    x = torch.rand((B, 3, 112, 96), generator=gen, device="cuda") * 2 - 1
    sites = int8_sites_of(qmodel, x[:QUANT_CHECK_B])
    err = max(check_quant_site(f[0][1], f[0][2]) for f in sites.values())
    with no_tf32(), torch.inference_mode():
        want_f = model(x)[0]
        reset_launches()
        got_f = qmodel(x)[0]
        torch.cuda.synchronize()
        once = read_launches()
    per_image = cosines(got_f, want_f)
    want = expect(prelu_fwd=20, quant_act=n_sites, qconv_int8=n_sites)
    if (n_sites != 20 or once != want or not torch.isfinite(got_f).all()
            or not per_image.mean().item() >= QUANT_MEAN_COS
            or not per_image.min().item() >= QUANT_FLOOR_COS):
        fail(f"cosface2018 int8: {n_sites} sites (expected 20), launches "
             f"{once} (expected {want}), feature cosine to float32 mean "
             f"{per_image.mean().item()} (>= {QUANT_MEAN_COS}), min "
             f"{per_image.min().item()} (>= {QUANT_FLOOR_COS})")
    rows, got, s = host_sweep(net + ["--quant", "int8"] + common)
    # and one float forward: the quantizer's trace
    want = baseline_launches("cosface2018", 1,
                             quant_act=forwards * n_sites,
                             qconv_int8=forwards * n_sites)
    want["prelu_fwd"] += forwards * 20
    if got != want or len(rows) != 10:
        fail(f"cli.test --network cosface2018 --quant int8: {len(rows)} "
             f"rows, launches {got}, expected {want}")
    launches["cli_cosface2018_quant"] = got
    print(f"[14c baselines] {smi}: cosface2018 --quant int8: {n_sites} int8 "
          f"sites (19 of its 20 convs and the fc; the 3 -> 64 stem conv, "
          f"contraction 27, stays float32), {len(sites)} distinct "
          f"geometries, quant_act and qconv_int8 bit-equal to their plain "
          f"versions at each (f32, B = {QUANT_CHECK_B}, max abs diff {err}); "
          f"B = {B} forward against float32 (TF32 off): feature cosine mean "
          f"{per_image.mean().item():.6f} (>= {QUANT_MEAN_COS}), min "
          f"{per_image.min().item():.6f} (>= {QUANT_FLOOR_COS}); "
          f"launches {once} per forward; cli.test --quant int8 host sweep "
          f"{s['wall']:.2f} s wall, avg_acc " + ", ".join(
              f"{r['lo']}%: {r['avg_acc']:.4f}" for r in rows)
          + f"; launches {got}")
    del model, qmodel, x
    torch.cuda.empty_cache()
    return launches


def cli_ijb(seed: int, folder: str, scratch: str, smi: str) -> dict:
    """Phase 14 (d), on phase 6's folder: `cli.eval_ijb` over an IJB root
    that the port's fixture tool writes (IJB_IDS identities, 2 templates of
    3 images each), without occlusion and with `--lo 40 --hi 41` (10
    repeats): TPR@FPR, the artifacts, launches per batch (the image and
    its flip); -> launches by run."""
    import io

    from msml_torch.cli import eval_ijb
    from msml_torch.tools import make_synthetic_eval_fixtures

    t0 = time.perf_counter()
    root = os.path.join(scratch, "ijb_fixture")
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic_eval_fixtures.main(
            ["--out", root, "--ids", str(IJB_IDS), "--seed", str(seed)])
    images = IJB_IDS * 2 * 3
    print(f"[14d ijb] the port's make_synthetic_eval_fixtures: {images} "
          f"IJB crops ({IJB_IDS} ids, 2 templates of 3) in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        import matplotlib  # noqa: F401
        has_pdf = True
    except ImportError:
        has_pdf = False
    launches = {}
    for tag, occ, repeats in (("plain", [], 1),
                              ("occ", ["--lo", "40", "--hi", "41"], 10)):
        art = os.path.join(scratch, f"ijb_{tag}")
        reset_launches()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            table = eval_ijb.main(eval_ijb.parse_args(
                ["--weight_folder", folder, "--ijb-root",
                 os.path.join(root, "ijb"), "--device", "cuda",
                 "--artifact-dir", art] + occ))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_launches()
        forwards = repeats * 2 * math.ceil(images / 128)
        want = expect(prelu_fwd=forwards * PRELU_SITES,
                      conv3x3_fwd=forwards * CONV_SITES)
        made = sorted(os.listdir(art)) if os.path.isdir(art) else []
        need = ["ijbc_scores.npy", "ijbc_tpr_fpr.csv"] + (
            ["ijbc.pdf"] if has_pdf else [])
        scores = (np.load(os.path.join(art, "ijbc_scores.npy"))
                  if "ijbc_scores.npy" in made else np.zeros(0))
        if (got != want or not set(need) <= set(made)
                or not all(0 <= v <= 1 for v in table.values())
                or not np.isfinite(scores).all() or scores.size == 0):
            fail(f"cli.eval_ijb {tag}: launches {got} (expected {want}), "
                 f"artifacts {made} (need {need}), table {table}")
        launches[f"cli_eval_ijb_{tag}"] = got
        print(f"[14d ijb] {smi}: cli.eval_ijb on phase 6's folder (bf16), "
              f"{images} crops, {len(scores)} template pairs, {repeats} "
              f"repeat(s){' of --lo 40 --hi 41' if occ else ''}: "
              f"{seconds:.1f} s host clock; TPR@FPR " + ", ".join(
                  f"{k:g}: {v * 100:.2f}%" for k, v in table.items())
              + f"; artifacts {made}"
              + ("" if has_pdf else " (no matplotlib: no pdf)")
              + f"; launches {got} = {forwards} forwards (2 a batch of "
              f"128) x sites")
    return launches


def phase_baselines(seed: int, smi: str) -> tuple:
    """Phase 14 (a) to (c): -> (launches by path, kernel results)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as scratch:
        pths = {n: draw_baseline_pth(n, seed + 43 + i,
                                     os.path.join(scratch, f"{n}.pth"))
                for i, n in enumerate(BASELINE_HW)}
        forwards = phase_baseline_forwards(seed, smi, pths)
        kernels = phase_baseline_kernels(seed, smi, pths)
        launches = baseline_cli(seed, smi, pths, scratch)
    launches.update({f"baseline_{n}": r["launches"]
                     for n, r in forwards.items()})
    kernels["img_s"] = {n: r["img_s"] for n, r in forwards.items()}
    print(f"[14 baselines] {smi}: phase 14 (a-c) "
          f"{time.perf_counter() - t_phase:.1f} s host clock")
    return launches, kernels


def baselines_at_their_shapes(entries: list, res: dict):
    """Phase 14 (b)'s results on the kernels line: each kernel's f32 times
    at the baselines' shapes under "baselines", its error folded into
    max_abs_err."""
    for e in entries:
        name = e["name"]
        if name == "augment_batch":
            e["baselines"] = res["augment"]
        elif name == "prelu_fwd":
            e["baselines"] = {"sites": res["prelu"], "dtype": "float32"}
        elif name == "conv3x3_fwd":
            e["baselines"] = {"sites": res["conv"], "dtype": "float32"}
        else:
            continue
        e["max_abs_err"] = max(e["max_abs_err"], res["errs"][name])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    t_run = time.perf_counter()
    clock = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0

    smi = timed("1", phase_device)
    timed("1", phase_build)
    augment_entry = timed("2", phase_kernel, args.seed)
    uint8 = timed("2", phase_kernel_uint8, args.seed)
    prelu_entries = timed("2", phase_kernel_prelu, args.seed)
    conv_entries = timed("2", phase_kernel_conv, args.seed)
    model, eval_img_s = timed("3", phase_model, args.seed)
    sweep_launches = timed("4", phase_sweep, args.seed, model)
    timed("11", quant_random_init, args.seed, smi, model)
    del model
    train_launches, train_img_s = timed("5", phase_train, args.seed)
    timed("5", phase_train_cpu_parity, args.seed)
    peer_sites, peer_launches, peer_img_s = timed(
        "12", phase_peer_train, args.seed, smi)
    timed("12", phase_peer_cpu, args.seed)
    peer_launches["peer_eval"] = timed(
        "12", phase_peer_eval, args.seed, smi, peer_sites, eval_img_s)
    (cli_launches, cli_speeds, cli_sweep_launches, serve_launches,
     serve_errs, host_launches, quant, peer_cli_launches,
     ijb_launches) = timed("6, 8, 10, 11, 12d, 14d", phase_cli, args.seed,
                           smi, peer_sites)
    peer_launches.update(peer_cli_launches)
    quant_entries, quant_launches, quant_sweep_launches, quant_serve = quant
    rec_launches = timed("9", phase_data, args.seed, smi, cli_speeds)
    light_launches, light, light_eval_img_s, light_train_img_s = timed(
        "13", phase_light, args.seed, smi, eval_img_s)
    baseline_path_launches, baselines = timed("14a-c", phase_baselines,
                                          args.seed, smi)
    baseline_path_launches.update(ijb_launches)

    # this slice's path is the training CLI: its launches; the uint8 input
    # stage's times at B = 128, and the eval and train-step paths' launches
    # kept beside them
    augment_entry["sweep"] = {k: augment_entry.pop(k) for k in (
        "ms", "plain_ms", "bound_ms")}
    augment_entry.update(uint8)
    augment_entry["max_abs_err"] = max(augment_entry["max_abs_err"],
                                       uint8["max_abs_err"])
    entries = [augment_entry] + prelu_entries + conv_entries + quant_entries
    for e in entries:
        # the int8 kernels' path is phase 11's quantized forward; the
        # others' the training CLI
        e["launches"] = (quant_launches if e in quant_entries
                         else cli_launches)[e["name"]]
        e["launches_quant"] = quant_launches[e["name"]]
        e["launches_cli_quant_sweep"] = quant_sweep_launches[e["name"]]
        e["launches_serve_quant"] = quant_serve[e["name"]]
        e["launches_sweep"] = sweep_launches[e["name"]]
        e["launches_train_step"] = train_launches[e["name"]]
        e["launches_cli_sweep"] = cli_sweep_launches[e["name"]]
        e["launches_serve"] = serve_launches[e["name"]]
        e["launches_cli_rec"] = rec_launches[e["name"]]
        e["launches_cli_host_sweep"] = host_launches[e["name"]]
        for path, counts in peer_launches.items():
            e["launches_" + path] = counts[e["name"]]
        for path, counts in light_launches.items():
            e["launches_" + path] = counts[e["name"]]
        for path, counts in baseline_path_launches.items():
            e["launches_" + path] = counts[e["name"]]
        e["max_abs_err"] = max(e["max_abs_err"],
                               serve_errs.get(e["name"], 0.0))
    light_at_recipe_shapes(entries, light)
    baselines_at_their_shapes(entries, baselines)
    img_s = quant_entries[0]["img_s"]
    print(f"[7 summary] {smi}: the run in "
          f"{time.perf_counter() - t_run:.1f} s host clock; CLI "
          f"{cli_speeds[-1]:.1f} img/s (last Speed "
          f"line); int8 eval forward {img_s['int8']:.1f} img/s (bf16 "
          f"{img_s['bf16']:.1f}, same call) at B={B}; "
          f"train step {train_img_s:.1f} img/s bf16 at B={B_TRAIN}; eval "
          f"forward {eval_img_s:.1f} img/s at B={B}; the peer-KD recipe's "
          f"train step {peer_img_s:.1f} img/s bf16 at B={PEER_B}; the "
          f"LightCNN recipe's train step {light_train_img_s:.1f} img/s bf16 "
          f"at B={LIGHT_B}, its eval forward {light_eval_img_s:.1f} img/s at "
          f"B={B}; the baselines' f32 eval forwards "
          + ", ".join(f"{n} {v:.1f} img/s"
                      for n, v in baselines["img_s"].items())
          + f" at B={B}; "
          + "; ".join(f"{e['name']} {e['ms']:.4f} ms (bound "
                      f"{e['bound_ms']:.4f} ms)" for e in entries))
    print(f"[7 summary] {smi}: host seconds by phase "
          + ", ".join(f"{k}: {v:.1f}" for k, v in clock.items()))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
