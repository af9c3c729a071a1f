"""Training entry point on one GPU.

Counterpart of the single-device path of `msml_tpu/cli/train.py` (reference
`train.py:29-380`): config init, the dataset (synthetic, or a RecordIO
rec with online occlusion, `data/face_dataset.py`), MSML with its head, SGD
with the reference's LR groups, the LambdaLR epoch schedule, grad clip 5,
per-epoch and periodic checkpoints (asynchronous unless `--sync-ckpt`),
throughput logging, TensorBoard scalars (`--tensorboard`), verification,
and `--resume`.

    python -m msml_torch.cli.train --config config.yaml [--resume] [--occ 1]
    python -m msml_torch.cli.train --config config.yaml --steps 20  # smoke
    python -m msml_torch.cli.train --config config.yaml --device cpu

A RecordIO dataset (`dataset: webface`, `ms1m-retinaface-t2` or `custom`
with a `rec` folder holding `train.rec` / `train.idx`) needs Pillow and
OpenCV; with `nw` > 0 its samples are made by `nw` spawned worker
processes. Occluder PNGs are read from the config's `occluder_root`, else
MSML_OCCLUDER_DIR, else `msml_torch/data/occluder_assets`
(`python -m msml_torch.tools.make_occluders` writes stand-ins).

Runs on `cuda` unless `--device cpu` is given. Without `--config` the
reference defaults (`default_config()`, the peer-KD recipe of
`configs/arc18_msml_peer_dec.yaml`: the frozen teacher, the FM towers and
the recover decoder) are used with `dataset: synthetic`. A config without
`device_light` feeds the step float images normalized on the host (and,
with the teacher, the clean `ori` beside them). `main(args, cfg)` also
takes a Config in place of the YAML file (the card's machine has no
PyYAML).

A config's `pretrained_backbone` and `peer_weights` (each a `.npz` of
`tools/export_frb.py`, a reference or exported `backbone.pth`, a vanilla
iResNet or LightCNN `.pth` or a `ckpt/<step>.pt`) are overlaid on the
fresh model, the first on the backbone and the second on the frozen
teacher, before the first step (`tools/load_weights.py`); `--resume`
then wins over both.

On `--resume` the run continues from the latest checkpoint's step and, as
the JAX CLI does (`msml_tpu/cli/train.py:276-306`), replays the
interrupted epoch from its first batch. SIGTERM saves a checkpoint at the
next step boundary and exits cleanly. Both FRB families train: the
iResNet recipes and the LightCNN-29v2 gray recipe
(`configs/lightcnn_msml.yaml`: 128 x 128 x 1 batches, no input
normalization, its frozen `PeerLightCNN` teacher with `use_ori`). Not
ported yet, and refused: `--strategy`, `--scan-steps` above 1,
`--multihost`, PartialFC and a `dropout` other than 0.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import signal
import time

import torch

# what a RecordIO dataset imports, and the package that provides it
RECORDIO_NEEDS = (("PIL", "Pillow"), ("cv2", "OpenCV (opencv-python)"))


def build_dataset(cfg, args):
    """The dataset of `msml_tpu/cli/train.py:37-59` on one process (shard 0
    of 1): synthetic, or `FaceByRandOccMask` over `cfg.rec` with the same
    arguments, yielding uint8 images when `device_light` is set."""
    from msml_torch.data.synthetic import SyntheticDataset

    device_light = bool(cfg.get("device_light"))
    if cfg.dataset == "synthetic" or not cfg.rec:
        return SyntheticDataset(
            batch_size=cfg.batch_size, steps_per_epoch=args.steps or 100,
            size=cfg.out_size[0], channels=1 if cfg.is_gray else 3,
            num_classes=cfg.num_classes, uint8=device_light)
    for module, package in RECORDIO_NEEDS:
        try:
            importlib.import_module(module)
        except ImportError as e:
            raise ImportError(
                f"the RecordIO dataset at {cfg.rec!r} needs {package} "
                f"(import {module} failed: {e})") from e
    from msml_torch.data.face_dataset import FaceByRandOccMask

    return FaceByRandOccMask(
        root_dir=cfg.rec, batch_size=cfg.batch_size, out_size=cfg.out_size,
        use_norm=cfg.use_norm, is_gray=cfg.is_gray,
        use_ori=bool(cfg.peer_params.get("use_ori")), occ=bool(args.occ),
        occluder_root=cfg.get("occluder_root") or None,
        num_workers=int(cfg.get("nw", 32)) or 32, seed=args.seed,
        gauss_light=bool(cfg.get("gauss_light", True)),
        raw_uint8=device_light, shard_id=0, num_shards=1)


def not_ported(args, cfg) -> list:
    return [name for name, on in (
        ("--strategy " + args.strategy, bool(args.strategy)),
        ("--scan-steps %d" % args.scan_steps, args.scan_steps != 1),
        ("--multihost", args.multihost),
        ("PartialFC (sample_rate < 1 or use_partial_fc)",
         float(cfg.get("sample_rate", 1.0)) < 1.0
         or bool(cfg.get("use_partial_fc", False)))) if on]


def main(args, cfg=None):
    """Train; returns the final `train_step.TrainState`. SIGTERM sets a
    flag that the loop reads at each step boundary (`msml_tpu/cli/
    train.py:62-91`); the previous handler comes back on return."""
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    prev = signal.getsignal(signal.SIGTERM)
    installed = False
    try:
        signal.signal(signal.SIGTERM, on_sigterm)
        installed = True
    except ValueError:
        pass  # not the main thread
    try:
        return _main_inner(args, cfg, preempted)
    finally:
        if installed:
            signal.signal(signal.SIGTERM,
                          prev if prev is not None else signal.SIG_DFL)


def _main_inner(args, cfg, preempted):
    from msml_torch import resolve_device
    from msml_torch.core import checkpoint as ckpt
    from msml_torch.core.callbacks import CallBackVerification
    from msml_torch.core.config import (config_init, default_config,
                                        load_yaml, lr_step_factor,
                                        save_yaml, user_config_dict)
    from msml_torch.core.logging import (AverageMeter, MetricsWriter,
                                         ThroughputLogger, init_logging)
    from msml_torch.core.precision import policy_from_config
    from msml_torch.data.pipeline import device_prefetch
    from msml_torch.data.synthetic import SyntheticDataset
    from msml_torch.nn.msml import msml_from_config
    from msml_torch.tools.load_weights import load_pretrained
    from msml_torch.train.train_step import (init_train_state,
                                             make_eval_step, make_train_step)

    device = resolve_device(args.device)
    from_file = cfg is None and bool(args.config) \
        and os.path.exists(args.config)
    if cfg is None:
        if from_file:
            cfg = load_yaml(args.config)
        else:
            cfg = default_config()
            cfg.dataset = "synthetic"
    refused = not_ported(args, cfg)
    if refused:
        raise NotImplementedError("not ported yet: " + ", ".join(refused))
    config_init(cfg)
    # self-describing weight folder (train.py:71-72)
    dst = os.path.join(cfg.output, "config.yaml")
    if from_file:
        if not (os.path.exists(dst) and os.path.samefile(args.config, dst)):
            shutil.copy(args.config, dst)
    else:
        save_yaml(user_config_dict(cfg), dst)

    logger = init_logging(cfg.output)
    logger.info("device: %s (%s); config: %s" % (
        device, torch.cuda.get_device_name(device)
        if device.type == "cuda" else "host", dict(cfg)))
    policy = policy_from_config(bool(cfg.get("fp16", True)))
    model = msml_from_config(cfg, policy=policy, device=device,
                             seed=args.seed, head=True)
    state = init_train_state(model, cfg, device, args.seed)
    # pretrained backbone overlay (iresnet.py:410-442); a resume wins
    load_pretrained(state, cfg)
    step_fn = make_train_step(cfg)

    if args.resume:
        if ckpt.restore_checkpoint(cfg.output, state) is not None:
            logger.info("backbone resume successfully! step=%d" % state.step)
        else:
            logger.info("resume fail, backbone init successfully!")
    # async saves overlap the write with training (--sync-ckpt: blocking)
    ckpt_writer = ckpt.CheckpointWriter(cfg.output,
                                        async_save=not args.sync_ckpt)

    trainset = build_dataset(cfg, args)
    steps_per_epoch = len(trainset) // cfg.batch_size
    total_step = steps_per_epoch * cfg.num_epoch
    if args.steps:
        total_step = min(total_step, args.steps)
    logger.info("Total Step is: %d" % total_step)
    # spawned worker processes for a RecordIO dataset (train.py:295-300)
    use_procs = cfg.get("nw", 0) > 0 and \
        not isinstance(trainset, SyntheticDataset)
    workers = "no worker processes"
    if use_procs:  # started here, not on device_prefetch's thread
        t0 = time.perf_counter()
        trainset._get_pool()
        workers = "%d worker processes (started in %.2f s)" % (
            trainset.num_workers, time.perf_counter() - t0)
    logger.info("data: %s, %d samples, %s" % (
        type(trainset).__name__, len(trainset), workers))

    loss_meter = AverageMeter()
    writer = None
    if args.tensorboard:
        writer = MetricsWriter(os.path.join(cfg.output, "tb"), logger)
    tlog = ThroughputLogger(args.log_every, total_step, cfg.batch_size, 1,
                            logger, writer=writer)
    callback_verification = CallBackVerification(
        args.ver_every, cfg.get("val_targets", []), cfg.rec,
        make_eval_step(model), image_size=cfg.out_size, is_gray=cfg.is_gray,
        use_norm=cfg.use_norm, logger=logger)

    global_step = state.step

    def every(n: int) -> bool:
        return bool(n) and global_step % n == 0

    start_epoch = global_step // max(steps_per_epoch, 1)
    done = preempt_exit = False
    try:
        for epoch in range(start_epoch, cfg.num_epoch):
            lr_factor = lr_step_factor(cfg, epoch)
            epoch_iter = (trainset.epoch(epoch, use_processes=True)
                          if use_procs else trainset.epoch(epoch))
            for batch in device_prefetch(epoch_iter, device):
                metrics = step_fn(state, batch, lr_factor)
                global_step += 1
                loss_meter.update(float(metrics["total_loss"]))
                tlog(global_step, loss_meter, epoch,
                     extra="lr_factor %.4f" % lr_factor)
                if every(100):
                    logger.info(
                        "[exp_%s] seg_loss=%.4f, cls_loss=%.4f, "
                        "kd_loss=%.4f, grad_norm=%.3f" % (
                            cfg.exp_id, float(metrics["seg_loss"]),
                            float(metrics["cls_loss"]), float(metrics["kd"]),
                            float(metrics["grad_norm"])))
                    if writer is not None:
                        for tag in ("seg_loss", "cls_loss", "grad_norm"):
                            writer.scalar(tag, float(metrics[tag]),
                                          global_step)
                        writer.scalar("kd_loss", float(metrics["kd"]),
                                      global_step)
                        writer.scalar("lr_factor", lr_factor, global_step)
                if every(args.ver_every):
                    callback_verification(global_step)
                if every(args.ckpt_every):
                    ckpt_writer.save(state, global_step)
                    logger.info("periodic checkpoint at step %d (%.3f s on "
                                "the loop)" % (global_step,
                                               ckpt_writer.save_seconds))
                if preempted["flag"]:
                    ckpt_writer.save(state, global_step)
                    ckpt_writer.wait()  # durable before the process ends
                    logger.warning("SIGTERM received: preemption checkpoint "
                                   "saved at step %d, exiting cleanly "
                                   "(resume with --resume)" % global_step)
                    done = preempt_exit = True
                    break
                if args.steps and global_step >= args.steps:
                    done = True
                    break
            if not preempt_exit:
                ckpt_writer.save(state, global_step)
                logger.info("checkpoint saved at step %d (epoch %d) (%.3f s "
                            "on the loop)" % (global_step, epoch,
                                              ckpt_writer.save_seconds))
            if done:
                break
    finally:
        if hasattr(trainset, "close"):
            trainset.close()
        ckpt_writer.close()  # waits for an async save in flight
        if writer is not None:
            writer.close()
    logger.info("training finished at step %d" % global_step)
    return state


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="msml_torch training")
    p.add_argument("--config", type=str, default="config.yaml")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--occ", type=int, default=1,
                   help="use occlusion augmentation (train.py:378)")
    p.add_argument("--steps", type=int, default=0,
                   help="stop after N steps (smoke runs)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--ver-every", type=int, default=8000,
                   help="verification cadence (train.py:215)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="periodic mid-epoch checkpoint interval (steps)")
    p.add_argument("--sync-ckpt", action="store_true",
                   help="blocking checkpoint saves (default: asynchronous "
                        "saves whose write overlaps training)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--strategy", type=str, default="",
                   help="not ported yet (one GPU only)")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="not ported yet (1 only)")
    p.add_argument("--multihost", action="store_true",
                   help="not ported yet")
    p.add_argument("--tensorboard", action="store_true",
                   help="write TensorBoard scalars to <output>/tb")
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
