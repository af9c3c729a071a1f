"""Training entry point on one GPU.

Counterpart of the single-device path of `msml_tpu/cli/train.py` (reference
`train.py:29-380`): config init, the dataset, MSML with its head, SGD with
the reference's LR groups, the LambdaLR epoch schedule, grad clip 5,
per-epoch and periodic checkpoints, throughput logging, verification, and
`--resume`.

    python -m msml_torch.cli.train --config config.yaml [--resume]
    python -m msml_torch.cli.train --config config.yaml --steps 20  # smoke
    python -m msml_torch.cli.train --config config.yaml --device cpu

Runs on `cuda` unless `--device cpu` is given. Without `--config` the
reference defaults (`default_config()`) are used with `dataset:
synthetic`; their peer teacher (`use_ori: true`) is not ported, so such a
run stops with NotImplementedError. `main(args, cfg)` also takes a Config
in place of the YAML file (the card's machine has no PyYAML).

On `--resume` the run continues from the latest checkpoint's step and, as
the JAX CLI does (`msml_tpu/cli/train.py:276-306`), replays the
interrupted epoch from its first batch. SIGTERM saves a checkpoint at the
next step boundary and exits cleanly. Not ported yet, and refused: a
RecordIO dataset (`data/face_dataset.py`), `--strategy`, `--scan-steps`
above 1, `--multihost`, `--tensorboard` and PartialFC.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal

import torch


def build_dataset(cfg, args):
    """The synthetic dataset (`msml_tpu/cli/train.py:37-49`); a RecordIO
    dataset is not ported yet."""
    from msml_torch.data.synthetic import SyntheticDataset

    if cfg.dataset == "synthetic" or not cfg.rec:
        return SyntheticDataset(
            batch_size=cfg.batch_size, steps_per_epoch=args.steps or 100,
            size=cfg.out_size[0], channels=1 if cfg.is_gray else 3,
            num_classes=cfg.num_classes,
            uint8=bool(cfg.get("device_light")))
    raise NotImplementedError(
        f"the RecordIO dataset at {cfg.rec!r} (data/face_dataset.py) is not "
        "ported yet; use dataset: synthetic")


def not_ported(args, cfg) -> list:
    return [name for name, on in (
        ("--strategy " + args.strategy, bool(args.strategy)),
        ("--scan-steps %d" % args.scan_steps, args.scan_steps != 1),
        ("--multihost", args.multihost),
        ("--tensorboard", args.tensorboard),
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
    from msml_torch.core.logging import (AverageMeter, ThroughputLogger,
                                         init_logging)
    from msml_torch.core.precision import policy_from_config
    from msml_torch.data.pipeline import device_prefetch
    from msml_torch.nn.msml import msml_from_config
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
    step_fn = make_train_step(cfg)

    if args.resume:
        if ckpt.restore_checkpoint(cfg.output, state) is not None:
            logger.info("backbone resume successfully! step=%d" % state.step)
        else:
            logger.info("resume fail, backbone init successfully!")
    ckpt_writer = ckpt.CheckpointWriter(cfg.output)  # --sync-ckpt: always

    trainset = build_dataset(cfg, args)
    steps_per_epoch = len(trainset) // cfg.batch_size
    total_step = steps_per_epoch * cfg.num_epoch
    if args.steps:
        total_step = min(total_step, args.steps)
    logger.info("Total Step is: %d" % total_step)

    loss_meter = AverageMeter()
    tlog = ThroughputLogger(args.log_every, total_step, cfg.batch_size, 1,
                            logger)
    callback_verification = CallBackVerification(
        args.ver_every, cfg.get("val_targets", []), cfg.rec,
        make_eval_step(model), image_size=cfg.out_size, is_gray=cfg.is_gray,
        use_norm=cfg.use_norm, logger=logger)

    global_step = state.step

    def every(n: int) -> bool:
        return bool(n) and global_step % n == 0

    start_epoch = global_step // max(steps_per_epoch, 1)
    done = preempt_exit = False
    for epoch in range(start_epoch, cfg.num_epoch):
        lr_factor = lr_step_factor(cfg, epoch)
        for batch in device_prefetch(trainset.epoch(epoch), device):
            metrics = step_fn(state, batch, lr_factor)
            global_step += 1
            loss_meter.update(float(metrics["total_loss"]))
            tlog(global_step, loss_meter, epoch,
                 extra="lr_factor %.4f" % lr_factor)
            if every(100):
                logger.info(
                    "[exp_%s] seg_loss=%.4f, cls_loss=%.4f, kd_loss=%.4f, "
                    "grad_norm=%.3f" % (
                        cfg.exp_id, float(metrics["seg_loss"]),
                        float(metrics["cls_loss"]), float(metrics["kd"]),
                        float(metrics["grad_norm"])))
            if every(args.ver_every):
                callback_verification(global_step)
            if every(args.ckpt_every):
                ckpt_writer.save(state, global_step)
                logger.info("periodic checkpoint at step %d" % global_step)
            if preempted["flag"]:
                ckpt_writer.save(state, global_step)
                ckpt_writer.wait()
                logger.warning("SIGTERM received: preemption checkpoint "
                               "saved at step %d, exiting cleanly (resume "
                               "with --resume)" % global_step)
                done = preempt_exit = True
                break
            if args.steps and global_step >= args.steps:
                done = True
                break
        if not preempt_exit:
            ckpt_writer.save(state, global_step)
            logger.info("checkpoint saved at step %d (epoch %d)"
                        % (global_step, epoch))
        if done:
            break
    ckpt_writer.close()
    logger.info("training finished at step %d" % global_step)
    return state


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="msml_torch training")
    p.add_argument("--config", type=str, default="config.yaml")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--steps", type=int, default=0,
                   help="stop after N steps (smoke runs)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--ver-every", type=int, default=8000,
                   help="verification cadence (train.py:215)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="periodic mid-epoch checkpoint interval (steps)")
    p.add_argument("--sync-ckpt", action="store_true",
                   help="blocking checkpoint saves (the port's saves are "
                        "always blocking)")
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
                   help="not ported yet")
    return p.parse_args(argv)


def cli():
    """Console entry point."""
    main(parse_args())


if __name__ == "__main__":
    cli()
