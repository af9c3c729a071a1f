"""Training observability: throughput logger, file + stdout logging and
TensorBoard scalars.

The port's own copy of `msml_tpu/core/logging.py` (`AverageMeter`,
`init_logging`, `MetricsWriter`, `ThroughputLogger`), with the same log
lines and scalar tags. Parity targets:
  * `AverageMeter` — `utils/utils_logging.py:6-26`
  * rank-0 file + stdout logging to `{output}/training.log` —
    `utils/utils_logging.py:29-39`
  * `CallBackLogging` — `utils/utils_callbacks.py:55-97`: every N steps log
    samples/sec (global and per device), smoothed loss, epoch, ETA hours.
"""

from __future__ import annotations

import logging
import os
import sys
import time


class AverageMeter:
    """utils/utils_logging.py:6-26."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


LOGGER = "msml_torch"


def init_logging(output_dir: str) -> logging.Logger:
    """File + stdout logging (utils/utils_logging.py:29-39) on the
    `msml_torch` logger."""
    os.makedirs(output_dir, exist_ok=True)
    logger = logging.getLogger(LOGGER)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s-%(message)s")
    fh = logging.FileHandler(os.path.join(output_dir, "training.log"))
    sh = logging.StreamHandler(sys.stdout)
    fh.setFormatter(fmt)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class MetricsWriter:
    """Optional TensorBoard scalar writer. The reference plumbs a `writer`
    into CallBackLogging but always passes None (utils/utils_callbacks.py:
    80-82, train.py:217); here it is a working option (cli.train
    --tensorboard). Degrades to a no-op with a warning when the backend
    (torch.utils.tensorboard) is unavailable, so training never depends on
    the plotting stack."""

    def __init__(self, logdir: str, logger: logging.Logger | None = None):
        self._w = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(log_dir=logdir)
        except ImportError as e:  # tensorboard missing: scalars off
            (logger or logging.getLogger(LOGGER)).warning(
                "tensorboard writer unavailable (%s); scalars disabled", e)

    def scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
            self._w = None


class ThroughputLogger:
    """CallBackLogging parity (utils/utils_callbacks.py:55-97)."""

    def __init__(self, frequency: int, total_step: int, global_batch: int,
                 num_chips: int, logger: logging.Logger,
                 writer: "MetricsWriter | None" = None):
        self.frequency = frequency
        self.total_step = total_step
        self.global_batch = global_batch
        self.num_chips = max(num_chips, 1)
        self.logger = logger
        self.writer = writer
        self.time_start = time.time()
        self.tic = None
        self.last_step = 0

    def __call__(self, global_step: int, loss: AverageMeter, epoch: int,
                 extra: str = ""):
        # boundary-crossing check (not modulo), as the JAX logger does
        if (global_step <= 0
                or global_step // self.frequency
                <= self.last_step // self.frequency):
            return
        if self.tic is None:  # first boundary: start the clock
            self.tic = time.time()
            self.last_step = global_step
            return
        now = time.time()
        speed = ((global_step - self.last_step) * self.global_batch
                 / (now - self.tic))
        self.tic = now
        self.last_step = global_step
        time_now = (now - self.time_start) / 3600
        time_total = time_now / (global_step / max(self.total_step, 1))
        eta = time_total - time_now
        if self.writer is not None:
            # reference tags (utils_callbacks.py:80-82) + throughput
            self.writer.scalar("time_for_end", eta, global_step)
            self.writer.scalar("loss", loss.avg, global_step)
            self.writer.scalar("samples_per_sec", speed, global_step)
            self.writer.scalar("img_per_sec_per_chip",
                               speed / self.num_chips, global_step)
        self.logger.info(
            "Speed %.2f samples/sec (%.2f img/s/chip) Loss %.4f Epoch: %d "
            "Global Step: %d Required: %.1f hours %s"
            % (speed, speed / self.num_chips, loss.avg, epoch, global_step,
               eta, extra))
        loss.reset()
        self.tic = time.time()
