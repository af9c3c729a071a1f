"""Checkpoints of the full train state.

Counterpart of `msml_tpu/core/checkpoint.py`, with `torch.save` in place of
orbax. A checkpoint is `<output>/ckpt/<step>.pt` and holds the model's state
dict (parameters and BatchNorm statistics), the optimizer's state (the
momentum buffers and the LR groups), the step and the relight generator's
state, so that a resumed run continues exactly. Each file is written to a
temporary name and then renamed, so a crash never leaves half a
checkpoint; the newest 3 are kept; saving a step that is already saved is
a no-op.

`CheckpointWriter` saves asynchronously by default, as the JAX package's
orbax manager does: `save` copies the state to host memory and waits for
that copy, then a background thread writes the copy. The copy is needed
because SGD updates the parameters in place: a write that read the live
tensors later would hold a later step.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import List, Optional

import torch

from msml_torch.core.logging import LOGGER

_NAME = re.compile(r"^(\d+)\.pt$")
MAX_TO_KEEP = 3


def _dir(output_dir: str) -> str:
    return os.path.join(output_dir, "ckpt")


def checkpoint_path(output_dir: str, step) -> str:
    return os.path.join(_dir(output_dir), f"{step}.pt")


def all_steps(output_dir: str) -> List[int]:
    path = _dir(output_dir)
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
                  if m)


def latest_step(output_dir: str) -> Optional[int]:
    steps = all_steps(output_dir)
    return steps[-1] if steps else None


def _payload(state) -> dict:
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "generator": state.generator.get_state()}


def _write(output_dir: str, payload: dict, step: int) -> None:
    os.makedirs(_dir(output_dir), exist_ok=True)
    path = checkpoint_path(output_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in all_steps(output_dir)[:-MAX_TO_KEEP]:
        os.remove(checkpoint_path(output_dir, old))


def restore_checkpoint(output_dir: str, state, step: Optional[int] = None):
    """Load checkpoint `step` (default: the latest) into `state` in place
    and return it; None if there is no checkpoint."""
    if step is None:
        step = latest_step(output_dir)
    if step is None:
        return None
    saved = torch.load(checkpoint_path(output_dir, step), map_location="cpu",
                       weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.generator.set_state(saved["generator"])
    state.step = saved["step"]
    return state


class CheckpointWriter:
    """The train loop's checkpoint writer (the JAX package's long-lived
    orbax manager, `msml_tpu/core/checkpoint.py:31-60`).

    With `async_save` (the default) `save` takes a host snapshot of the
    state, fences it, and hands it to a background thread that writes it;
    at most one write is in flight, so the next `save` first waits for the
    previous one, and reuses its host buffers (pinned for CUDA tensors).
    `wait` and `close` block until the write is done. An exception in the
    writer is raised again at the next `save`, `wait` or `close`. Without
    `async_save`, `save` writes before it returns.

    `save_seconds` is the loop thread's time in the last `save`; each
    background write logs its own time."""

    def __init__(self, output_dir: str, async_save: bool = True):
        self.output_dir = output_dir
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._buffers: dict = {}
        self.save_seconds = 0.0

    def save(self, state, step: int) -> bool:
        """Save `state` (a train_step.TrainState) as checkpoint `step`;
        True if it was written or started, False if that step is already
        saved."""
        t0 = time.perf_counter()
        try:
            self.wait()
            if step in all_steps(self.output_dir):
                return False
            if not self.async_save:
                _write(self.output_dir, _payload(state), step)
            else:
                snapshot = self._snapshot(_payload(state))
                self._thread = threading.Thread(
                    target=self._run, args=(snapshot, step),
                    name=f"checkpoint-{step}")
                self._thread.start()
            return True
        finally:
            self.save_seconds = time.perf_counter() - t0

    def _snapshot(self, payload: dict) -> dict:
        """A host copy of `payload`'s tensors in this writer's buffers,
        complete when this returns."""
        cuda = []

        def copy(obj, key):
            if isinstance(obj, torch.Tensor):
                buf = self._buffers.get(key)
                if (buf is None or buf.shape != obj.shape
                        or buf.dtype != obj.dtype):
                    buf = torch.empty(obj.shape, dtype=obj.dtype,
                                      pin_memory=obj.is_cuda)
                    self._buffers[key] = buf
                buf.copy_(obj.detach(), non_blocking=obj.is_cuda)
                if obj.is_cuda:
                    cuda.append(obj.device)
                return buf
            if isinstance(obj, dict):  # a state dict keeps its _metadata
                out = type(obj)((k, copy(v, key + (k,)))
                                for k, v in obj.items())
                if hasattr(obj, "_metadata"):
                    out._metadata = obj._metadata
                return out
            if isinstance(obj, (list, tuple)):
                return type(obj)(copy(v, key + (i,))
                                 for i, v in enumerate(obj))
            return obj

        out = copy(payload, ())
        for dev in set(cuda):
            torch.cuda.synchronize(dev)
        return out

    def _run(self, snapshot: dict, step: int):
        t0 = time.perf_counter()
        try:
            _write(self.output_dir, snapshot, step)
        except Exception as e:  # raised again on the loop's thread
            self._error = e
            return
        logging.getLogger(LOGGER).info(
            "checkpoint %d written in the background in %.3f s"
            % (step, time.perf_counter() - t0))

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        try:
            self.wait()
        finally:
            self._buffers = {}
