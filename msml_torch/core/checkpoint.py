"""Checkpoints of the full train state.

Counterpart of `msml_tpu/core/checkpoint.py`, with `torch.save` in place of
orbax. A checkpoint is `<output>/ckpt/<step>.pt` and holds the model's state
dict (parameters and BatchNorm statistics), the optimizer's state (the
momentum buffers and the LR groups), the step and the relight generator's
state, so that a resumed run continues exactly. Each file is written to a
temporary name and then renamed, so a crash never leaves half a
checkpoint; the newest 3 are kept; saving a step that is
already saved is a no-op. Saves are synchronous (the JAX package's async
orbax saves are not ported yet).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")
MAX_TO_KEEP = 3


def _dir(output_dir: str) -> str:
    return os.path.join(output_dir, "ckpt")


def all_steps(output_dir: str) -> List[int]:
    path = _dir(output_dir)
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
                  if m)


def latest_step(output_dir: str) -> Optional[int]:
    steps = all_steps(output_dir)
    return steps[-1] if steps else None


def save_checkpoint(output_dir: str, state, step: int) -> bool:
    """Write `state` (a train_step.TrainState) as checkpoint `step`; False
    if that step is already saved."""
    if step in all_steps(output_dir):
        return False
    os.makedirs(_dir(output_dir), exist_ok=True)
    path = os.path.join(_dir(output_dir), f"{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step),
                "generator": state.generator.get_state()}, tmp)
    os.replace(tmp, path)
    for old in all_steps(output_dir)[:-MAX_TO_KEEP]:
        os.remove(os.path.join(_dir(output_dir), f"{old}.pt"))
    return True


def restore_checkpoint(output_dir: str, state, step: Optional[int] = None):
    """Load checkpoint `step` (default: the latest) into `state` in place
    and return it; None if there is no checkpoint."""
    if step is None:
        step = latest_step(output_dir)
    if step is None:
        return None
    saved = torch.load(os.path.join(_dir(output_dir), f"{step}.pt"),
                       map_location="cpu", weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.generator.set_state(saved["generator"])
    state.step = saved["step"]
    return state


class CheckpointWriter:
    """The train loop's checkpoint writer (the JAX package's long-lived
    orbax manager). `save` returns True if it wrote a checkpoint; `wait`
    and `close` have nothing to wait for, since saves are synchronous."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def save(self, state, step: int) -> bool:
        return save_checkpoint(self.output_dir, state, step)

    def wait(self):
        pass

    def close(self):
        pass
