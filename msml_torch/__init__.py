"""PyTorch port of msml_tpu for NVIDIA Hopper (H100).

Each module keeps the name and path of its counterpart in `msml_tpu/`, which
stays the reference. The port imports torch and never jax or msml_tpu.
Entry points run on `cuda` unless the caller asks for the CPU.
Importing the package itself imports no torch, so that the training data
loader's worker processes (`data/face_dataset.py`) start without it.
"""

from __future__ import annotations


def resolve_device(device="cuda") -> "torch.device":
    """`device` as a torch.device; raises if CUDA is asked for but absent.

    Nothing in the port falls back to the CPU: a caller gets it only by
    asking for it."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
