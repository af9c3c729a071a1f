"""Mixed-precision policy: bf16 compute / f32 params.

Counterpart of `msml_tpu/core/precision.py`. Compute runs under
`torch.autocast(dtype=bfloat16)`; parameters, BatchNorm statistics, the final
`fc`/`features` layers, the DAP segmentation logits and all metric math stay
float32 (the reference's `.float()` casts at `iresnet.py:232`, `msml.py:169`).
`FULL_PRECISION` computes in float32 everywhere (the tests use it).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.bfloat16

    def autocast(self, device_type: str):
        """Context that runs the enclosed ops in `compute_dtype`."""
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=self.compute_dtype)

    def cast_to_output(self, x: torch.Tensor) -> torch.Tensor:
        """Outputs leave the model in float32 under every policy."""
        return x.to(torch.float32)


DEFAULT_POLICY = Policy()
FULL_PRECISION = Policy(compute_dtype=torch.float32)


def policy_from_config(fp16: bool) -> Policy:
    """Reference `fp16: true` (config.yaml:5) -> bf16 compute."""
    return DEFAULT_POLICY if fp16 else FULL_PRECISION


def f32_region(device_type: str):
    """Leave autocast: the enclosed ops run in the dtype of their inputs."""
    return torch.autocast(device_type, enabled=False)


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in float32 inside: cuDNN's and
    cuBLAS's TF32 off (cuDNN's is on by default), restored on exit. The
    JAX package's FULL_PRECISION computes in float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
