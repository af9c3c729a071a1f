"""The single-GPU training step.

Counterpart of `shard_body` in `msml_tpu/train/train_step.py:229-384` on one
device, so without collectives (JAX's pmeans over one device change
nothing). One step:
  1. the `device_light` input stage on the uint8 batch (:245-251): /255,
     Gaussian relight with draws from the state's generator, normalize,
     NHWC -> NCHW, in the CUDA `augment_batch` kernel;
  2. the forward under the config's precision policy (bf16 autocast for
     `fp16: true`), BatchNorm in train mode updating its running stats;
  3. the f32 log-softmax CE mean (:288-291) and the consensus loss of
     `final_seg` against `msk` (:301-303); total = cls + lambda1 seg
     + kd_loss_weight kd (:310-311);
  4. backward, the global-norm clip and the SGD step (:353-361).
Metrics are those of :381-383, as 0-d tensors on the device.
`make_eval_step` is the feature extraction of the verification callback.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from msml_torch import resolve_device
from msml_torch.kernels.augment import device_input_stage
from msml_torch.losses.ce import cross_entropy
from msml_torch.losses.consensus import structure_consensus_loss
from msml_torch.train import optim


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.SGD
    generator: torch.Generator  # the relight draws, on the model's device
    step: int = 0


def init_train_state(model: torch.nn.Module, cfg, device="cuda",
                     seed: int = 0) -> TrainState:
    """Move `model` (built with a head, `msml_from_config(..., head=True)`)
    to `device` in train mode, with its SGD optimizer (momentum 0.9,
    weight decay 5e-4 from the config) and a generator seeded with
    `seed`."""
    dev = resolve_device(device)
    model.to(dev).train()
    opt = torch.optim.SGD(optim.param_groups(model, cfg),
                          momentum=float(cfg.momentum),
                          weight_decay=float(cfg.weight_decay))
    return TrainState(model, opt,
                      torch.Generator(device=dev).manual_seed(seed))


def make_train_step(cfg) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> step(state, batch, lr_factor, light_draws=None) -> metrics.

    batch: 'img' (B, H, W, C) uint8, 'label' (B,), 'msk' (B, H, W) when
    use_osb; numpy arrays or tensors. lr_factor: `lr_step_factor(cfg,
    epoch)`. light_draws: (B, 3) relight uniforms to use instead of the
    generator's (the tests inject JAX's)."""
    if not cfg.get("device_light"):
        raise NotImplementedError("only device_light: true is ported")
    if cfg.peer_params.get("use_ori"):
        raise NotImplementedError("the peer teacher is not ported yet")
    use_osb = bool(cfg.use_osb)
    lambda1 = float(cfg.lambda1)
    kd_weight = float(cfg.get("kd_loss_weight", 0.0))
    gauss_light = bool(cfg.get("gauss_light", True))
    use_norm = bool(cfg.use_norm)
    clip_norm = float(cfg.grad_clip_norm)

    def step(state: TrainState, batch, lr_factor: float,
             light_draws: Optional[torch.Tensor] = None):
        model, opt = state.model, state.optimizer
        dev = state.generator.device
        img = torch.as_tensor(batch["img"], device=dev)
        label = torch.as_tensor(batch["label"], device=dev).long()
        if gauss_light and light_draws is None:
            light_draws = torch.rand((img.shape[0], 3),
                                     generator=state.generator, device=dev)
        x = device_input_stage(img, light_draws, gauss_light, use_norm)

        final_cls, final_seg, kd = model(x, label, train=True)
        cls_loss = cross_entropy(final_cls, label)
        if use_osb:
            msk = torch.as_tensor(batch["msk"], device=dev)
            seg_loss = structure_consensus_loss(final_seg, msk)
        else:
            seg_loss = torch.zeros((), device=dev)
        kd = torch.as_tensor(kd, dtype=torch.float32, device=dev)
        total = cls_loss + lambda1 * seg_loss + kd_weight * kd

        for group in opt.param_groups:  # the LambdaLR factor
            group["lr"] = group["base_lr"] * float(lr_factor)
        opt.zero_grad(set_to_none=True)
        total.backward()
        grad_norm = optim.clip_by_global_norm(
            [p for g in opt.param_groups for p in g["params"]], clip_norm)
        opt.step()
        state.step += 1
        return {"total_loss": total.detach(), "cls_loss": cls_loss.detach(),
                "seg_loss": seg_loss.detach(), "kd": kd,
                "nll": cls_loss.detach(), "grad_norm": grad_norm}

    return step


def make_eval_step(model: torch.nn.Module) -> Callable[[np.ndarray],
                                                        np.ndarray]:
    """-> extract(img): (B, H, W, C) normalized float32 numpy (NHWC, as
    `eval.verification.test` gives it) -> (B, dim_feature) float32 numpy
    features of the eval forward (`msml_tpu/train/train_step.py::
    make_eval_step`). The model runs in eval mode under no_grad and goes
    back to the mode it was in."""

    def extract(img: np.ndarray) -> np.ndarray:
        dev = next(model.parameters()).device
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                x = torch.as_tensor(img, device=dev).permute(0, 3, 1, 2)
                feature, _ = model(x.contiguous())
        finally:
            model.train(was_training)
        return feature.float().cpu().numpy()

    return extract


def make_quantized_eval_step(model: torch.nn.Module, input_hwc,
                             quant: str = "int8"
                             ) -> Callable[[np.ndarray], np.ndarray]:
    """`make_eval_step` over the int8 copy of `model` for (H, W, C) images
    (`core/quantize.py::quantize_eval_model`): the PTQ eval forward of
    `msml_tpu/train/train_step.py::make_quantized_eval_step`. Per-sample
    activation scales make padded rows and re-batching bit-inert; `model`
    itself is not changed. Modes other than int8 are refused with JAX's
    message."""
    from msml_torch.core.quantize import quantize_eval_model

    return make_eval_step(quantize_eval_model(model, input_hwc, quant))
