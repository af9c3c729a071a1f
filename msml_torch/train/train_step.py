"""The single-GPU training step.

Counterpart of `shard_body` in `msml_tpu/train/train_step.py:229-384` on one
device, so without collectives (JAX's pmeans over one device change
nothing). One step:
  1. the input (:244-252). With `device_light`, the input stage on the
     uint8 batch: /255, Gaussian relight with draws from the state's
     generator, normalize, NHWC -> NCHW, in the CUDA `augment_batch`
     kernel; with `use_ori` the clean images `ori` go through the same
     kernel without relight (the host never relights them). Without
     `device_light` (the host-float path), `img` and `ori` arrive as float
     NHWC, normalized on the host, and are only moved to NCHW;
  2. the forward under the config's precision policy (bf16 autocast for
     `fp16: true`), BatchNorm in train mode updating its running stats;
     with `use_ori` the frozen teacher runs on `ori` and the FMs give
     their KD terms, and a decoder with `decoder_loss_weight > 0` its
     weighted recover loss;
  3. the f32 log-softmax CE mean (:288-291) and the consensus loss of
     `final_seg` against `msk` (:301-303); total = cls + lambda1 seg
     + kd_loss_weight kd + rec (:273-311);
  4. backward, the global-norm clip and the SGD step (:353-361). A
     parameter that got no gradient (the decoder while its loss is off)
     gets a zero one, so that weight decay and momentum reach it as JAX's
     `sgd_update` does; the teacher is not in the optimizer.
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

    batch: 'img' (B, H, W, C) uint8 with `device_light`, else float32
    normalized on the host; 'label' (B,); 'msk' (B, H, W) when use_osb;
    'ori' like 'img' when `use_ori`; numpy arrays or tensors. lr_factor:
    `lr_step_factor(cfg, epoch)`. light_draws: (B, 3) relight uniforms to
    use instead of the generator's (the tests inject JAX's)."""
    device_light = bool(cfg.get("device_light"))
    use_ori = bool(cfg.peer_params.get("use_ori"))
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
        ori = torch.as_tensor(batch["ori"], device=dev) if use_ori else None
        if device_light:
            if gauss_light and light_draws is None:
                light_draws = torch.rand((img.shape[0], 3),
                                         generator=state.generator,
                                         device=dev)
            x = device_input_stage(img, light_draws, gauss_light, use_norm)
            if ori is not None:
                ori = device_input_stage(ori, None, False, use_norm)
        else:
            x = nchw_float(img)
            if ori is not None:
                ori = nchw_float(ori)

        losses: Dict[str, torch.Tensor] = {}
        final_cls, final_seg, kd = model(x, label, ori=ori, train=True,
                                         losses=losses)
        cls_loss = cross_entropy(final_cls, label)
        if use_osb:
            msk = torch.as_tensor(batch["msk"], device=dev)
            seg_loss = structure_consensus_loss(final_seg, msk)
        else:
            seg_loss = torch.zeros((), device=dev)
        kd = torch.as_tensor(kd, dtype=torch.float32, device=dev)
        rec_loss = sum(losses.values(), torch.zeros((), device=dev))
        total = cls_loss + lambda1 * seg_loss + kd_weight * kd + rec_loss

        for group in opt.param_groups:  # the LambdaLR factor
            group["lr"] = group["base_lr"] * float(lr_factor)
        opt.zero_grad(set_to_none=True)
        total.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = optim.clip_by_global_norm(params, clip_norm)
        opt.step()
        state.step += 1
        return {"total_loss": total.detach(), "cls_loss": cls_loss.detach(),
                "seg_loss": seg_loss.detach(), "kd": kd.detach(),
                "nll": cls_loss.detach(), "grad_norm": grad_norm}

    return step


def nchw_float(img: torch.Tensor) -> torch.Tensor:
    """A host-float batch (B, H, W, C) -> float32 (B, C, H, W) with NCHW
    strides, always a copy. For a gray batch (C = 1) the permuted view
    already counts as contiguous, but its strides are channels_last's
    too, and cuDNN would then run every conv after it channels_last."""
    return img.permute(0, 3, 1, 2).to(torch.float32).clone(
        memory_format=torch.contiguous_format)


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
                feature, _ = model(nchw_float(torch.as_tensor(
                    img, device=dev)))
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
