"""Post-training int8 quantization (PTQ) of an eval forward.

Counterpart of `msml_tpu/core/quantize.py`, in PyTorch idiom: a module
rewrite where JAX re-interprets a jaxpr. `quantize_model(model, example)`
runs `model` once on `example` with a hook on every `nn.Conv2d` (the
routed `Conv3x3` sites included), `nn.ConvTranspose2d` and `nn.Linear`,
to see each op as JAX's tracer sees its equation: the dtype it computes in
(the autocast dtype inside the policy's autocast, else its inputs'), its
contraction and its input's rank. It then returns a copy of `model` in
which each eligible op is a `QuantConv`: int8 weights packed for the
kernel and float32 per-channel scales as buffers, the float weight
dropped. The rules are JAX's:

- weights: symmetric int8 per output channel (`_quant_weight`, :85-108),
  quantized from the weight cast to the op's dtype and back to float32
  (under the bf16 policy JAX's quantizer sees the bf16 weight, because
  flax casts it before the conv; that cast makes the weight a traced
  value, whose scale XLA computes with a reciprocal: `quant_weight`); a
  transposed conv's output channels are axis 1 of torch's (in, out, kh,
  kw) weight;
- activations: symmetric int8 with one dynamic scale per sample, from the
  amax over all non-batch axes (`_quant_act`, :111-127);
- a conv is kept in its dtype when kh * kw * C_in < `min_contract`
  (default 64), when its output is not floating, and (port only: none of
  the zoo's graphs has one) when it is grouped or dilated, pads other
  than with zeros or gives its padding as a string; a linear is quantized when `quantize_linear` and its
  input is rank 2 with at least `min_contract` features, floating
  (:130-177);
- dequantization in JAX's order, `y_f32 * (sx[n] * sw[co])` cast to the
  op's dtype; the bias is added as XLA adds flax's bias there: in one FMA
  with the dequantizing multiply in float32, after the rounding in
  bfloat16 (`kernels/qconv.py`).

The convolutions and the fc then run the kernels of `kernels/qconv.py`
(`quant_act`, `qconv_int8`): CUDA C++ on the card, the plain versions on
the CPU. `stats_out` receives JAX's four counts, so that a test can hold
the decisions against `quantize_fn`'s; with `quantize_linear=False`
linear ops are not counted, as JAX does not count dots then.

The entry points (`cli.test`, `cli.serve`, `tools.export_serving`) and
`train_step.make_quantized_eval_step` take their int8 copy from
`quantize_eval_model`, whose example is one zero image of the config's
input.

Usage:
    qmodel = quantize_eval_model(model, (112, 112, 3))
    feature, _ = qmodel(x)
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch import nn

from msml_torch.kernels import qconv

_OPS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
_STATS = ("conv_quantized", "conv_kept", "dot_quantized", "dot_kept")


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class QuantConv(nn.Module):
    """An int8 `nn.Conv2d`, `nn.ConvTranspose2d` or `nn.Linear` (as a 1 x 1
    conv on (N, C, 1, 1)): `quant_act` then `qconv_int8`, then the bias.

    Buffers: `wp` int8 (`kernels.qconv.pack_weight`), `sw` float32 (Co,),
    `bias` float32 (Co,) of the bias rounded to the op's dtype, or None."""

    def __init__(self, module: nn.Module, dtype: torch.dtype):
        super().__init__()
        w = module.weight.detach()
        self.kind = ("linear" if isinstance(module, nn.Linear) else
                     "transposed" if isinstance(module, nn.ConvTranspose2d)
                     else "conv")
        self.dtype = dtype
        wf = w.to(dtype).float()
        if self.kind == "linear":
            wf = wf[:, :, None, None]
        wq, sw = qconv.quant_weight(wf, 1 if self.kind == "transposed"
                                    else 0, reciprocal=dtype != w.dtype)
        if self.kind == "transposed":
            wq = qconv.transposed_as_conv(wq)
        co, ci, kh, kw = wq.shape
        self.cp = qconv.padded_channels(ci)
        self.kernel = (kh, kw)
        # the conv that qconv_int8 runs: a transposed conv is one over its
        # input dilated by its stride, padded by kernel - 1 - padding
        self.stride, self.pad, self.dil, self.out_pad = ((1, 1), (0, 0),
                                                         (1, 1), (0, 0))
        if self.kind == "conv":
            self.stride = _pair(module.stride)
            self.pad = _pair(module.padding)
        elif self.kind == "transposed":
            p = _pair(module.padding)
            self.dil = _pair(module.stride)
            self.pad = (kh - 1 - p[0], kw - 1 - p[1])
            self.out_pad = _pair(module.output_padding)
        dev = w.device
        self.register_buffer("wp", qconv.pack_weight(wq, self.cp).to(dev))
        self.register_buffer("sw", sw.to(dev))
        bias = module.bias
        self.register_buffer("bias", None if bias is None
                             else bias.detach().to(dtype).float())

    def extra_repr(self) -> str:
        return (f"{self.kind}, {self.sw.shape[0]} out, kernel {self.kernel}"
                f", cp {self.cp}, {self.dtype}")

    def geometry(self, h: int, w: int) -> list:
        """`qconv_int8`'s geometry for an (h, w) input (a transposed conv's
        output_padding pads the bottom and right)."""
        (kh, kw), (sh, sw), (ph, pw), (dh, dw), (oh, ow) = (
            self.kernel, self.stride, self.pad, self.dil, self.out_pad)
        ho = qconv.conv_out_size(h, kh, sh, ph, ph + oh, dh)
        wo = qconv.conv_out_size(w, kw, sw, pw, pw + ow, dw)
        return [kh, kw, sh, sw, ph, pw, dh, dw, ho, wo]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)  # what autocast or the op's dtype would do
        xq, sx = qconv.quant_act(x, self.cp)
        h, w = (1, 1) if x.dim() == 2 else x.shape[2:]
        y = qconv.qconv_int8(xq, self.wp, sx, self.sw, self.bias,
                             self.geometry(h, w), self.dtype)
        return y.flatten(1) if self.kind == "linear" else y


def _contraction(m: nn.Module) -> int:
    """kh * kw * C_in of a conv (the layer's input channels for a
    transposed one), in_features of a linear."""
    if isinstance(m, nn.Linear):
        return m.in_features
    if isinstance(m, nn.ConvTranspose2d):
        return m.weight.shape[0] * m.weight[0, 0].numel()
    return m.weight[0].numel()


def _eligible(m: nn.Module, x: torch.Tensor, dtype: torch.dtype,
              min_contract: int) -> bool:
    if not dtype.is_floating_point or _contraction(m) < min_contract:
        return False
    if isinstance(m, nn.Linear):
        return x.dim() == 2
    return (m.groups == 1 and _pair(m.dilation) == (1, 1)
            and m.padding_mode == "zeros" and x.dim() == 4
            and not isinstance(m.padding, str))


def _op_dtype(m: nn.Module, x: torch.Tensor) -> torch.dtype:
    dev = x.device.type
    if x.is_floating_point() and torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return torch.promote_types(x.dtype, m.weight.dtype)


def quantize_model(model: nn.Module, example, *, min_contract: int = 64,
                   quantize_linear: bool = True,
                   stats_out: Optional[dict] = None) -> nn.Module:
    """A copy of `model` with its eligible convolutions and linears in int8.

    `example` (a tensor or a tuple of positional arguments, a batch of one
    is enough) runs through `model` once under no_grad to find each op's
    dtype and input; ops it does not reach stay as they are. The copy is
    in `model`'s train / eval mode and on its device; `model` is not
    changed."""
    args = example if isinstance(example, (tuple, list)) else (example,)
    seen: dict = {}  # module -> (dtype, eligible)
    stats = dict.fromkeys(_STATS, 0)

    def hook(m, inputs):
        x = inputs[0]
        is_dot = isinstance(m, nn.Linear)
        if is_dot and not quantize_linear:
            return
        dtype = _op_dtype(m, x)
        ok = _eligible(m, x, dtype, min_contract)
        if seen.setdefault(m, (dtype, ok)) != (dtype, ok):
            raise ValueError(f"{m} runs in two ways: {seen[m]} and "
                             f"{(dtype, ok)}")
        key = ("dot_" if is_dot else "conv_") + ("quantized" if ok
                                                 else "kept")
        stats[key] += 1

    handles = [m.register_forward_pre_hook(hook)
               for m in model.modules() if isinstance(m, _OPS)]
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for h in handles:
            h.remove()
    memo = {id(m): QuantConv(m, dtype)
            for m, (dtype, ok) in seen.items() if ok}
    qmodel = copy.deepcopy(model, memo)
    if stats_out is not None:
        stats_out.clear()
        stats_out.update(stats)
    return qmodel


def quantize_eval_model(model: nn.Module, input_hwc: Sequence[int],
                        quant: str = "int8") -> nn.Module:
    """The int8 copy of an eval forward `model` (NCHW images in, as
    `msml_from_config` builds it): `quantize_model` on one zero image of
    `input_hwc` (height, width, channels) on the model's device, traced in
    eval mode. Modes other than int8 are refused with JAX's message."""
    if quant != "int8":
        raise ValueError(f"unknown quant mode {quant!r}")
    h, w, c = input_hwc
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        return quantize_model(model, torch.zeros((1, c, h, w), device=dev))
    finally:
        model.train(was_training)


def quant_sites(model: nn.Module) -> Sequence[str]:
    """Names of the `QuantConv` modules of a quantized model."""
    return [name for name, m in model.named_modules()
            if isinstance(m, QuantConv)]
