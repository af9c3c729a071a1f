"""Convert msml_tpu (flax) parameter trees into the port's state dict.

The port's own copy of the exporter `msml_tpu/tools/export_torch.py`, for
the modules the port has: the iResNet trunk, the FMCnn operators, the
U-Net and the classification head. The trees come in as nested dicts of
numpy arrays (e.g. from `jax.device_get`); no JAX is needed here. The
result carries the reference's torch names, so
`MSML.load_state_dict(..., strict=True)` takes it.

Layouts:
  conv   (kh, kw, I, O) -> (O, I, kh, kw)
  deconv (kh, kw, O, I) -> (I, O, kh, kw)
  frb.fc (H*W*C, out)   -> (out, C*H*W): the flax model flattens HWC, the
                           reference and the port flatten C-major
  BN     scale/bias/mean/var -> weight/bias/running_mean/running_var
                                (+ num_batches_tracked = 0)
  features BatchNorm1d  -> weight = ones (frozen at 1.0, iresnet.py:119-120)
  classification        -> weight (num_classes, dim) as it is, + bias for
                           Softmax (`msml_tpu/tools/export_torch.py:248-253`)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _get(tree, path: Path) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _has(tree, path: Path) -> bool:
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


class _Emitter:
    def __init__(self, params: Dict, batch_stats: Dict):
        self.p, self.s = params, batch_stats
        self.out: Dict[str, np.ndarray] = {}

    def conv(self, dst: str, path: Path, bias: bool = False):
        # HWIO -> OIHW; for a transposed conv (kh, kw, O, I) -> (I, O, kh, kw)
        self.out[dst + ".weight"] = np.transpose(
            _get(self.p, path + ("kernel",)), (3, 2, 0, 1))
        if bias:
            self.out[dst + ".bias"] = _get(self.p, path + ("bias",))

    def bn(self, dst: str, path: Path):
        self.out[dst + ".weight"] = _get(self.p, path + ("scale",))
        self.bn_stats(dst, path)

    def bn_stats(self, dst: str, path: Path):
        self.out[dst + ".bias"] = _get(self.p, path + ("bias",))
        self.out[dst + ".running_mean"] = _get(self.s, path + ("mean",))
        self.out[dst + ".running_var"] = _get(self.s, path + ("var",))
        self.out[dst + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def prelu(self, dst: str, path: Path):
        self.out[dst + ".weight"] = _get(self.p, path + ("alpha",))


def _stage(e: _Emitter, dst: str, path: Path):
    i = 0
    while _has(e.p, path + (f"block{i}",)):
        d, p = f"{dst}.{i}", path + (f"block{i}",)
        e.bn(d + ".bn1", p + ("bn1",))
        e.conv(d + ".conv1", p + ("conv1",))
        e.bn(d + ".bn2", p + ("bn2",))
        e.prelu(d + ".prelu", p + ("prelu",))
        e.conv(d + ".conv2", p + ("conv2",))
        e.bn(d + ".bn3", p + ("bn3",))
        if _has(e.p, p + ("downsample_conv",)):
            e.conv(d + ".downsample.0", p + ("downsample_conv",))
            e.bn(d + ".downsample.1", p + ("downsample_bn",))
        i += 1


def _stem_and_stages(e: _Emitter, dst: str, path: Path):
    e.conv(dst + ".conv1", path + ("conv1",))
    e.bn(dst + ".bn1", path + ("bn1",))
    e.prelu(dst + ".prelu", path + ("prelu",))
    for li in range(1, 5):
        _stage(e, f"{dst}.layer{li}", path + (f"layer{li}",))
    e.bn(dst + ".bn2", path + ("bn2",))


def _iresnet(e: _Emitter, dst: str, path: Path):
    _stem_and_stages(e, dst, path)
    fc = _get(e.p, path + ("fc", "kernel"))
    out = fc.shape[1]
    c = fc.shape[0] // 49  # 7 x 7 final map at 112 input
    e.out[dst + ".fc.weight"] = np.transpose(
        fc.reshape(7, 7, c, out), (3, 2, 0, 1)).reshape(out, c * 49)
    e.out[dst + ".fc.bias"] = _get(e.p, path + ("fc", "bias"))
    bias = _get(e.p, path + ("features", "bias"))
    e.out[dst + ".features.weight"] = np.ones_like(bias)
    e.bn_stats(dst + ".features", path + ("features",))


def _fm(e: _Emitter, dst: str, path: Path):
    if not _has(e.p, path + ("same_conv",)):
        return  # FMNone: no parameters either side
    if _has(e.p, path + ("conv_m",)) or _has(e.p, path + ("conv1",)):
        raise NotImplementedError("the peer-guided FM path is not ported yet")
    e.conv(dst + ".same_conv", path + ("same_conv",))
    i = 0
    while _has(e.p, path + (f"res{i}",)):
        d, p = f"{dst}.res_block.{i}", path + (f"res{i}",)
        for ci in (1, 2, 3):
            e.conv(f"{d}.conv{ci}", p + (f"conv{ci}",))
            e.bn(f"{d}.bn{ci}", p + (f"bn{ci}",))
            e.prelu(f"{d}.prelu{ci}", p + (f"prelu{ci}",))
        i += 1


def _unet(e: _Emitter, dst: str, path: Path):
    _stem_and_stages(e, dst, path)
    for gi in range(1, 6):
        for leg in ("l1", "l2", "r1", "r2"):
            e.conv(f"{dst}.gcm{gi}.conv_{leg}",
                   path + (f"gcm{gi}", f"conv_{leg}"), bias=True)
    for di in range(1, 6):
        e.conv(f"{dst}.deconv{di}", path + (f"deconv{di}",))


def state_dict_from_jax(params: Dict, batch_stats: Dict
                        ) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) flax trees -> the port's MSML state dict."""
    if not _has(params, ("frb", "conv1", "kernel")):
        raise NotImplementedError("only the iResNet FRB is ported so far")
    if _has(params, ("frb", "decoder")) or _has(params, ("peer",)):
        raise NotImplementedError(
            "the recover decoder and the peer teacher are not ported yet")
    e = _Emitter(params, batch_stats)
    _iresnet(e, "frb", ("frb",))
    for i in range(4):
        _fm(e, f"frb.fm_ops.{i}", (f"fm_op{i}",))
    if _has(params, ("osb",)):
        _unet(e, "osb", ("osb",))
    for name in ("weight", "bias"):
        if _has(params, ("classification", name)):
            e.out[f"classification.{name}"] = _get(
                params, ("classification", name))
    return {k: torch.from_numpy(np.ascontiguousarray(
        v if v.dtype == np.int64 else v.astype(np.float32)))
        for k, v in e.out.items()}
